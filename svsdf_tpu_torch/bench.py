"""The port's problem sets: the main path's (own copy of
bench.py::_problem), the end-to-end cell's map (own copy of the set-up
of bench.py::bench_e2e), the grid query's trajectory and axes (own
copy of the set-up of bench.py::bench_grid_queries), and mesh robots to
drive (``write_prism_obj``: the reference's robot .obj files are not in
the repository).

``problem`` builds B independent back-end problems from numpy seeds,
exactly as the repo's ``bench.py`` does: goals in [6, 10] x [-2, 2],
waypoints on the head-tail segment plus N(0, 0.2) noise, M obstacle
points uniform in [-1, 11] x [-5, 5], pieces of 1.5 s. It returns numpy
arrays (float32), which ``convert.problem_from_numpy`` turns into the
port's tensors and which the JAX package takes as they are.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from svsdf_tpu_torch.utils.transforms import backward_t

#: L-BFGS memory of the batched solves (bench.py's _BENCH_MEM_SIZE)
BENCH_MEM_SIZE = 8


def problem(n_pieces: int, n_obs: int, batch: int, seed: int = 0):
    """(head (B,3,3), tail (B,3,3), obstacles (B,M,2), x0 (B,4N-3)),
    all float32 numpy."""
    rng = np.random.default_rng(seed)
    head = np.zeros((batch, 3, 3), np.float32)
    tail = np.zeros((batch, 3, 3), np.float32)
    goals = rng.uniform([6, -2], [10, 2], size=(batch, 2))
    tail[:, 0, :2] = goals
    tail[:, 0, 2] = rng.uniform(-1, 1, batch)
    frac = np.linspace(0, 1, n_pieces + 1)[1:-1]
    wps = (head[:, 0][:, None, :] * (1 - frac)[None, :, None]
           + tail[:, 0][:, None, :] * frac[None, :, None])
    wps = wps + rng.normal(0, 0.2, wps.shape)
    obs = rng.uniform([-1, -5], [11, 5], size=(batch, n_obs, 2))
    tau = np.tile(backward_t(torch.full((n_pieces,), 1.5,
                                        dtype=torch.float32)).numpy(),
                  (batch, 1))
    x0 = np.concatenate([tau, wps.reshape(batch, -1)], axis=1)
    return (head, tail, obs.astype(np.float32), x0.astype(np.float32))


class E2ESetup(NamedTuple):
    shape: object              # the robot, sdHeart
    grid: object               # GridMap of the forest at 1 m
    feas: torch.Tensor         # (8, X, Y) bool yaw-bin feasibility, device
    occ_pts: torch.Tensor      # (M, 2) float32 occupied-cell centres, device
    cells: np.ndarray          # (C, 2) int64 start / goal candidates


def e2e_setup(device=None) -> E2ESetup:
    """The end-to-end cell's map and robot (own copy of bench.py's
    bench_e2e set-up): map_forest(res=0.5, seed=3, n_trees=14) voxelized
    at 1 m, sdHeart, 8 yaw bins of 15x15 stencils at a 0.5 m margin, the
    occupied-cell centres, and the cells of the free component connected
    to the middle free cell, from which start and goal cells are drawn."""
    from svsdf_tpu_torch import resolve_device
    from svsdf_tpu_torch.models import shapes
    from svsdf_tpu_torch.ops import kernels as kops
    from svsdf_tpu_torch.planner import wavefront
    from svsdf_tpu_torch.utils import mapgen
    from svsdf_tpu_torch.utils.gridmap import GridMap

    dev = resolve_device(device)
    grid = GridMap.from_points(mapgen.map_forest(res=0.5, seed=3,
                                                 n_trees=14), 1.0, 1)
    shape = shapes.make_shape("sdHeart")
    kernels = kops.rasterize_shape_kernels(shape, 15, 8, 1.0, 0.5,
                                           device=dev)
    feas = kops.feasibility_maps(grid.occ2d.copy(), kernels, device=dev)
    free = torch.any(feas, dim=0)
    fi0, fj0 = np.nonzero(free.cpu().numpy())
    seed_cell = [[fi0[len(fi0) // 2], fj0[len(fj0) // 2]]]
    dist = wavefront.distance_field(free, seed_cell, device=dev)[0]
    fi, fj = np.nonzero((free & (dist < 1e8)).cpu().numpy())
    return E2ESetup(shape, grid, feas,
                    torch.as_tensor(grid.occupied_centers_2d(), device=dev),
                    np.stack([fi, fj], -1).astype(np.int64))


def e2e_draws(cells, batch: int, rng: np.random.Generator):
    """(starts, goals) (B, 2) int64 cells drawn uniformly from ``cells``
    with ``rng`` (bench.py's pick(): starts first, then goals)."""
    pick = lambda: cells[rng.integers(0, len(cells), batch)]
    starts = pick()
    return starts, pick()


class GridSetup(NamedTuple):
    shape: object              # the robot, sdHeart
    traj: object               # one 6-piece MINCO Trajectory (B = 1)
    xs: torch.Tensor           # (grid,) query x coordinates
    ys: torch.Tensor           # (grid,) query y coordinates


def grid_setup(grid: int = 256, device=None,
               dtype=torch.float32) -> GridSetup:
    """The grid query's problem (own copy of bench.py::bench_grid_queries'
    set-up): sdHeart along the 6-piece MINCO trajectory of 1.5 s pieces
    from (0, 0, 0) to (10, 0, 1) through (10 f, sin 5f, f) at the inner
    fractions f, queried on linspace(-4, 14, grid) x linspace(-8, 8,
    grid). Inputs are rounded to float32 first, as the JAX bench builds
    them."""
    from svsdf_tpu_torch import resolve_device
    from svsdf_tpu_torch.models import shapes
    from svsdf_tpu_torch.ops import minco

    dev = resolve_device(device)
    n = 6
    head = np.zeros((1, 3, 3), np.float32)
    tail = np.zeros((1, 3, 3), np.float32)
    tail[0, 0] = (10.0, 0.0, 1.0)
    frac = np.linspace(0, 1, n + 1)[1:-1]
    wps = np.stack([10 * frac, np.sin(5 * frac), frac], -1)[None]
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), dtype=dtype,
                                  device=dev)
    traj = minco.solve(t(np.full((1, n), 1.5)), t(head), t(tail), t(wps))
    return GridSetup(shapes.make_shape("sdHeart"), traj,
                     t(np.linspace(-4, 14, grid)), t(np.linspace(-8, 8, grid)))


#: the prism's contour grid step and half-height (m)
PRISM_STEP = 0.05
PRISM_HALF_HEIGHT = 0.5


def write_prism_obj(name: str, path: str, extent: float = 6.0) -> str:
    """Write a closed prism .obj of the analytic body ``name`` to ``path``:
    the body's zero contour by marching squares (viz/swept_surface.py) on
    a PRISM_STEP grid over [-extent, extent]^2, extruded over z in
    [-PRISM_HALF_HEIGHT, PRISM_HALF_HEIGHT]. Each contour segment gives a side quad (two
    outward triangles) and one triangle of each cap, fanned from the
    contour's centroid (the bodies driven, sdHeart and Circle, are
    star-shaped about it). A mesh robot for benches and checks: a .obj the
    mesh-SDF path reads like the reference's robots."""
    from svsdf_tpu_torch.models import shapes
    from svsdf_tpu_torch.viz.swept_surface import marching_squares

    ax = np.arange(-extent, extent + PRISM_STEP, PRISM_STEP)
    gx, gy = np.meshgrid(ax, ax, indexing="ij")
    sdf = shapes.make_shape(name).sdf_xy(torch.as_tensor(gx),
                                         torch.as_tensor(gy)).numpy()
    # the Python loop on the float64 field: the native route rounds the
    # field to float32, and the prism's vertices are the mesh robots'
    segs = np.asarray(marching_squares(ax, ax, sdf, use_native=False))
    c = segs.reshape(-1, 2).mean(axis=0)
    a, b = segs[:, 0] - c, segs[:, 1] - c
    ccw = a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0] > 0.0
    segs = np.where(ccw[:, None, None], segs, segs[:, ::-1])
    h = PRISM_HALF_HEIGHT
    vertex = lambda x, y, z: f"v {float(x)!r} {float(y)!r} {z!r}\n"
    with open(path, "w") as f:
        f.write(vertex(*c, -h) + vertex(*c, h))
        for (ax_, ay_), (bx_, by_) in segs:
            f.write(vertex(ax_, ay_, -h) + vertex(bx_, by_, -h)
                    + vertex(bx_, by_, h) + vertex(ax_, ay_, h))
        for i in range(len(segs)):
            a0, b0, b1, a1 = (3 + 4 * i + j for j in range(4))
            f.write(f"f {a0} {b0} {b1}\nf {a0} {b1} {a1}\n"   # side
                    f"f 2 {a1} {b1}\nf 1 {b0} {a0}\n")         # caps
    return path
