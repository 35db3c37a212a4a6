"""The port's benchmark entry point and its problem sets.

    python -m svsdf_tpu_torch.bench          # on the card; one JSON line

The counterpart of the repo's ``bench.py`` (which measures the JAX
package) for the PyTorch/CUDA port. Six sections, five the counterparts
of ``bench.py``'s:

  plans          ``bench_plans``: ``plan_batch_staged`` at
                 ``default_stages(40)`` (bfloat16 scans), sdHeart, 8
                 pieces, 64 obstacles, the batch ladder 512 -> 256 -> 128
                 -> 32 (the next rung on an out-of-memory error); one
                 warm-up, then 3 timed runs on inputs perturbed by
                 U(+-1e-3), each closed by a host readback. plans/s, the
                 solver's median cost, the median cost re-scored on one
                 full-fidelity functional (``HIFI``,
                 scripts/perf_sweep.py::hifi_cost's config) and the median
                 certificate, the kernel's launches;
  grid           ``bench_grid_queries``: ``svsdf_grid`` of sdHeart on 256 x
                 256 points at K=256 with 3 refinement rounds, 8 batches a
                 run;
  e2e            ``bench_e2e``: ``plan_batch_e2e`` on the forest map at
                 B=512 (256 on an out-of-memory error), with the front
                 end's share;
  replan         ``bench_replan_latency``: batch-1 staged solves at
                 ``default_stages_lowlat(50)``, 15 timed;
  replan_map     ``bench_replan_map``: ``OnlineReplanner`` on the
                 reference's sdHeart map, which is not in the repository;
                 it then raises and the section reports no metric, only
                 its error;
  plans_profile  ``bench_plans_profile``: one more plans solve under
                 torch.profiler, the device's busy share; last, because a
                 profiler session slows every later launch of its process.

The sections run in one child process, each within its own budget
(``_BUDGETS``; all within ``$BENCH_BUDGET_S``, default 1080 s): a section
that raises reports its error in its own entry, one that overruns its
budget is killed with its child, which restarts with the sections left.
The headline prints as soon as ``plans`` lands (``"partial": true``) and
again at the end; the exit code is not 0 when ``plans`` failed. Without
a card the entry point raises; ``--device cpu`` runs the sections on the
host, for the tests, and its numbers are then no device's.

The problem sets: ``problem`` builds B independent back-end problems
from numpy seeds, exactly as the repo's ``bench.py`` does: goals in
[6, 10] x [-2, 2], waypoints on the head-tail segment plus N(0, 0.2)
noise, M obstacle points uniform in [-1, 11] x [-5, 5], pieces of 1.5 s.
It returns numpy arrays (float32), which ``convert.problem_from_numpy``
turns into the port's tensors and which the JAX package takes as they
are. ``e2e_setup`` and ``e2e_draws`` build the end-to-end cell's map and
draws, ``grid_setup`` the grid query's trajectory and axes, and
``write_prism_obj`` mesh robots to drive (the reference's robot .obj
files are not in the repository).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import queue
import signal
import statistics
import subprocess
import sys
import threading
import time
import traceback
from typing import NamedTuple

import numpy as np
import torch

from svsdf_tpu_torch.ops.svsdf import SVSDFConfig
from svsdf_tpu_torch.utils.profiling import is_device_activity
from svsdf_tpu_torch.utils.transforms import backward_t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

#: the coarse-scan kernel's name in a profiler trace
KERNEL_NAME = "coarse_scan_kernel"

#: the full-fidelity functional plans are re-scored on, so that costs of
#: runs at other settings compare (scripts/perf_sweep.py::hifi_cost's
#: config); a plan's certificate is the least SVSDF of its obstacle points
#: on the same functional
HIFI = SVSDFConfig(coarse_n=256, refine_rounds=3, gsip_iters=8,
                   gsip_coarse_n=96, gsip_refine_rounds=1)


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_events(prof):
    """(name, device microseconds) of every device activity a finished
    torch.profiler session recorded, read from its raw trace: building
    the profiler's own event tree (prof.events(), key_averages()) for the
    ~200 k launches of one solve takes the host tens of seconds, and
    minutes for a Planner.plan, for the same sums. A caller's
    ``record_function`` range, which the profiler also draws on the
    device's timeline, is not device work and is left out."""
    return [(e.name(), (e.end_ns() - e.start_ns()) / 1e3)
            for e in prof.profiler.kineto_results.events()
            if is_device_activity(e)]


def profile_solve(run):
    """One call of ``run`` under torch.profiler: wall seconds, summed
    device kernel time and its share of the wall, kernel launches, and
    the coarse-scan kernel's and the five largest kernels' device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    kernels = device_events(prof)
    busy_us = sum(us for _, us in kernels)
    by_name = {}
    for name, us in kernels:
        n, total = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, total + us)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
    scan = [v for k, v in by_name.items() if KERNEL_NAME in k]
    return {"wall_s": wall, "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall,
            "kernel_launches": len(kernels),
            "scan_launches": sum(v[0] for v in scan),
            "scan_device_s": sum(v[1] for v in scan) / 1e6,
            "top": [{"name": k[:60], "launches": v[0], "device_s": v[1] / 1e6}
                    for k, v in top]}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _median(t: torch.Tensor) -> float:
    """The median of a tensor's values, the two middle ones averaged (as
    numpy and jnp.median take it)."""
    return float(np.median(t.detach().double().cpu().numpy()))


def rescore(shape, prob, cfg, n: int, out):
    """(cost (B,), cert_min (B,)) of a staged solve's result ``out`` on
    the ``HIFI`` functional: the back end's full cost at its final x, and
    the least SVSDF of each plan's obstacle points along its final
    trajectory (positive = collision-free)."""
    from svsdf_tpu_torch.ops.svsdf import svsdf_query
    from svsdf_tpu_torch.planner import back_end
    cost = back_end.make_cost_fn(shape, prob, cfg, HIFI, n)(out.opt_x)
    cert = svsdf_query(shape, out.traj, prob.obstacles, HIFI).sdf
    return cost.detach(), cert.detach().amin(dim=-1)


def _check_launched(dev, cs, scan_dtype, what: str) -> dict:
    """The coarse-scan launches by form since the last reset; on the card
    the path must have launched the kernel's form of its scan type (a
    wrapper given a CUDA tensor launches or raises, never the plain scan)."""
    launches = dict(cs.coarse_scan.form_launches)
    want = cs.form(scan_dtype == "bfloat16", False)
    if dev.type == "cuda" and launches[want] <= 0:
        raise RuntimeError(f"{what} launched no coarse-scan kernel of the "
                           f"{want} form: {launches}")
    return launches


# ---------------------------------------------------------------------------
# sections (counterparts of bench.py's)
# ---------------------------------------------------------------------------

#: the plans section: pieces, obstacles, L-BFGS iterations, and its batch
#: ladder (the next rung on an out-of-memory error)
PLANS_PIECES, PLANS_OBS, PLANS_ITERS = 8, 64, 40
PLANS_BATCHES = (512, 256, 128, 32)


def _on_the_ladder(what: str, batches, measure):
    """``measure(batch)`` at the first of ``batches`` that does not run out
    of device memory."""
    for batch in batches:
        try:
            return measure(batch)
        except torch.cuda.OutOfMemoryError as e:
            print(f"# {what}: batch={batch} ran out of device memory "
                  f"({str(e)[:120]}); next rung", file=sys.stderr)
        torch.cuda.empty_cache()
    raise RuntimeError(f"{what}: every batch of {tuple(batches)} ran out of "
                       "device memory")


class _MainPath(NamedTuple):
    run: object                # x (B, 4N-3) -> StagedResult, read back
    x0: torch.Tensor           # (B, 4N-3) problem's warm start, device
    prob: object               # BackEndProblem, device
    shape: object              # the robot, sdHeart
    cfg: object                # PlannerConfig(mem_size=BENCH_MEM_SIZE)


def _main_path(n_pieces, n_obs, iters, scan_dtype, batch, dev,
               dtype) -> _MainPath:
    """The main path on ``problem(n_pieces, n_obs, batch)``:
    ``plan_batch_staged`` at ``default_stages(iters, scan_dtype=...)``,
    ``PlannerConfig(mem_size=BENCH_MEM_SIZE)``, sdHeart; each solve closed
    by a host readback."""
    from svsdf_tpu_torch import convert
    from svsdf_tpu_torch.models import shapes
    from svsdf_tpu_torch.parallel import batch as pb
    from svsdf_tpu_torch.utils.config import PlannerConfig

    cfg = PlannerConfig(mem_size=BENCH_MEM_SIZE)
    stages = pb.default_stages(iters, scan_dtype=scan_dtype)
    shape = shapes.make_shape("sdHeart")
    prob, x0 = convert.problem_from_numpy(*problem(n_pieces, n_obs, batch),
                                          device=dev, dtype=dtype)

    def run(x):
        out = pb.plan_batch_staged(shape, x, prob, cfg, stages, n_pieces,
                                   device=dev)
        float(out.cost.sum())
        return out
    return _MainPath(run, x0, prob, shape, cfg)


def bench_plans(n_pieces: int = PLANS_PIECES, n_obs: int = PLANS_OBS,
                iters: int = PLANS_ITERS, scan_dtype: str | None = "bfloat16", batches=PLANS_BATCHES,
                device=None, dtype=torch.float32) -> dict:
    """Batched planning throughput (bench.py::bench_plans): ``plans_run``'s
    readings."""
    return plans_run(n_pieces, n_obs, iters, scan_dtype, batches, device,
                     dtype)[0]


def plans_run(n_pieces: int = PLANS_PIECES, n_obs: int = PLANS_OBS,
              iters: int = PLANS_ITERS, scan_dtype: str | None = "bfloat16", batches=PLANS_BATCHES,
              device=None, dtype=torch.float32):
    """(readings, the last timed run's ``StagedResult``) of ``_main_path``
    at the first rung of ``batches`` that does not run out of device
    memory: one warm-up, then 3 runs on x0 perturbed by U(+-1e-3) (numpy
    seed 1), each closed by a host readback.

    Reports plans/s at the median wall, the median over the runs of each
    run's (lower) median cost (``median_final_cost``), the last run's plans
    re-scored on ``HIFI`` (``median_cost``, ``median_cert_min``) and the
    kernel's launches by form over the warm-up and the timed runs. The
    device's busy share is ``bench_plans_profile``'s."""
    from svsdf_tpu_torch import resolve_device
    from svsdf_tpu_torch.ops import cuda_svsdf as cs

    dev = resolve_device(device)

    def measure(batch):
        mp = _main_path(n_pieces, n_obs, iters, scan_dtype, batch, dev, dtype)
        cs.reset_launches()
        out = mp.run(mp.x0)                      # warm-up
        rng = np.random.default_rng(1)
        walls, costs, n_iters = [], [], []
        for _ in range(3):
            x = mp.x0 + torch.as_tensor(rng.uniform(
                -1e-3, 1e-3, tuple(mp.x0.shape)).astype(np.float32),
                device=dev)
            t0 = time.perf_counter()
            out = mp.run(x)
            walls.append(time.perf_counter() - t0)
            costs.append(float(out.cost.median()))
            n_iters.append(float(out.n_iters.float().mean()))
        launches = _check_launched(dev, cs, scan_dtype, "the main path")
        if not (torch.isfinite(out.cost).all()
                and torch.isfinite(out.opt_x).all()
                and out.opt_x.shape == (batch, 4 * n_pieces - 3)
                and out.traj.coeffs.shape == (batch, n_pieces, 6, 3)):
            raise RuntimeError("the main path's output is not finite or "
                               "has the wrong shape")
        cost, cert = rescore(mp.shape, mp.prob, mp.cfg, n_pieces, out)
        wall = statistics.median(walls)
        return {"plans_per_s": batch / wall, "plan_batch_wall_s": wall,
                "plan_batch_size": batch, "wall_s": walls,
                "scan_dtype": scan_dtype or "float32", "iters": iters,
                "median_final_cost": statistics.median(costs),
                "mean_n_iters_last_stage": statistics.mean(n_iters),
                "median_cost": _median(cost),
                "median_cert_min": _median(cert),
                "scan_launches": launches}, out

    return _on_the_ladder("plans", batches, measure)


def bench_plans_profile(scan_dtype: str | None = "bfloat16",
                        batches=PLANS_BATCHES, device=None) -> dict:
    """The device's busy share of one main-path solve (the plans section's
    problem and stages, ``_main_path``) under torch.profiler
    (``profile_solve``), after one warm-up solve, with the kernels that
    fill it. The last section: a profiler session leaves every later
    launch of its process slower (plans_ab.py: 1.23-1.32x after 49
    sessions, on an H100), so no timed section may follow it. It needs the
    card: the profiler reads the device's trace."""
    from svsdf_tpu_torch import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the device's busy share needs a CUDA device")

    def measure(batch):
        mp = _main_path(PLANS_PIECES, PLANS_OBS, PLANS_ITERS, scan_dtype,
                        batch, dev, torch.float32)
        mp.run(mp.x0)                            # warm-up
        return {"plan_batch_size": batch,
                "scan_dtype": scan_dtype or "float32",
                **profile_solve(lambda: mp.run(mp.x0))}

    return _on_the_ladder("plans_profile", batches, measure)


#: the grid query: grid x grid points, the coarse scan's K
GRID_POINTS = 256
GRID_COARSE_N = 256


def bench_grid_queries(device=None) -> dict:
    """Dense SVSDF grid queries/s (bench.py::bench_grid_queries):
    ``svsdf_grid`` of sdHeart along ``grid_setup``'s trajectory on
    GRID_POINTS x GRID_POINTS points, ``SVSDFConfig(GRID_COARSE_N,
    refine_rounds=3)``, float32 scans, outside distance only. A run is 8
    batches, each on the axes perturbed by U(+-0.1) (numpy seed 1; the JAX
    bench perturbs each point, which would leave a grid), summed on the
    device and closed by one host readback; one warm-up, then 3 runs each
    shifted by another 1e-5."""
    from svsdf_tpu_torch import resolve_device
    from svsdf_tpu_torch.ops import cuda_svsdf as cs
    from svsdf_tpu_torch.ops.svsdf import svsdf_grid

    dev = resolve_device(device)
    grid = GRID_POINTS
    gq = grid_setup(grid, device=dev)
    svs = SVSDFConfig(coarse_n=GRID_COARSE_N, refine_rounds=3)
    reps = 8
    shifts = torch.as_tensor(np.random.default_rng(1).uniform(
        -0.1, 0.1, (reps, 2, grid)).astype(np.float32), device=dev)

    def run(ds):
        acc = torch.zeros((), device=dev)
        for d in ds:
            acc = acc + svsdf_grid(gq.shape, gq.traj, gq.xs + d[0],
                                   gq.ys + d[1], svs).sum()
        return float(acc)

    cs.reset_launches()
    total = run(shifts)                          # warm-up
    walls = []
    for i in range(3):
        t0 = time.perf_counter()
        total = run(shifts + 1e-5 * (i + 1))
        walls.append(time.perf_counter() - t0)
    launches = _check_launched(dev, cs, None, "the grid query")
    if not math.isfinite(total):
        raise RuntimeError(f"the grid query's field is not finite: {total}")
    dt = statistics.median(walls)
    return {"queries_per_s": reps * grid * grid / dt,
            "grid_batch_s": dt / reps, "wall_s": walls, "points": grid * grid,
            "coarse_n": GRID_COARSE_N, "scan_launches": launches}


#: the e2e cell: pieces, obstacles harvested a plan, L-BFGS iterations,
#: the batch and the one it falls back to on an out-of-memory error
E2E_PIECES, E2E_OBS, E2E_ITERS = 8, 48, 40
E2E_BATCHES = (512, 256)


def bench_e2e(scan_dtype: str | None = "bfloat16", device=None) -> dict:
    """Fully end-to-end batched plans/s (bench.py::bench_e2e):
    ``plan_batch_e2e`` on ``e2e_setup``'s forest map (sdHeart, device
    wavefront front end, resample, harvest, staged solve at
    ``default_stages(E2E_ITERS, scan_dtype=...)``), start and goal cells
    drawn with numpy seed 0. One warm-up, then 3 timed runs on fresh
    draws, each closed by a host readback; the first batch of E2E_BATCHES
    that does not run out of device memory. Then the front end alone and a whole run on the last
    draws, timed in turns twice: the front end's share of a run."""
    from svsdf_tpu_torch import resolve_device
    from svsdf_tpu_torch.ops import cuda_svsdf as cs
    from svsdf_tpu_torch.parallel import batch as pb
    from svsdf_tpu_torch.utils.config import PlannerConfig

    dev = resolve_device(device)
    e = e2e_setup(device=dev)
    cfg = PlannerConfig(mem_size=BENCH_MEM_SIZE)
    stages = pb.default_stages(E2E_ITERS, scan_dtype=scan_dtype)
    n_pieces, n_obs = E2E_PIECES, E2E_OBS
    res_m = e.grid.resolution
    xy_min = e.grid.xyz_min[:2].astype(np.float32)
    rng = np.random.default_rng(0)

    def run(s, g):
        out = pb.plan_batch_e2e(e.shape, e.feas, e.occ_pts, s, g, cfg, stages,
                                n_pieces, n_obs, res_m, xy_min, device=dev)
        float(out.cost.sum())
        return out

    def timed(fn):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        return time.perf_counter() - t0

    def measure(b):
        cs.reset_launches()
        run(*e2e_draws(e.cells, b, rng))         # warm-up
        walls, outs = [], []
        for _ in range(3):
            s, g = e2e_draws(e.cells, b, rng)
            t0 = time.perf_counter()
            outs.append(run(s, g))
            walls.append(time.perf_counter() - t0)
        launches = _check_launched(dev, cs, scan_dtype, "the e2e path")
        fronts, wholes = [], []
        for _ in range(2):
            fronts.append(timed(lambda: pb.front_end(
                e.feas, e.occ_pts, s, g, cfg, n_pieces, n_obs, res_m,
                xy_min, device=dev)))
            wholes.append(timed(lambda: run(s, g)))
        for o in outs:
            if not (torch.isfinite(o.cost).all() and torch.isfinite(o.x).all()
                    and torch.isfinite(o.cert_min).all()
                    and o.coeffs.shape == (b, n_pieces, 6, 3)):
                raise RuntimeError("the e2e path's output is not finite or "
                                   "has the wrong shape")
        dt = statistics.median(walls)
        return {"e2e_per_s": b / dt, "e2e_ok": float(
                    outs[-1].front_ok.float().mean()),
                "front_ok_share": [float(o.front_ok.float().mean())
                                   for o in outs],
                "plan_batch_size": b, "wall_s": walls,
                "scan_dtype": scan_dtype or "float32",
                "median_cost": statistics.median(
                    float(o.cost.median()) for o in outs),
                "median_cert_min": statistics.median(
                    float(o.cert_min.median()) for o in outs),
                "front_end_share": statistics.median(fronts)
                / statistics.median(wholes),
                "front_end_s": fronts, "whole_s": wholes,
                "scan_launches": launches}

    return _on_the_ladder("e2e", E2E_BATCHES, measure)


#: the batch-1 solves: pieces, obstacles, L-BFGS iterations, timed solves
REPLAN_PIECES, REPLAN_OBS, REPLAN_ITERS, REPLAN_REPS = 8, 64, 50, 15


def bench_replan_latency(device=None) -> dict:
    """Back-end solve latency (bench.py::bench_replan_latency): a batch-1
    staged solve at ``default_stages_lowlat(REPLAN_ITERS)`` (bfloat16
    scans), ``PlannerConfig()``, sdHeart, on plan i of ``problem(
    REPLAN_PIECES, REPLAN_OBS, REPLAN_REPS + 1)`` for i = 0..REPLAN_REPS,
    each closed by a host readback; the first is dropped (warm-up). No
    front end, no harvest: the optimizer's floor, not a replan. Reports
    p50 and p90 over the timed solves, the share of them whose cost and x
    are finite, and the median certificate on ``HIFI`` (negative on this
    problem set: its random points lie on every route, so it measures the
    solver's speed, not avoidance)."""
    from svsdf_tpu_torch import convert, resolve_device
    from svsdf_tpu_torch.models import shapes
    from svsdf_tpu_torch.ops import cuda_svsdf as cs
    from svsdf_tpu_torch.parallel import batch as pb
    from svsdf_tpu_torch.utils.config import PlannerConfig

    dev = resolve_device(device)
    cfg = PlannerConfig()
    stages = pb.default_stages_lowlat(REPLAN_ITERS)
    shape = shapes.make_shape("sdHeart")
    n_pieces, reps = REPLAN_PIECES, REPLAN_REPS
    h, tl, obs, x0 = problem(n_pieces, REPLAN_OBS, reps + 1)
    cs.reset_launches()
    lat, solved = [], []
    for i in range(reps + 1):
        prob, x = convert.problem_from_numpy(h[i:i + 1], tl[i:i + 1],
                                             obs[i:i + 1], x0[i:i + 1],
                                             device=dev)
        t0 = time.perf_counter()
        out = pb.plan_batch_staged(shape, x, prob, cfg, stages, n_pieces,
                                   device=dev)
        float(out.cost.sum())
        if i > 0:                                # i = 0 is the warm-up
            lat.append(time.perf_counter() - t0)
            solved.append((prob, out))
    launches = _check_launched(dev, cs, "bfloat16", "the batch-1 solve")
    certs = [float(rescore(shape, prob, cfg, n_pieces, out)[1][0])
             for prob, out in solved]
    finite = [bool(torch.isfinite(out.cost).all()
                   and torch.isfinite(out.opt_x).all()) for _, out in solved]
    return {"backend_solve_p50_s": float(np.percentile(lat, 50)),
            "backend_solve_p90_s": float(np.percentile(lat, 90)),
            "backend_solve_finite_share": float(np.mean(finite)),
            "backend_solve_cert_median": float(np.median(certs)),
            "latency_s": lat, "reps": reps, "scan_launches": launches}


#: the real-map replans timed (bench.py::bench_replan_map's _real_replan)
REPLAN_MAP_REPS = 6


def bench_replan_map(device=None) -> dict:
    """Real-map certified replan (bench.py::bench_replan_map, the last
    section, since the replanner's build dominates it): ``OnlineReplanner``
    p50 and certificate on the reference's sdHeart map at
    bench.py::_real_replan's settings (n_pieces=12, n_obs=160,
    default_stages(80), 14 refine rounds of 12 iterations, tightness 8),
    start and goal jittered by +-0.25 resolution (numpy seed 0),
    REPLAN_MAP_REPS timed after a warm-up. The map is not in the
    repository: without it this raises FileNotFoundError."""
    from svsdf_tpu_torch.parallel import batch as pb
    from svsdf_tpu_torch.planner.online import OnlineReplanner
    from svsdf_tpu_torch.utils import fixtures

    try:
        sc = fixtures.load_any("sdHeart")
    except FileNotFoundError as e:
        raise FileNotFoundError(
            "the reference's sdHeart fixture is not in the repository "
            f"(SVSDF_REFERENCE_ROOT={fixtures.REFERENCE_ROOT}): {e}") from e
    rp = OnlineReplanner(sc.config, sc.map_points, n_pieces=12, n_obs=160,
                         stages=pb.default_stages(80), refine_rounds=14,
                         refine_iters=12, tightness_weight=8.0, device=device)
    rp.replan(sc.start[:2], sc.goal[:2])         # warm-up
    rng = np.random.default_rng(0)
    jit_r = 0.25 * sc.config.occupancy_resolution
    lat, cert = [], []
    for _ in range(REPLAN_MAP_REPS):
        s = np.asarray(sc.start[:2]) + rng.uniform(-jit_r, jit_r, 2)
        g = np.asarray(sc.goal[:2]) + rng.uniform(-jit_r, jit_r, 2)
        t0 = time.perf_counter()
        r = rp.replan(s, g)
        lat.append(time.perf_counter() - t0)
        cert.append(r.cert_min)
    out = {"replan_p50_s": float(np.median(lat)),
           "replan_cert_median": float(np.median(cert))}
    out.update(_drift_check(out))
    return out


def _drift_check(live: dict) -> dict:
    """The live sdHeart certificate median against the committed
    online_replans.json row: a sign flip or a departure over 0.3 m sets
    ``"drift": true`` (bench.py::_drift_check)."""
    try:
        with open(os.path.join(ROOT, "online_replans.json")) as f:
            rows = {r["name"]: r for r in json.load(f)}
        committed = rows["sdHeart"]["cert_min_median"]
    except (OSError, ValueError, KeyError):
        return {}
    lv = live["replan_cert_median"]
    sign_flip = (lv < 0.0 <= committed) or (committed < 0.0 <= lv)
    return {"replan_cert_committed": committed,
            "drift": bool(sign_flip or abs(lv - committed) > 0.3)}


# ---------------------------------------------------------------------------
# the harness (bench.py's _child, _stream_sections, _headline, main)
# ---------------------------------------------------------------------------

#: the sections in the order they run: plans first (the headline),
#: replan_map after the other timed ones (its replanner build can take the
#: rest of the budget), plans_profile last (no timed section may follow a
#: profiler session)
_SECTIONS = {
    "plans": bench_plans,
    "grid": bench_grid_queries,
    "e2e": bench_e2e,
    "replan": bench_replan_latency,
    "replan_map": bench_replan_map,
    "plans_profile": bench_plans_profile,
}

#: per-section wall budgets (s), bench.py's; all within BENCH_BUDGET_S
_BUDGETS = {"plans": 600, "grid": 210, "replan": 120,
            "replan_map": 520, "e2e": 330, "plans_profile": 120}
#: no new child is started within this many seconds of the total budget
_RESTART_MARGIN_S = 30


def _child(sections, device: str) -> None:
    """Child-process entry: run ``sections`` one after another in this
    process, printing ``#START name`` before each and ``#RESULT name
    {json}`` after. A section that raises reports ``{"error": ...}``
    (no metric) and the next one runs; one that hangs is the parent's to
    kill."""
    for section in sections:
        print("#START " + section, flush=True)
        t0 = time.time()
        try:
            out = _SECTIONS[section](device=device)
        except Exception as e:                   # noqa: BLE001 -- reported
            traceback.print_exc(file=sys.stderr)
            out = {"error": f"{type(e).__name__}: {e}"[:500]}
        out["section_wall_s"] = time.time() - t0
        if section == "plans":
            out["backend"] = device
            out["device"] = smi_line() if device == "cuda" else "cpu"
        print(f"#RESULT {section} " + json.dumps(out), flush=True)


def _child_argv(device: str) -> list:
    """The child's command line, without its ``--sections``."""
    return [sys.executable, "-m", "svsdf_tpu_torch.bench", "--device",
            device]


def _stream_sections(argv, sections, res, deadline, on_result) -> list:
    """Run ``sections`` in one child (``argv`` + ``--sections``), storing
    each ``#RESULT`` in ``res`` and calling ``on_result(name)``. A section
    past its budget (or the deadline) is killed with the child and gets an
    error entry, as does one running when the child dies. Returns the
    sections still to run in a new child."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen(argv + ["--sections", ",".join(sections)],
                            stdout=subprocess.PIPE, text=True, bufsize=1,
                            env=env, start_new_session=True)
    lines: queue.Queue = queue.Queue()

    def reader():
        # a thread, so that a #RESULT in the text buffer is never missed
        # while the parent waits
        for ln in proc.stdout:
            lines.put(ln.rstrip("\n"))
        lines.put(None)

    threading.Thread(target=reader, daemon=True).start()
    pending = list(sections)
    current = None
    started = time.time()

    def fail(name, why):
        res[name] = {"error": why, "section_wall_s": time.time() - started}
        pending.remove(name)
        print(f"# section {name}: {why}", file=sys.stderr)
        on_result(name)

    try:
        while pending:
            name = current or pending[0]
            budget = _BUDGETS.get(name, 300)
            timeout_at = min(started + budget, deadline)
            if time.time() >= timeout_at:
                _kill(proc)
                fail(name, f"killed: past its budget of {budget} s"
                     if timeout_at < deadline else
                     "killed: the total budget BENCH_BUDGET_S expired")
                return pending
            try:
                line = lines.get(timeout=min(5.0, max(
                    0.1, timeout_at - time.time())))
            except queue.Empty:
                continue
            if line is None:                     # the child exited
                fail(name, f"the child process exited ({proc.wait()}) "
                     "before the section reported")
                return pending
            if line.startswith("#START "):
                current = line.split(" ", 1)[1]
                started = time.time()
            elif line.startswith("#RESULT "):
                _, done, payload = line.split(" ", 2)
                res[done] = json.loads(payload)
                print(f"# section {done} done in {time.time() - started:.0f}"
                      "s: " + payload, file=sys.stderr)
                if done in pending:
                    pending.remove(done)
                current = None
                started = time.time()
                on_result(done)
            elif line.startswith("#"):
                print(line, file=sys.stderr)
        return []
    finally:
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            pass
        _kill(proc)


def _kill(proc) -> None:
    """Kill the child and every process it started (its session)."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def _headline(res: dict, partial: bool) -> str:
    """The one JSON line (bench.py::_headline's layout): plans/s a card,
    the other sections' numbers under ``extra``. No TPU figure is a
    baseline for the port, so ``vs_baseline`` is null, and PyTorch has no
    cost analysis for XLA's FLOP and byte counts, so those four fields are
    null; ``device_busy_share`` (plans_profile's solve: device time over
    its wall) stands beside them."""
    plans = res.get("plans", {})
    grid = res.get("grid", {})
    replan = res.get("replan", {})
    replan_map = res.get("replan_map", {})
    e2e = res.get("e2e", {})
    profile = res.get("plans_profile", {})
    nan = float("nan")

    def r(x):
        return x if isinstance(x, float) and math.isfinite(x) else None

    return json.dumps({
        "metric": "batched_svsdf_plans_per_s_per_gpu",
        "value": r(plans.get("plans_per_s", nan)),
        "unit": "plans/s",
        "vs_baseline": None,
        "baseline_definition": "none: no TPU figure is a baseline for the "
                               "PyTorch/H100 port, the port has no H100 "
                               "baseline recorded yet, and the reference "
                               "publishes no numbers",
        "extra": {
            "e2e_plans_per_s": r(e2e.get("e2e_per_s", nan)),
            "e2e_frontend_success_rate": r(e2e.get("e2e_ok", nan)),
            "e2e_front_end_share": r(e2e.get("front_end_share", nan)),
            "replan_latency_p50_ms": r(
                replan_map.get("replan_p50_s", nan) * 1e3),
            "replan_cert_median": r(replan_map.get("replan_cert_median",
                                                   nan)),
            "replan_drift": replan_map.get("drift"),
            "backend_solve_p50_ms": r(
                replan.get("backend_solve_p50_s", nan) * 1e3),
            "backend_solve_p90_ms": r(
                replan.get("backend_solve_p90_s", nan) * 1e3),
            "backend_solve_finite_share": r(replan.get(
                "backend_solve_finite_share", nan)),
            "backend_solve_cert_median": r(
                replan.get("backend_solve_cert_median", nan)),
            "svsdf_grid_queries_per_s": r(grid.get("queries_per_s", nan)),
            "grid_query_batch_ms": r(grid.get("grid_batch_s", nan) * 1e3),
            "plan_batch_wall_s": r(plans.get("plan_batch_wall_s", nan)),
            "plan_batch_size": plans.get("plan_batch_size"),
            "median_cost": r(plans.get("median_cost", nan)),
            "median_cert_min": r(plans.get("median_cert_min", nan)),
            "median_final_cost": r(plans.get("median_final_cost", nan)),
            "achieved_gflops": None,
            "pct_vpu_peak": None,
            "pct_hbm_peak": None,
            "arithmetic_intensity": None,
            "device_busy_share": r(profile.get("device_busy_share", nan)),
            "backend": plans.get("backend"),
            "device": plans.get("device"),
            "scan_dtype": plans.get("scan_dtype"),
            "section_errors": {k: v["error"] for k, v in sorted(res.items())
                               if "error" in v},
            "partial": partial,
        },
    })


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m svsdf_tpu_torch.bench",
        description="The port's benchmark: batched SVSDF plans/s and the "
                    "other sections on one CUDA card; one JSON line.")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu runs the sections on the host, for tests: "
                         "its numbers are no device's")
    ap.add_argument("--sections", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the benchmark needs a CUDA card and none is "
                           "available (--device cpu is for tests)")
    if args.sections is not None:
        _child(args.sections.split(","), args.device)
        return 0
    deadline = time.time() + float(os.environ.get("BENCH_BUDGET_S", 1080))
    res: dict = {}

    def on_result(name):
        if name == "plans":
            # the primary metric at once: a caller's timeout during the
            # later sections still finds a number
            print(_headline(res, partial=True), flush=True)

    pending = list(_SECTIONS)
    while pending and time.time() < deadline - _RESTART_MARGIN_S:
        pending = _stream_sections(_child_argv(args.device), pending, res,
                                   deadline, on_result)
        if pending:
            print(f"# restarting the child for {pending}", file=sys.stderr)
    for name in pending:
        res[name] = {"error": "not run: the total budget BENCH_BUDGET_S "
                              "expired"}
    print(_headline(res, partial=False), flush=True)
    return 0 if "plans_per_s" in res.get("plans", {}) else 1


if __name__ == "__main__":
    sys.exit(main())
