"""The benchmark's inputs, made from the seed: frozen copies of the
problem sets the port's own bench drew (``svsdf_tpu_torch/bench.py``),
so that a later change to the program cannot change the traffic.

Every draw takes a ``numpy.random.Generator``; the harness seeds one per
solve or query batch from (``--seed``, index), so the same seed gives the
same inputs and every seed the same sizes.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from benchmark import reference as ref


def draw_problems(t: dict, batch: int, rng: np.random.Generator):
    """B independent back-end problems (``bench.py::problem``): head at
    the origin at rest, goal in [goal_lo, goal_hi] with yaw in
    [-yaw_abs, yaw_abs], the N-1 inner waypoints on the head-goal segment
    plus N(0, waypoint_sigma) noise, M obstacle points uniform in
    [obstacle_lo, obstacle_hi], pieces of ``piece_s`` seconds.
    Returns float32 (head (B,3,3), tail (B,3,3), obstacles (B,M,2),
    x0 (B, 4N-3))."""
    n, m = t["pieces"], t["obstacles"]
    head = np.zeros((batch, 3, 3), np.float32)
    tail = np.zeros((batch, 3, 3), np.float32)
    tail[:, 0, :2] = rng.uniform(t["goal_lo"], t["goal_hi"], size=(batch, 2))
    tail[:, 0, 2] = rng.uniform(-t["yaw_abs"], t["yaw_abs"], batch)
    frac = np.linspace(0, 1, n + 1)[1:-1]
    wps = (head[:, 0][:, None, :] * (1 - frac)[None, :, None]
           + tail[:, 0][:, None, :] * frac[None, :, None])
    wps = wps + rng.normal(0, t["waypoint_sigma"], wps.shape)
    obs = rng.uniform(t["obstacle_lo"], t["obstacle_hi"], size=(batch, m, 2))
    tau = np.tile(tau_of(t["piece_s"], n), (batch, 1))
    x0 = np.concatenate([tau, wps.reshape(batch, -1)], axis=1)
    return head, tail, obs.astype(np.float32), x0.astype(np.float32)


def tau_of(piece_s: float, n: int) -> np.ndarray:
    """(N,) float32 decision value of a piece of ``piece_s`` seconds: the
    inverse of the planner's time transform, in float32."""
    t = np.full(n, piece_s, np.float32)
    one, two = np.float32(1.0), np.float32(2.0)
    hi = np.sqrt(np.maximum(two * t - one, np.float32(0.0))) - one
    lo = one - np.sqrt(np.maximum(two / np.maximum(t, np.float32(1e-30))
                                  - one, np.float32(0.0)))
    return np.where(t > one, hi, lo).astype(np.float32)


def grid_knots(t: dict):
    """The grid query's trajectory knots (``bench.py::grid_setup``): N
    pieces of ``piece_s`` seconds from rest at the origin to rest at
    ``goal``, through (10 f, sin 5 f, f) at the inner fractions f.
    Returns float32 (durations (1,N), head (1,3,3), tail (1,3,3),
    waypoints (1,N-1,3))."""
    n = t["pieces"]
    head = np.zeros((1, 3, 3), np.float32)
    tail = np.zeros((1, 3, 3), np.float32)
    tail[0, 0] = t["goal"]
    frac = np.linspace(0, 1, n + 1)[1:-1]
    wps = np.stack([10 * frac, np.sin(5 * frac), frac], -1)[None]
    return (np.full((1, n), t["piece_s"], np.float32), head, tail,
            wps.astype(np.float32))


def grid_axes(t: dict, rng: np.random.Generator):
    """One query batch's axes: linspace over [x_lo, x_hi] and [y_lo, y_hi]
    with ``points`` values each, every value shifted by U(-shift, shift).
    Returns float32 (xs, ys)."""
    g = t["points"]
    d = rng.uniform(-t["shift"], t["shift"], (2, g))
    xs = np.linspace(t["x"][0], t["x"][1], g) + d[0]
    ys = np.linspace(t["y"][0], t["y"][1], g) + d[1]
    return xs.astype(np.float32), ys.astype(np.float32)


#: marching squares: for each corner-sign case, the pairs of cell edges
#: its contour segments join (edges 0..3: bottom, right, top, left)
_MS_TABLE = {
    0: [], 15: [],
    1: [(3, 0)], 2: [(0, 1)], 3: [(3, 1)], 4: [(1, 2)],
    5: [(3, 2), (1, 0)], 6: [(0, 2)], 7: [(3, 2)], 8: [(2, 3)],
    9: [(2, 0)], 10: [(0, 3), (2, 1)], 11: [(2, 1)], 12: [(1, 3)],
    13: [(1, 0)], 14: [(0, 3)],
}


def _contour(ax, field):
    """Zero-contour segments (S, 2, 2) of ``field`` on the square grid
    ``ax`` x ``ax``, by marching squares with linear interpolation."""
    neg = field < 0.0
    mixed = neg[:-1, :-1] + neg[1:, :-1] + neg[1:, 1:] + neg[:-1, 1:]
    segs = []
    for i, j in zip(*np.nonzero((mixed > 0) & (mixed < 4))):
        corner = [(i, j), (i + 1, j), (i + 1, j + 1), (i, j + 1)]
        v = [field[c] for c in corner]
        case = sum(1 << k for k in range(4) if v[k] < 0.0)
        cut = {}
        for e, (a, b) in enumerate(((0, 1), (1, 2), (2, 3), (3, 0))):
            if (v[a] < 0.0) != (v[b] < 0.0):
                u = v[a] / (v[a] - v[b])
                pa = np.array([ax[corner[a][0]], ax[corner[a][1]]])
                pb = np.array([ax[corner[b][0]], ax[corner[b][1]]])
                cut[e] = pa + u * (pb - pa)
        segs += [(cut[e0], cut[e1]) for e0, e1 in _MS_TABLE[case]]
    return np.asarray(segs, float)


def write_heart_prism(path: str, step: float, half_height: float,
                      extent: float = 6.0) -> str:
    """Write the sdHeart robot as a closed prism .obj
    (``bench.py::write_prism_obj``): the zero contour of the heart's SDF
    by marching squares on a ``step`` grid over [-extent, extent]^2,
    extruded over z in [-half_height, half_height]; each contour segment
    gives a side quad (two outward triangles) and one triangle of each
    cap, fanned from the contour's centroid (the heart is star-shaped
    about it)."""
    ax = np.arange(-extent, extent + step, step)
    gx, gy = np.meshgrid(ax, ax, indexing="ij")
    heart = ref.body_file("sdHeart").sdf
    segs = _contour(ax, heart(torch.as_tensor(gx),
                              torch.as_tensor(gy)).numpy())
    c = segs.reshape(-1, 2).mean(axis=0)
    a, b = segs[:, 0] - c, segs[:, 1] - c
    ccw = a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0] > 0.0
    segs = np.where(ccw[:, None, None], segs, segs[:, ::-1])
    h = half_height
    vertex = lambda x, y, z: f"v {float(x)!r} {float(y)!r} {z!r}\n"
    # written whole under a name of this process's, then moved into
    # place, so that a process reading the file never sees part of it
    part = f"{path}.{os.getpid()}.part"
    with open(part, "w") as f:
        f.write(vertex(*c, -h) + vertex(*c, h))
        for (ax_, ay_), (bx_, by_) in segs:
            f.write(vertex(ax_, ay_, -h) + vertex(bx_, by_, -h)
                    + vertex(bx_, by_, h) + vertex(ax_, ay_, h))
        for i in range(len(segs)):
            a0, b0, b1, a1 = (3 + 4 * i + j for j in range(4))
            f.write(f"f {a0} {b0} {b1}\nf {a0} {b1} {a1}\n"
                    f"f 2 {a1} {b1}\nf 1 {b0} {a0}\n")
    os.replace(part, path)
    return path


def _block(ori, size, res):
    """The lattice of points filling the box [ori, ori + size), one axis
    collapsed to its origin where the box is no thicker than ``res``."""
    axes = [np.arange(o, o + e, res) if e > res else np.asarray([o])
            for o, e in zip(ori, size)]
    g = np.meshgrid(*axes, indexing="ij")
    return np.stack([a.ravel() for a in g], axis=-1)


def forest_points(m: dict) -> np.ndarray:
    """The forest map's point cloud (``utils/mapgen.py::map_forest``): two
    thin corner posts pinning the bounds, and ``n_trees`` square pillars
    of 5 x 5 x 20 m at uniform positions in [0, extent]^2 kept
    ``keepout`` from (1, 1), drawn from the map's own seed. (N, 3)."""
    rng = np.random.default_rng(m["seed"])
    res, ext = m["res"], m["extent"]
    parts = [_block((x, y, 0.0), (0.2, 0.2, 3.0), res)
             for x, y in ((0.0, 0.0), (ext, ext))]
    while len(parts) < 2 + m["n_trees"]:
        x, y = rng.uniform(0, ext, 2)
        if np.hypot(x - 1.0, y - 1.0) < m["keepout"]:
            continue
        parts.append(_block((x, y, 0.0), (5.0, 5.0, 20.0), res))
    return np.concatenate(parts)
