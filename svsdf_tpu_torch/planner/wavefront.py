"""Batched wavefront front end on the device (svsdf_tpu/planner/wavefront.py).

A min-plus relaxation (Bellman-Ford over the 8-connected grid) computes
the exact geodesic cost-to-go field to each lane's goal over the whole
grid; a fixed-length greedy descent extracts the path; a Viterbi DP
assigns yaw bins. The 3-D variant searches (yaw bin, x, y) states with
edges gated by the transition stencils of ops/kernels.py.

Batch-native: fields are (B, X, Y) and (B, K, X, Y), paths (B, L, 2); the
map tensors (free, feas, trans_feas, cell_cost) are shared by the lanes.
The JAX package vmaps a ``while_loop`` whose lanes stop at their own
convergence (``any(d2 < d - 1e-6)``), which can stop a lane before a
one-ulp improvement another sweep would make. So each lane keeps an
``active`` flag on the device, inactive lanes are frozen with
``torch.where``, and the host reads ``active.any()`` only every few
sweeps: a sweep past the end changes nothing, so the values are the
JAX package's with few host syncs. The path scans stop early the same
way once every lane is done (a done lane repeats its last cell).

Field arithmetic is float32 on both sides; every sum keeps the JAX
package's operation order, so the fields agree to the bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from svsdf_tpu_torch import resolve_device
from svsdf_tpu_torch.ops.kernels import DIRS8, YAW_BFS_DELTAS
from svsdf_tpu_torch.utils.profiling import host_bool

INF = 1e9
#: 8-neighborhood (dx, dy) and step costs of the 2-D field
_DIRS = [(1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (1, -1), (-1, 1),
         (-1, -1)]
_SQRT2_F32 = float(np.float32(np.sqrt(2.0)))
_COSTS = [1.0, 1.0, 1.0, 1.0] + [_SQRT2_F32] * 4

#: sweeps (and path steps) between two host reads of the done flags
_CHECK_EVERY = 8


class WavefrontResult(NamedTuple):
    success: torch.Tensor     # (B,) bool
    path_ij: torch.Tensor     # (B, L, 2) int64 cells, padded with last
    yaw_bins: torch.Tensor    # (B, L) int64
    length: torch.Tensor      # (B,) int64 valid entries
    dist: torch.Tensor        # (B, X, Y) cost-to-go field


def _pad(a, fill):
    """Pad the last two axes by one cell of ``fill``."""
    if a.dtype == torch.bool:
        return F.pad(a.to(torch.uint8), (1, 1, 1, 1), value=int(fill)).bool()
    return F.pad(a, (1, 1, 1, 1), value=fill)


def _view(apad, di, dj, x, y):
    """out[..., i, j] = a[..., i + di, j + dj] (the fill outside), from
    the padded ``apad``."""
    return apad[..., 1 + di:1 + di + x, 1 + dj:1 + dj + y]


def _lanes(goal_ij, dev):
    g = torch.as_tensor(goal_ij, device=dev).long()
    return g, torch.arange(g.shape[0], device=dev)


def _relax_loop(relax, d, max_iters):
    """JAX's vmapped while_loop on (d, changed, it): each lane sweeps
    while it changed by more than 1e-6 and it < max_iters."""
    nb = d.shape[0]
    changed = torch.ones(nb, dtype=torch.bool, device=d.device)
    it = torch.ones(nb, dtype=torch.long, device=d.device)
    sweep = 0
    while True:
        active = changed & (it < max_iters)
        if sweep % _CHECK_EVERY == 0 and not host_bool(active.any(),
                                                       "wavefront.relax"):
            break
        sweep += 1
        d2 = relax(d)
        ch = torch.any((d2 < d - 1e-6).reshape(nb, -1), dim=1)
        mask = active.reshape((nb,) + (1,) * (d.dim() - 1))
        d = torch.where(mask, d2, d)
        changed = torch.where(active, ch, changed)
        it = torch.where(active, it + 1, it)
    return d


def distance_field(free, goal_ij, max_iters: int | None = None,
                   device=None):
    """Exact 8-connected geodesic cost-to-go to each lane's goal over the
    free cells. free (X, Y) bool; goal_ij (B, 2) int. Returns (B, X, Y)
    float32 (INF = blocked / unreachable). max_iters is a safety cap,
    X*Y by default (the worst-case geodesic length in cells)."""
    dev = resolve_device(device)
    free = torch.as_tensor(free, device=dev)
    g, lanes = _lanes(goal_ij, dev)
    X, Y = free.shape
    if max_iters is None:
        max_iters = X * Y
    d0 = torch.full((g.shape[0], X, Y), INF, dtype=torch.float32, device=dev)
    d0[lanes, g[:, 0], g[:, 1]] = 0.0
    freef = torch.where(free, 0.0, INF).to(torch.float32)

    def relax(d):
        dpad = _pad(d, INF)
        best = d
        for (dx, dy), c in zip(_DIRS, _COSTS):
            # neighbour's distance + step cost; blocked cells INF
            cand = _view(dpad, -dx, -dy, X, Y) + c + freef
            best = torch.minimum(best, cand)
        return best

    return _relax_loop(relax, relax(d0), max_iters)


def _finish_path(steps, start, n_steps):
    """(B, L, 2) path from the start and the steps taken, the last cell
    repeated where the scan stopped early."""
    path = torch.stack([start] + steps, dim=1)
    pad = n_steps + 1 - path.shape[1]
    if pad:
        path = torch.cat([path, path[:, -1:].expand(-1, pad, -1)], dim=1)
    return path


def _length(path):
    moved = torch.any(path[:, 1:] != path[:, :-1], dim=-1)
    return 1 + moved.sum(dim=1)


def extract_path(dist, start_ij, max_len: int = 512, device=None):
    """Greedy steepest descent from each lane's start to its dist==0
    cell. Returns (path (B, max_len, 2), length (B,), success (B,)); the
    path repeats its final cell once the goal is reached."""
    dev = resolve_device(device)
    dist = torch.as_tensor(dist, device=dev)
    ij, lanes = _lanes(start_ij, dev)
    nb, X, Y = dist.shape
    dirs = torch.as_tensor(_DIRS, device=dev)
    costs = torch.as_tensor(_COSTS, dtype=torch.float32, device=dev)
    hi = torch.as_tensor([X - 1, Y - 1], device=dev)
    start = ij
    done = torch.zeros(nb, dtype=torch.bool, device=dev)
    steps = []
    for k in range(max_len - 1):
        if k % _CHECK_EVERY == 0 and host_bool(done.all(), "wavefront.path"):
            break
        here = dist[lanes, ij[:, 0], ij[:, 1]]
        nbr = ij[:, None, :] + dirs                          # (B, 8, 2)
        ok = ((nbr[..., 0] >= 0) & (nbr[..., 0] < X)
              & (nbr[..., 1] >= 0) & (nbr[..., 1] < Y))
        nclip = torch.minimum(torch.clamp_min(nbr, 0), hi)
        nd = dist[lanes[:, None], nclip[..., 0], nclip[..., 1]] + costs
        nd = torch.where(ok, nd, INF)
        j = torch.argmin(nd, dim=1)
        ndj = torch.gather(nd, 1, j[:, None])[:, 0]
        # along an exact geodesic dist[n] + c == here; the tolerance
        # absorbs float32 drift over long fields, and the INF gate keeps
        # unreachable lanes in place
        improves = (ndj < here + 1e-3 + 1e-5 * here) & (ndj < 0.5 * INF)
        at_goal = here <= 0.0
        move = ~done & ~at_goal & improves
        ij = torch.where(move[:, None], nbr[lanes, j], ij)
        done = done | at_goal | ~improves
        steps.append(ij)
    path = _finish_path(steps, start, max_len - 1)
    final = path[:, -1]
    success = dist[lanes, final[:, 0], final[:, 1]] <= 0.0
    return path, _length(path), success


def _circular_delta(k, dev):
    bins = torch.arange(k, device=dev)
    return bins, torch.minimum(
        torch.remainder(bins[:, None] - bins[None, :], k),
        torch.remainder(bins[None, :] - bins[:, None], k))


def assign_yaws(feas, path, prev_bin0: int = 0, device=None):
    """Per-cell yaw bins along each path: the feasible bin nearest to
    the previous cell's bin (circular), greedy. feas (K, X, Y) bool,
    path (B, L, 2). Returns (B, L) int64."""
    dev = resolve_device(device)
    feas = torch.as_tensor(feas, device=dev)
    path = torch.as_tensor(path, device=dev).long()
    k = feas.shape[0]
    fpath = feas[:, path[..., 0], path[..., 1]].permute(1, 2, 0)  # (B, L, K)
    bins = torch.arange(k, device=dev)
    prev = torch.full((path.shape[0],), prev_bin0, dtype=torch.long,
                      device=dev)
    out = []
    for i in range(path.shape[1]):
        f = fpath[:, i]
        delta = torch.minimum(torch.remainder(bins - prev[:, None], k),
                              torch.remainder(prev[:, None] - bins, k))
        score = torch.where(f, delta, k + 1)
        b = torch.argmin(score, dim=1)
        prev = torch.where(torch.any(f, dim=1), b, prev)
        out.append(prev)
    return torch.stack(out, dim=1)


def assign_yaws_dp(feas, path, device=None):
    """Globally smoothest yaw assignment along each path: a Viterbi DP
    over (cell, bin) minimising the total circular bin rotation subject
    to per-cell feasibility. feas (K, X, Y) bool; path (B, L, 2) (the
    padding repeats the last cell). Returns (B, L) int64 bins."""
    dev = resolve_device(device)
    feas = torch.as_tensor(feas, device=dev)
    path = torch.as_tensor(path, device=dev).long()
    k = feas.shape[0]
    nb, L = path.shape[:2]
    fpath = feas[:, path[..., 0], path[..., 1]].permute(1, 2, 0)  # (B, L, K)
    bins, delta = _circular_delta(k, dev)
    delta = delta.to(torch.float32)                          # (K_prev, K)
    big = 1e6
    c = torch.where(fpath[:, 0], 0.0, big).to(torch.float32)
    back = []
    for i in range(1, L):
        f = fpath[:, i]
        cand = c[:, :, None] + delta                         # (B, Kp, K)
        c_new, best_prev = torch.min(cand, dim=1)
        c_new = torch.where(f, c_new, big)
        # an infeasible cell carries the costs through and keeps the bin
        any_f = torch.any(f, dim=1, keepdim=True)
        c = torch.where(any_f, c_new, c)
        back.append(torch.where(any_f, best_prev, bins))
    b = torch.argmin(c, dim=1)
    out = [b]
    lanes = torch.arange(nb, device=dev)
    for bp in reversed(back):
        b = bp[lanes, b]
        out.append(b)
    return torch.stack(out[::-1], dim=1)


def distance_field_3d(feas, trans_feas, goal_ij, yaw_weight: float = 0.25,
                      max_iters: int | None = None, cell_cost=None,
                      device=None):
    """Exact cost-to-go over the (yaw bin, x, y) state space, with edges
    gated by the sub-swept-volume transition stencils: an edge moves one
    cell in one of 8 directions while rotating by delta bins, allowed iff
    trans_feas[k, delta_idx, dir_idx, x', y'], at cost step_len +
    yaw_weight * |delta|, plus cell_cost of the entered cell if given.

    feas (K, X, Y) bool; trans_feas (K, D, 8, X, Y) bool, its D axis in
    YAW_BFS_DELTAS order and its direction axis in ops.kernels.DIRS8
    order (not this module's _DIRS: mixing the two admits blocked
    sub-sweeps); goal_ij (B, 2). Any feasible goal yaw is accepted.
    Returns (B, K, X, Y) float32 (INF = unreachable)."""
    dev = resolve_device(device)
    feas = torch.as_tensor(feas, device=dev)
    trans_feas = torch.as_tensor(trans_feas, device=dev)
    g, lanes = _lanes(goal_ij, dev)
    K, X, Y = feas.shape
    D = trans_feas.shape[1]
    if max_iters is None:
        max_iters = X * Y + 4 * K
    d0 = torch.full((g.shape[0], K, X, Y), INF, dtype=torch.float32,
                    device=dev)
    d0[lanes, :, g[:, 0], g[:, 1]] = torch.where(
        feas[:, g[:, 0], g[:, 1]].T, 0.0, INF).to(torch.float32)
    ccost = (None if cell_cost is None else
             _pad(torch.as_tensor(cell_cost, device=dev)
                  .to(torch.float32), 0.0))

    # per edge: (delta, step cost, blocked-edge term, entry cost), the
    # child cell's flag and entry cost aligned to the father position
    edges = []
    for d_idx, de in enumerate(YAW_BFS_DELTAS[:D]):
        for m_idx, (di, dj) in enumerate(DIRS8):
            step = (2.0 ** 0.5) if (di != 0 and dj != 0) else 1.0
            c = step + yaw_weight * abs(de)
            allowed = _view(_pad(trans_feas[:, d_idx, m_idx], False),
                            di, dj, X, Y)
            blocked = torch.where(allowed, 0.0, INF).to(torch.float32)
            entry = None if ccost is None else _view(ccost, di, dj, X, Y)
            edges.append((de, di, dj, c, blocked, entry))

    def relax(d):
        best = d
        rolled = {}
        for de, di, dj, c, blocked, entry in edges:
            if de not in rolled:
                # child bin (k + de) mod K aligned to bin k
                rolled[de] = _pad(torch.roll(d, -de, dims=1), INF)
            cand = _view(rolled[de], di, dj, X, Y) + c + blocked
            if entry is not None:
                cand = cand + entry
            best = torch.minimum(best, cand)
        return best

    return _relax_loop(relax, relax(d0), max_iters)


def extract_path_3d(dist3, trans_feas, start_ij, max_len: int = 512,
                    yaw_weight: float = 0.25, cell_cost=None, device=None):
    """Greedy steepest descent through the 3-D field: returns (path
    (B, max_len, 2), bins (B, max_len), length (B,), success (B,)). The
    start bin is the cheapest bin at the start cell."""
    dev = resolve_device(device)
    dist3 = torch.as_tensor(dist3, device=dev)
    trans_feas = torch.as_tensor(trans_feas, device=dev)
    ij, lanes = _lanes(start_ij, dev)
    nb, K, X, Y = dist3.shape
    D = trans_feas.shape[1]
    deltas = torch.as_tensor(YAW_BFS_DELTAS[:D], device=dev)      # (D,)
    dirs = torch.as_tensor(DIRS8, device=dev)                     # (8, 2)
    step_costs = torch.as_tensor([math.sqrt(2.0) if (di and dj) else 1.0
                                  for di, dj in DIRS8],
                                 dtype=torch.float32, device=dev)
    costs = (step_costs[None, :] + yaw_weight
             * torch.abs(deltas.to(torch.float32))[:, None])      # (D, 8)
    ccost = (None if cell_cost is None else
             torch.as_tensor(cell_cost, device=dev).to(torch.float32))
    hi = torch.as_tensor([X - 1, Y - 1], device=dev)
    m_ar = torch.arange(8, device=dev)
    d_ar = torch.arange(D, device=dev)

    b = torch.argmin(dist3[lanes, :, ij[:, 0], ij[:, 1]], dim=1)
    start, b0 = ij, b
    done = torch.zeros(nb, dtype=torch.bool, device=dev)
    steps, bsteps = [], []
    for k in range(max_len - 1):
        if k % _CHECK_EVERY == 0 and host_bool(done.all(),
                                               "wavefront.path3d"):
            break
        here = dist3[lanes, b, ij[:, 0], ij[:, 1]]
        nbr = ij[:, None, :] + dirs                               # (B, 8, 2)
        ok = ((nbr[..., 0] >= 0) & (nbr[..., 0] < X)
              & (nbr[..., 1] >= 0) & (nbr[..., 1] < Y))           # (B, 8)
        nclip = torch.minimum(torch.clamp_min(nbr, 0), hi)
        nbin = torch.remainder(b[:, None, None] + deltas[None, :, None],
                               K).expand(nb, D, 8)                # (B, D, 8)
        ci, cj = nclip[:, None, :, 0], nclip[:, None, :, 1]       # (B, 1, 8)
        child = dist3[lanes[:, None, None], nbin, ci, cj]
        # allowed[d, m] = trans_feas[b, d, m, nclip[m]]
        allowed = trans_feas[b[:, None, None], d_ar[None, :, None],
                             m_ar[None, None, :], ci, cj]
        nd = child + costs + torch.where(allowed & ok[:, None, :], 0.0, INF)
        if ccost is not None:
            nd = nd + ccost[ci, cj]
        j = torch.argmin(nd.reshape(nb, -1), dim=1)
        ndj = torch.gather(nd.reshape(nb, -1), 1, j[:, None])[:, 0]
        dj, mj = j // 8, j % 8
        improves = (ndj < here + 1e-3 + 1e-5 * here) & (ndj < 0.5 * INF)
        at_goal = here <= 0.0
        move = ~done & ~at_goal & improves
        ij = torch.where(move[:, None], nbr[lanes, mj], ij)
        b = torch.where(move, nbin[lanes, dj, mj], b)
        done = done | at_goal | ~improves
        steps.append(ij)
        bsteps.append(b)
    path = _finish_path(steps, start, max_len - 1)
    bins = _finish_path([x[:, None] for x in bsteps], b0[:, None],
                        max_len - 1)[..., 0]
    final = path[:, -1]
    success = dist3[lanes, bins[:, -1], final[:, 0], final[:, 1]] <= 0.0
    return path, bins, _length(path), success


def plan(free, feas, start_ij, goal_ij, max_len: int = 512,
         start_bin: int = 0, device=None) -> WavefrontResult:
    """Full 2-D front end for B scenarios on one map: field, descent,
    DP yaw. free (X, Y) bool (typically feas.any(0)); feas (K, X, Y)."""
    del start_bin  # the DP optimises the whole profile globally
    dist = distance_field(free, goal_ij, device=device)
    path, length, success = extract_path(dist, start_ij, max_len,
                                         device=device)
    yaws = assign_yaws_dp(feas, path, device=device)
    return WavefrontResult(success, path, yaws, length, dist)


def path_to_world(grid, path_ij, yaw_bins, length, yaw_num: int):
    """Host helper for one path: (L, 2) cells + bins -> (length, 3) world
    x, y, yaw (getastarSE3Path's output convention,
    front_end_Astar.hpp:392), yaw unwrapped along the short arc."""
    as_np = lambda a: (a.cpu().numpy() if torch.is_tensor(a)
                       else np.asarray(a))
    path_ij = as_np(path_ij)[:int(length)]
    yaw_bins = as_np(yaw_bins)[:int(length)]
    xy = np.asarray([grid.cube_center((i, j, 0))[:2] for (i, j) in path_ij])
    yaw = np.zeros(len(path_ij))
    acc = 0.0
    prev_b = int(yaw_bins[0]) if len(yaw_bins) else 0
    half = yaw_num // 2
    for i, b in enumerate(yaw_bins):
        dbin = (int(b) - prev_b + half) % yaw_num - half
        acc += dbin * (2.0 * np.pi / yaw_num)
        yaw[i] = acc
        prev_b = int(b)
    return np.concatenate([xy, yaw[:, None]], axis=1)
