"""The plain reference of the end-to-end path's front end: the map's
occupancy, the robot's yaw stencils and feasibility, and each plan's
route (geodesic field, greedy descent, yaw bins, arc-length resample,
nearest-obstacle harvest), worked out from the benchmark's own point
cloud, independent of the program under test.

The route's integer decisions follow the front end's definition in
float32, the type the configuration gives it: an 8-connected
cost-to-go field with steps of 1 and float32(sqrt 2), relaxed in sweeps
until no cell improves by more than 1e-6; from the start the neighbour of
least (field + step) in the order of ``DIRS`` while it improves on the
cell's own value by the tolerance; yaw bins by a Viterbi pass of least
total circular rotation over the bins feasible at each cell, and the bin
yaws' unwrapping steps. The resample and the harvest are computed in
float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

INF = 1e9
#: 8-neighbourhood (dx, dy) and step costs, in the order ties resolve
DIRS = [(1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (1, -1), (-1, 1),
        (-1, -1)]
COSTS = [1.0] * 4 + [float(np.float32(math.sqrt(2.0)))] * 4


def voxelize(points, res: float, threshold: int):
    """(occupancy (X, Y, Z) bool, xyz_min (3,)): the cloud's bounding box
    from its least corner in cells of ``res``, a cell occupied when it
    holds ``threshold`` points or more (the last cell holds the points on
    the far faces)."""
    lo = points.min(axis=0)
    shape = np.maximum(np.ceil((points.max(axis=0) - lo) / res).astype(int),
                       1)
    idx = np.clip(np.floor((points - lo) / res).astype(int), 0, shape - 1)
    counts = np.zeros(shape, np.int64)
    np.add.at(counts, tuple(idx.T), 1)
    return counts >= threshold, lo


def stencils(body, size: int, yaw_num: int, res: float, margin: float,
             dev):
    """(K, size, size) bool: the cell at offset res * (a - side, b - side)
    lies within ``margin`` of the robot at yaw bin k, yaw 2 pi k / K - pi;
    float32."""
    f32 = torch.float32
    side = (size - 1) // 2
    offs = (torch.arange(size, device=dev) - side).to(f32) * res
    ox, oy = torch.meshgrid(offs, offs, indexing="ij")
    yaw = 2.0 * math.pi * torch.arange(yaw_num, dtype=f32, device=dev) \
        / yaw_num - math.pi
    c, s = torch.cos(yaw)[:, None, None], torch.sin(yaw)[:, None, None]
    return body(c * ox + s * oy, -s * ox + c * oy) <= margin


def feasibility(occ2d, st):
    """(K, X, Y) bool: the robot at (x, y) with yaw bin k covers no
    occupied cell (cells outside the map are free)."""
    k, size, _ = st.shape
    side = (size - 1) // 2
    x, y = occ2d.shape
    pad = np.pad(occ2d.astype(np.int64), side)
    hits = np.zeros((k, x, y), np.int64)
    for a in range(size):
        for b in range(size):
            on = st[:, a, b].astype(np.int64)[:, None, None]
            hits += on * pad[None, a:a + x, b:b + y]
    return hits == 0


def distance_field(free, goals):
    """(S, X, Y) float32 cost-to-go to each goal cell over the free cells
    (INF where unreachable), relaxed until no cell improves by more than
    1e-6."""
    s_, (x, y) = goals.shape[0], free.shape
    lanes = torch.arange(s_, device=free.device)
    d = torch.full((s_, x, y), INF, dtype=torch.float32, device=free.device)
    d[lanes, goals[:, 0], goals[:, 1]] = 0.0
    blocked = torch.where(free, 0.0, INF).to(torch.float32)

    def relax(d):
        pad = F.pad(d, (1, 1, 1, 1), value=INF)
        best = d
        for (dx, dy), c in zip(DIRS, COSTS):
            nb = pad[:, 1 - dx:1 - dx + x, 1 - dy:1 - dy + y]
            best = torch.minimum(best, nb + c + blocked)
        return best

    d = relax(d)
    live = torch.ones(s_, dtype=torch.bool, device=free.device)
    while bool(live.any()):
        d2 = relax(d)
        changed = (d2 < d - 1e-6).reshape(s_, -1).any(dim=1)
        d = torch.where(live[:, None, None], d2, d)
        live = live & changed
    return d


def descend(dist, starts, max_len: int):
    """(path (S, max_len, 2), length (S,), reached (S,)): greedy descent
    of the field from each start, the last cell repeated once stopped."""
    s_, x, y = dist.shape
    dev = dist.device
    lanes = torch.arange(s_, device=dev)
    dirs = torch.as_tensor(DIRS, device=dev)
    costs = torch.as_tensor(COSTS, dtype=torch.float32, device=dev)
    hi = torch.as_tensor([x - 1, y - 1], device=dev)
    ij, done = starts, torch.zeros(s_, dtype=torch.bool, device=dev)
    path = [ij]
    for _ in range(max_len - 1):
        here = dist[lanes, ij[:, 0], ij[:, 1]]
        nbr = ij[:, None] + dirs
        inside = ((nbr >= 0) & (nbr <= hi)).all(-1)
        nc = torch.minimum(torch.clamp_min(nbr, 0), hi)
        nd = torch.where(inside, dist[lanes[:, None], nc[..., 0], nc[..., 1]]
                         + costs, INF)
        j = torch.argmin(nd, dim=1)
        ndj = nd[lanes, j]
        better = (ndj < here + 1e-3 + 1e-5 * here) & (ndj < 0.5 * INF)
        at_goal = here <= 0.0
        move = ~done & ~at_goal & better
        ij = torch.where(move[:, None], nbr[lanes, j], ij)
        done = done | at_goal | ~better
        path.append(ij)
    path = torch.stack(path, 1)
    length = 1 + (path[:, 1:] != path[:, :-1]).any(-1).sum(1)
    end = path[:, -1]
    return path, length, dist[lanes, end[:, 0], end[:, 1]] <= 0.0


def yaw_bins(feas, path):
    """(S, L) yaw bins along each path: the assignment of least total
    circular rotation over the bins feasible at each cell; a cell with no
    feasible bin keeps the previous choice."""
    k = feas.shape[0]
    dev = feas.device
    fp = feas[:, path[..., 0], path[..., 1]].permute(1, 2, 0)    # (S, L, K)
    bins = torch.arange(k, device=dev)
    delta = torch.minimum(torch.remainder(bins[:, None] - bins, k),
                          torch.remainder(bins - bins[:, None], k)).float()
    c = torch.where(fp[:, 0], 0.0, 1e6)
    back = []
    for i in range(1, path.shape[1]):
        f = fp[:, i]
        c_new, prev = torch.min(c[:, :, None] + delta, dim=1)
        c_new = torch.where(f, c_new, 1e6)
        any_f = f.any(dim=1, keepdim=True)
        c = torch.where(any_f, c_new, c)
        back.append(torch.where(any_f, prev, bins))
    b = torch.argmin(c, dim=1)
    lanes = torch.arange(path.shape[0], device=dev)
    out = [b]
    for bp in reversed(back):
        b = bp[lanes, b]
        out.append(b)
    return torch.stack(out[::-1], dim=1)


def resample(path, bins, length, n: int, res: float, xy_min, yaw_num: int):
    """(S, n+1, 3) float64 states evenly spaced by arc length along each
    path's cell centres, yaw unwrapped along it."""
    f64 = torch.float64
    xy = torch.as_tensor(xy_min, dtype=f64, device=path.device) \
        + (path.to(f64) + 0.5) * res
    # bin yaws and their steps in float32, the front end's type: a half
    # turn between neighbours unwraps to +pi or -pi by its rounding there
    yaw = 2.0 * math.pi * bins.to(torch.float32) / yaw_num - math.pi
    dy = torch.remainder(yaw[:, 1:] - yaw[:, :-1] + math.pi,
                         2.0 * math.pi) - math.pi
    yaw, dy = yaw.to(f64), dy.to(f64)
    yaw = torch.cat([yaw[:, :1], yaw[:, :1] + torch.cumsum(dy, 1)], 1)
    seg = (xy[:, 1:] - xy[:, :-1]).norm(dim=-1)
    cum = torch.cat([torch.zeros_like(seg[:, :1]), torch.cumsum(seg, 1)], 1)
    el = path.shape[1]
    total = cum.gather(1, torch.clamp_max(length - 1, el - 1)[:, None])
    t = torch.linspace(0.0, 1.0, n + 1, dtype=f64, device=path.device) * total
    idx = torch.clamp(torch.searchsorted(cum, t, right=True) - 1, 0, el - 2)
    sg = seg.gather(1, idx)
    w = torch.where(sg > 1e-9, (t - cum.gather(1, idx))
                    / sg.clamp_min(1e-9), 0.0).clamp(0.0, 1.0)[..., None]
    take = lambda a, i: a.gather(1, i[..., None].expand(-1, -1, a.shape[-1]))
    pos = take(xy, idx) * (1 - w) + take(xy, idx + 1) * w
    yw = take(yaw[..., None], idx) * (1 - w) + take(yaw[..., None], idx + 1) * w
    return torch.cat([pos, yw], -1)


def harvest_distances(occ_pts, states):
    """(S, Mocc) float64 distance of each occupied cell centre to the
    nearest of a plan's states."""
    d = occ_pts[None, :, None, :] - states[:, None, :, :2]
    return d.norm(dim=-1).amin(dim=2)
