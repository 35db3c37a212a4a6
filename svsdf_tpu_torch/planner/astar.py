"""SE(2) A* front end: a host search over feasibility maps computed on
the device (svsdf_tpu/planner/astar.py, its Python loop).

Re-design of AstarPathSearcher
(`src/planner_algorithm/include/planner_algorithm/front_end_Astar.hpp:
53-420`). The device computes every yaw-bin and transition
feasibility map of the grid once per map and shape (ops/kernels.py);
this module runs a plain heapq A* over them as numpy arrays, with O(1)
lookups per expansion.

Semantics: 8-connected expansion on the z=0 layer, diagonal heuristic
with a 1+1e-3 tie-break (front_end_Astar.hpp:165-183), the yaw chosen
per node at discovery by a BFS over yaw bins from the parent's bin
(checkKernelValue, sw_manager.hpp:1158-1169), the sub-sweep transition
veto after the yaw choice (front_end_Astar.hpp:218-227), and the JAX
package's counter-ordered heap and yaw-change edge cost.

The search runs in the C++ host runtime (native/, csrc/runtime.cpp
``svsdf_astar``: the same semantics, the same path, bins and expansion
count) whenever its library built, as in the JAX package; the Python
loop below is the fallback and the oracle the native route is tested
against.
"""

from __future__ import annotations

import heapq
import math
from typing import NamedTuple, Optional

import numpy as np

from svsdf_tpu_torch import native
from svsdf_tpu_torch.ops.kernels import DIRS8, YAW_BFS_DELTAS, yaw_bin
from svsdf_tpu_torch.utils.gridmap import GridMap


class AstarResult(NamedTuple):
    success: bool
    path: np.ndarray        # (L, 3) world (x, y, yaw)
    yaw_bins: np.ndarray    # (L,)
    expansions: int


def _failed(expansions: int) -> AstarResult:
    return AstarResult(False, np.zeros((0, 3)), np.zeros(0, int),
                       expansions)


def search(grid: GridMap, feas: np.ndarray,
           trans_feas: Optional[np.ndarray], start_w, goal_w, yaw_num: int,
           max_expansions: int = 2_000_000,
           yaw_change_weight: float = 0.1,
           use_native: Optional[bool] = None) -> AstarResult:
    """feas: (K, X, Y) bool (ops.kernels.feasibility_maps, on the host);
    trans_feas: (K, D, 8, X, Y) bool (transition_feasibility) or None to
    skip the sub-sweep veto.

    yaw_change_weight adds a per-bin yaw-change edge cost (the
    reference's getCustomCost hook, front_end_Astar.hpp:186-190, returns
    0; a nonzero value discourages yaw swings between adjacent cells).
    The heuristic ignores yaw, so admissibility holds.

    use_native: run the loop in the C++ runtime when it is available
    (True, or None: the default), or in Python (False); as in the JAX
    package, True without a runtime runs the Python loop."""
    # SE(2) search: only the xy footprint must be in the map (the z slot
    # of start/goal carries yaw downstream, plan_manager.cpp:109-111)
    def _in_xy(p):
        hi = grid.xyz_min[:2] + np.asarray(grid.size[:2]) * grid.resolution
        return bool(np.all(np.asarray(p)[:2] >= grid.xyz_min[:2])
                    and np.all(np.asarray(p)[:2] <= hi))

    if not (_in_xy(start_w) and _in_xy(goal_w)):
        return _failed(0)

    si = grid.grid_index(start_w)[:2]
    gi = grid.grid_index(goal_w)[:2]
    if use_native is not False and native.available():
        cells, expansions = native.astar(
            np.asarray(feas), trans_feas, grid.occ2d, si, gi,
            yaw_bin(yaw_num, 0.0), np.asarray(YAW_BFS_DELTAS, np.int32),
            yaw_change_weight, max_expansions)
        if cells is None:
            return _failed(expansions)
        return _emit_path(grid, cells[:, :2], cells[:, 2], yaw_num,
                          expansions)
    feas = np.asarray(feas)
    if trans_feas is not None:
        trans_feas = np.asarray(trans_feas)
    X, Y = feas.shape[1], feas.shape[2]
    start = (int(si[0]), int(si[1]))
    goal = (int(gi[0]), int(gi[1]))

    occ2d = np.asarray(grid.occ2d)

    g_score = np.full((X, Y), np.inf)
    state = np.zeros((X, Y), dtype=np.int8)   # 0 unseen, 1 open, -1 closed
    yaw_bins = np.full((X, Y), -1, dtype=np.int32)
    parent = np.full((X, Y, 2), -1, dtype=np.int32)

    def heu(a):
        d = (abs(a[0] - goal[0]), abs(a[1] - goal[1]), 0)
        dmin, dmax = min(d), max(d)
        dmid = sum(d) - dmin - dmax
        h = (math.sqrt(3) * dmin + math.sqrt(2) * (dmid - dmin)
             + (dmax - dmid))
        return h * (1.0 + 1e-3)

    start_bin = yaw_bin(yaw_num, 0.0)
    g_score[start] = 0.0
    yaw_bins[start] = start_bin
    state[start] = 1
    counter = 0
    open_heap = [(heu(start), counter, start)]
    expansions = 0

    while open_heap:
        _, _, cur = heapq.heappop(open_heap)
        if state[cur] == -1:
            continue
        state[cur] = -1
        if cur == goal:
            return _backtrack(grid, parent, yaw_bins, cur, yaw_num,
                              expansions)
        expansions += 1
        if expansions > max_expansions:
            break
        cg = g_score[cur]
        fbin = int(yaw_bins[cur])
        for dir_idx, (di, dj) in enumerate(DIRS8):
            ni, nj = cur[0] + di, cur[1] + dj
            if ni < 0 or nj < 0 or ni >= X or nj >= Y:
                continue
            if occ2d[ni, nj]:
                continue
            if state[ni, nj] == -1:
                continue
            # yaw-bin BFS from the father's bin; first feasible wins
            cbin = -1
            delta_idx = -1
            for k, dlt in enumerate(YAW_BFS_DELTAS):
                b = (fbin + dlt) % yaw_num
                if feas[b, ni, nj]:
                    cbin = b
                    delta_idx = k
                    break
            if cbin < 0:
                continue
            # sub-swept-volume transition veto with the chosen yaw
            if trans_feas is not None and not trans_feas[
                    fbin, delta_idx, dir_idx, ni, nj]:
                continue
            dbin = abs(YAW_BFS_DELTAS[delta_idx])
            tg = (cg + math.sqrt(di * di + dj * dj)
                  + yaw_change_weight * dbin)
            if tg < g_score[ni, nj]:
                g_score[ni, nj] = tg
                parent[ni, nj] = cur
                # the bin tracks the winning parent: the veto and the
                # yaw-change cost above were evaluated for cbin
                yaw_bins[ni, nj] = cbin
                state[ni, nj] = 1
                counter += 1
                heapq.heappush(open_heap,
                               (tg + heu((ni, nj)), counter, (ni, nj)))

    return _failed(expansions)


def _emit_path(grid, cells_ij, cell_bins, yaw_num, expansions
               ) -> AstarResult:
    """Cells + per-cell yaw bins -> world path with unwrapped yaw."""
    L = len(cells_ij)
    path = np.zeros((L, 3))
    bins = np.zeros(L, dtype=int)
    yaw = 0.0
    prev_b = int(cell_bins[0])
    for i in range(L):
        center = grid.cube_center((int(cells_ij[i][0]),
                                   int(cells_ij[i][1]), 0))
        b = int(cell_bins[i])
        dbin = (b - prev_b + yaw_num // 2) % yaw_num - yaw_num // 2
        yaw += dbin * (2.0 * math.pi / yaw_num)
        path[i, :2] = center[:2]
        path[i, 2] = yaw
        bins[i] = b
        prev_b = b
    return AstarResult(True, path, bins, expansions)


def _backtrack(grid, parent, yaw_bins, cur, yaw_num, expansions):
    # Yaw along the path is unwrapped by _emit_path (short-arc
    # accumulation): yaw is an R^3 spline coordinate downstream, so
    # consecutive values differ by the physical rotation, never by a jump
    # across the +-pi seam (the reference emits raw bin yaws,
    # front_end_Astar.hpp:380-382; start keeps yaw = 0.0, :293).
    cells = [cur]
    while tuple(parent[cells[-1]]) != (-1, -1):
        cells.append(tuple(parent[cells[-1]]))
    cells.reverse()
    bins = np.asarray([int(yaw_bins[c]) for c in cells])
    return _emit_path(grid, np.asarray(cells), bins, yaw_num, expansions)
