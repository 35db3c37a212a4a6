"""Single-plan planning pipeline: map -> A* -> mid end -> SVSDF back end
-> map-wide certify-and-refine -> retry ladder
(svsdf_tpu/planner/pipeline.py).

Re-design of PlannerManager
(`src/plan_manager/src/plan_manager.cpp:47-231`): owns the shape, the
occupancy map and the feasibility maps, and drives generatePath (:96) /
generateTraj (:128) on each (start, goal) request.

The feasibility and transition maps, the mid and back ends and the
certificate run on ``device`` (None: CUDA, raising without it) in
``dtype``, the port's counterpart of the JAX package's x64 switch
(float32 is the JAX default; the tests pass float64 against JAX under
x64). The A* search, the waypoint subsample and the obstacle harvest
run on the host. The shape's one-shot rasterizations (yaw kernels,
transition stencils) go through the disk memo (utils/cache.py), keyed on
the shape, the geometry knobs, the dtype and the device type.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from svsdf_tpu_torch import resolve_device
from svsdf_tpu_torch.models import shapes
from svsdf_tpu_torch.ops import kernels as kops
from svsdf_tpu_torch.ops.svsdf import DEFAULT_CONFIG, SVSDFConfig, svsdf_query
from svsdf_tpu_torch.planner import astar, back_end, mid_end
from svsdf_tpu_torch.utils import cache
from svsdf_tpu_torch.utils import trajectory as trj
from svsdf_tpu_torch.utils.config import PlannerConfig
from svsdf_tpu_torch.utils.debugbus import BUS
from svsdf_tpu_torch.utils.gridmap import GridMap


class PlanResult(NamedTuple):
    success: bool
    traj: Optional[trj.Trajectory]       # final trajectory, a batch of one
    mid_traj: Optional[trj.Trajectory]   # warm-start trajectory
    astar_path: np.ndarray               # (L, 3)
    obstacles: np.ndarray                # (M, 3) harvested SVSDF points
    mid_cost: float
    final_cost: float
    #: map-wide certificate: True iff every occupied voxel near the
    #: trajectory has positive swept-volume SDF (min_cert_sdf > 0).
    #: False for an unexamined (e.g. failed) plan.
    certified: bool = False
    min_cert_sdf: float = float("nan")
    #: per-stage wall-clock breakdown of the winning attempt (front_s,
    #: mid_s, back_s, certify_s, refine_rounds, n_obstacles) plus the
    #: plan-level counters plan() adds (attempts)
    timings: Optional[dict] = None


class Planner:
    """Holds per-(map, shape) state; plan() runs the full pipeline."""

    def __init__(self, config: PlannerConfig, map_points: np.ndarray,
                 svs_cfg: SVSDFConfig = DEFAULT_CONFIG,
                 use_transition_check: bool = True,
                 conservative_yaw_substeps: int = 1,
                 fine_yaw_factor: int = 2,
                 solver: str = "lbfgs",
                 shape: Optional[shapes.Shape2D] = None,
                 device=None, dtype=torch.float32):
        back_end.check_solver(solver)
        self.device = resolve_device(device)
        self.dtype = dtype
        self.config = config
        self.svs_cfg = svs_cfg
        #: back-end nonsmooth solver: "lbfgs" (weak-Wolfe L-BFGS) or
        #: "lmbm" (the reference's bundle method, utils/lmbm.py)
        self.solver = solver
        #: last-resort retry rung: rebuild the planner with
        #: kernel_yaw_num * factor for factor in (fine_yaw_factor,
        #: fine_yaw_factor**2) when every attempt of the standard ladder
        #: leaves the trajectory uncertified (<= 1 disables). Finer bins
        #: give A* yaw options a big or long thin shape can follow.
        self._fine_yaw_factor = max(int(fine_yaw_factor), 0)
        self._map_points = np.asarray(map_points)
        self._yaw_substeps = conservative_yaw_substeps
        self._fine_planners: dict = {}
        self._memo_cache: dict = {}
        #: an explicit shape overrides config.inputdata: a deformable robot
        #: (ScaledShape) rasterizes its front-end kernels at kernel_scale,
        #: and every SVSDF query sees its time-varying scale
        self.shape = shape if shape is not None else \
            shapes.shape_from_objpath(config.inputdata, config.poly_params)
        self._memo_prefix = cache.memo_prefix(self.shape)
        self.grid = GridMap.from_points(
            map_points, config.occupancy_resolution, config.sta_threshold)
        # yaw-bin feasibility of the map, on the device
        safemargin = max(config.front_end_safeh,
                         config.occupancy_resolution / 2.0)
        self._kernels = self._memo(
            f"kern:{config.kernel_size}:{config.kernel_yaw_num}:"
            f"{config.occupancy_resolution}:{safemargin}:"
            f"{conservative_yaw_substeps}",
            lambda: kops.rasterize_shape_kernels(
                self.shape, config.kernel_size, config.kernel_yaw_num,
                config.occupancy_resolution, safemargin,
                yaw_substeps=conservative_yaw_substeps, device=self.device,
                dtype=dtype))
        self._occ2d_dev = torch.as_tensor(
            np.ascontiguousarray(self.grid.occ2d), device=self.device)
        self.feas = self._feasibility(self._occ2d_dev, self._kernels)
        if use_transition_check:
            # guard ladder: the exact full-footprint guard first (keeps
            # warm starts continuously feasible); if A* finds no path —
            # big shapes whose bin sweeps are too fat for the corridor —
            # fall back to looser guards, ending at the reference's
            # +-2 m box (front_end_Astar.hpp:68,222)
            full = (config.kernel_size // 2 + 2) * \
                config.occupancy_resolution
            self.guard_ladder = [g for g in (full, 4.0, 2.0) if g <= full]
            if self.guard_ladder[-1] != 2.0:
                self.guard_ladder.append(2.0)
        else:
            self.guard_ladder = [None]
        self._trans_feas_cache = {}
        #: kernel bounding box, bdx = kernel_size * resolution
        #: (plan_manager.cpp:57-59)
        self.bd = config.kernel_size * config.occupancy_resolution

    # -- precompute memoization ---------------------------------------------

    def _memo(self, key: str, fn):
        """A one-shot precompute of the shape, once per planner: from the
        disk memo (utils/cache.py), keyed on the shape's identity and the
        precompute's code (``cache.memo_prefix``), ``key``, the dtype and
        the device type, as a tensor on the device. A shape without a
        stable identity (a time-varying scale callable) computes in-process
        only."""
        if key not in self._memo_cache:
            if self._memo_prefix is None:
                val = fn()
            else:
                val = torch.as_tensor(cache.memoize_npz(
                    f"{self._memo_prefix}|{key}|{self.dtype}|"
                    f"{self.device.type}", lambda: fn().cpu().numpy()),
                    device=self.device)
            self._memo_cache[key] = val
        return self._memo_cache[key]

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _feasibility(self, occ2d_dev, kernels) -> np.ndarray:
        return kops.feasibility_maps(occ2d_dev, kernels,
                                     device=self.device).cpu().numpy()

    # -- front end ---------------------------------------------------------

    def _stencils(self, guard):
        if guard not in self._trans_feas_cache:
            self._trans_feas_cache[guard] = self._memo(
                f"trans:{self.config.kernel_yaw_num}:"
                f"{self.config.occupancy_resolution}:{guard}",
                lambda: kops.transition_stencils(
                    self.shape, self.config.kernel_yaw_num,
                    self.config.occupancy_resolution,
                    guard_half_world=guard, device=self.device,
                    dtype=self.dtype))
        return self._trans_feas_cache[guard]

    def _trans_feas(self, guard, occ2d_dev=None):
        if guard is None:
            return None
        if occ2d_dev is None:            # cache the default-map result
            key = ("tf", guard)
            if key not in self._trans_feas_cache:
                self._trans_feas_cache[key] = kops.transition_feasibility(
                    self._occ2d_dev, self._stencils(guard),
                    device=self.device).cpu().numpy()
            return self._trans_feas_cache[key]
        return kops.transition_feasibility(
            occ2d_dev, self._stencils(guard),
            device=self.device).cpu().numpy()

    def _conservative_feas(self, occ2d_dev=None):
        """Feasibility maps from conservative (yaw-range-union) kernels;
        rasterized lazily and cached for the default map."""
        if getattr(self, "_cons_kernels", None) is None:
            cfg = self.config
            safemargin = max(cfg.front_end_safeh,
                             cfg.occupancy_resolution / 2.0)
            self._cons_kernels = self._memo(
                f"kern:{cfg.kernel_size}:{cfg.kernel_yaw_num}:"
                f"{cfg.occupancy_resolution}:{safemargin}:5",
                lambda: kops.rasterize_shape_kernels(
                    self.shape, cfg.kernel_size, cfg.kernel_yaw_num,
                    cfg.occupancy_resolution, safemargin, yaw_substeps=5,
                    device=self.device, dtype=self.dtype))
        if occ2d_dev is None:
            if getattr(self, "_cons_feas_cache", None) is None:
                self._cons_feas_cache = self._feasibility(
                    self._occ2d_dev, self._cons_kernels)
            return self._cons_feas_cache
        return self._feasibility(occ2d_dev, self._cons_kernels)

    def generate_path(self, start, goal, occ2d_dev=None,
                      conservative: bool = False) -> astar.AstarResult:
        """A* over the guard ladder. occ2d_dev optionally overrides the
        2-D occupancy slice (the homotopy retry blocks the cells an
        earlier attempt could not clear); conservative switches to
        yaw-range-union kernels, feasible for every yaw in each bin."""
        if conservative:
            feas = self._conservative_feas(occ2d_dev)
        elif occ2d_dev is None:
            feas = self.feas
        else:
            feas = self._feasibility(occ2d_dev, self._kernels)
        res = None
        for guard in self.guard_ladder:
            res = astar.search(self.grid, feas,
                               self._trans_feas(guard, occ2d_dev),
                               np.asarray(start), np.asarray(goal),
                               self.config.kernel_yaw_num)
            if res.success:
                return res
        return res

    # -- waypoint subsampling + obstacle harvest ---------------------------

    def _subsample(self, path: np.ndarray, parlength: float = 3.0):
        """Waypoint subsample every index_gap (generateTraj,
        plan_manager.cpp:130-144; traj_parlength = 3.0, :75)."""
        res = self.grid.resolution
        path_size = len(path)
        gap = math.ceil(parlength / res)
        while gap >= path_size - 1 and gap > 1:
            parlength /= 1.5
            gap = math.ceil(parlength / res)
        return path[gap:path_size - 1:gap]

    def _harvest(self, waypoints: np.ndarray) -> np.ndarray:
        """Obstacle voxel centers in AABBs around the waypoints
        (plan_manager.cpp:156-175: half extents bd/3 on each axis,
        centered at the raw (x, y, yaw) waypoint)."""
        return self.grid.harvest_along_path(waypoints, self.bd / 3.0)

    # -- collision certificate ---------------------------------------------

    @property
    def _occ_pts(self) -> np.ndarray:
        """World xy centers of every occupied z=0 voxel (cached)."""
        if getattr(self, "_occ_pts_cache", None) is None:
            ii, jj = np.nonzero(self.grid.occ2d)
            self._occ_pts_cache = np.stack([
                self.grid.xyz_min[0] + (ii + 0.5) * self.grid.resolution,
                self.grid.xyz_min[1] + (jj + 0.5) * self.grid.resolution,
            ], axis=-1) if len(ii) else np.zeros((0, 2))
        return self._occ_pts_cache

    def certify(self, traj: trj.Trajectory):
        """Map-wide swept-volume collision certificate: the SVSDF of
        every occupied 2-D voxel centre within the trajectory's bounding
        box (inflated by the kernel half-extent + safety horizon).

        Returns (points (M, 2), sdf (M,)) on the host; min(sdf) > 0
        certifies the trajectory collision-free against the whole map.
        The query runs once on float32 points padded to a power-of-two
        bucket (at least 512) with far-away dummies."""
        pts = self._occ_pts
        if len(pts) == 0:
            return np.zeros((0, 2)), np.zeros((0,))
        # restrict to the trajectory's reachable band
        ts = np.linspace(0.0, float(traj.total_duration[0]), 64)
        ts_t = torch.as_tensor(ts, dtype=traj.durations.dtype,
                               device=traj.durations.device)[None]
        xy = trj.pos(traj, ts_t)[0, :, :2].cpu().numpy()
        margin = self.bd / 2.0 + self.config.safety_hor + 1.0
        lo, hi = xy.min(0) - margin, xy.max(0) + margin
        keep = np.all((pts >= lo) & (pts <= hi), axis=1)
        pts = pts[keep]
        m = len(pts)
        if m == 0:
            return np.zeros((0, 2)), np.zeros((0,))
        bucket = max(512, 1 << (m - 1).bit_length())
        pad = np.full((bucket - m, 2), 1.0e4)
        padded = torch.as_tensor(np.concatenate([pts, pad]),
                                 dtype=torch.float32,
                                 device=traj.durations.device)[None]
        sdf = svsdf_query(self.shape, traj, padded, self.svs_cfg,
                          with_inside=False).sdf
        return pts, sdf[0].cpu().numpy()[:m]

    def _pad_obstacles(self, obs: np.ndarray, bucket: int = 256,
                       headroom: int = 0) -> np.ndarray:
        """Pad the obstacle set to the next bucket multiple with far-away
        dummy points (zero penalty). ``headroom`` pre-sizes for the
        certify-refine rounds' growth; the size is kept as a monotone
        per-planner floor, so every re-solve of a plan sees one obstacle
        count."""
        m = len(obs)
        target = ((m + headroom + bucket - 1) // bucket) * bucket
        target = max(target, getattr(self, "_obs_bucket_floor", 0))
        self._obs_bucket_floor = target
        if target == m:
            return obs
        pad = np.tile(np.asarray([[1e4, 1e4, 0.0]]), (target - m, 1))
        return np.concatenate([obs, pad[:, :obs.shape[1]]], axis=0)

    # -- full pipeline -----------------------------------------------------

    def plan(self, start, goal, mid_iters: int = 100,
             back_iters: int = 200, certify_rounds: int = 2,
             max_active_add: int = 512,
             certify_retries: int = 3,
             parlength: float = 3.0) -> PlanResult:
        """Full pipeline with map-wide certification and a retry ladder
        when the certify-and-refine rounds leave the trajectory sweeping
        occupied voxels:

          attempt 0  as configured (reference-parity pipeline)
          attempt 1  waypoint spacing / 3, same corridor (more yaw
                     control to thread a tight corridor)
          attempt 2+ additionally block the violated cells in the
                     occupancy slice, forcing A* into another homotopy
                     class
          last       conservative front end: yaw-range-union kernels on
                     the unblocked map
          then       the fine-yaw planners (kernel_yaw_num * factor)

        Returns the best attempt; ``certified``/``min_cert_sdf`` report
        the map-wide certificate."""
        best = None
        occ2d_dev = None
        pl = parlength
        stopped = False
        n_attempts = 1 + max(certify_retries, 0)
        attempt = -1
        attempt_log = []   # per-rung wall/outcome breakdown (timings)
        while attempt + 1 < n_attempts:
            attempt += 1
            if attempt > 0 and BUS.stop_requested:
                # debug_cmd early exit: best so far. One-shot: consume
                # the request so it cannot degrade every later plan, and
                # skip the fine-yaw escalation below
                BUS.clear_stop()
                stopped = True
                break
            conservative = (n_attempts >= 3
                            and attempt == n_attempts - 1)
            res = self._attempt(start, goal,
                                None if conservative else occ2d_dev,
                                mid_iters, back_iters, certify_rounds,
                                max_active_add,
                                # the conservative corridor is feasible at
                                # pose level: standard spacing suffices
                                parlength if conservative else pl,
                                conservative=conservative)
            n_attempts_run = attempt + 1
            attempt_log.append({
                "rung": ("conservative" if conservative else attempt),
                **{k: v for k, v in (res.timings or {}).items()},
                "success": bool(res.success),
                "certified": bool(res.certified),
                "min_cert_sdf": (round(res.min_cert_sdf, 3)
                                 if math.isfinite(res.min_cert_sdf)
                                 else None)})
            if not res.success:
                # a failed front end must not gate the later rungs: the
                # conservative rung plans on the unblocked map
                if best is None:
                    best = res
                if not conservative and occ2d_dev is None:
                    # the search is deterministic: rerunning the same
                    # inputs fails the same way, so jump to the
                    # conservative rung (or give up without one)
                    if n_attempts >= 3:
                        attempt = n_attempts - 2
                    else:
                        break
                continue
            if res.certified or math.isnan(res.min_cert_sdf):
                return _stamp_attempts(res, n_attempts_run, attempt_log)
            if best is None or res.min_cert_sdf > best.min_cert_sdf:
                best = res
            if attempt == n_attempts - 1:
                break
            if attempt == 0:
                pl = pl / 3.0        # attempt 1: same corridor, denser
                continue
            # attempt >= 2: block the violated voxels (plus a one-cell
            # dilation) and let A* find another homotopy class, reusing
            # the certificate _attempt's refine loop already computed
            cached = getattr(self, "_last_cert", None)
            if cached is not None:
                pts, sdf = cached
            else:
                pts, sdf = self.certify(res.traj)
            viol = pts[sdf < 0.0]
            if len(viol) == 0:
                break
            occ = (self._occ2d_dev if occ2d_dev is None
                   else occ2d_dev).cpu().numpy().copy()
            ij = np.round((viol - self.grid.xyz_min[None, :2])
                          / self.grid.resolution - 0.5).astype(np.int64)
            for di in (-1, 0, 1):
                for dj in (-1, 0, 1):
                    ii = np.clip(ij[:, 0] + di, 0, occ.shape[0] - 1)
                    jj = np.clip(ij[:, 1] + dj, 0, occ.shape[1] - 1)
                    occ[ii, jj] = 1
            occ2d_dev = torch.as_tensor(occ, device=self.device)
        # last rung: the whole ladder left the best trajectory
        # uncertified — retry at escalating yaw discretizations
        if self._fine_yaw_factor > 1 and not stopped:
            f = self._fine_yaw_factor
            for factor in (f, f * f):
                if best is not None and best.certified:
                    break
                if factor == f * f and (best is None or not best.success):
                    break   # nothing plannable at factor f either
                fine = self._get_fine_planner(factor)
                t_fine = time.time()
                res = fine.plan(start, goal, mid_iters=mid_iters,
                                back_iters=back_iters,
                                certify_rounds=certify_rounds,
                                max_active_add=max_active_add,
                                certify_retries=certify_retries,
                                parlength=parlength)
                attempt_log.append({
                    "rung": f"fine_yaw_x{factor}",
                    "wall_s": round(time.time() - t_fine, 2),
                    "success": bool(res is not None and res.success),
                    "certified": bool(res is not None and res.certified)})
                if res is not None and res.success and (
                        best is None
                        or not best.success
                        or res.certified
                        or (math.isfinite(res.min_cert_sdf)
                            and not (res.min_cert_sdf
                                     <= best.min_cert_sdf))):
                    best = res
        return _stamp_attempts(best, attempt + 1, attempt_log) \
            if best is not None else best

    def _get_fine_planner(self, factor: int) -> "Planner":
        """Build (once) the fine-yaw retry planner: same map and config
        with kernel_yaw_num * factor, its own rung disabled."""
        if factor not in self._fine_planners:
            cfg = dataclasses.replace(
                self.config,
                kernel_yaw_num=self.config.kernel_yaw_num * factor)
            self._fine_planners[factor] = Planner(
                cfg, self._map_points, svs_cfg=self.svs_cfg,
                use_transition_check=self.guard_ladder != [None],
                conservative_yaw_substeps=self._yaw_substeps,
                fine_yaw_factor=0, solver=self.solver, shape=self.shape,
                device=self.device, dtype=self.dtype)
        return self._fine_planners[factor]

    def _attempt(self, start, goal, occ2d_dev, mid_iters, back_iters,
                 certify_rounds, max_active_add,
                 parlength: float = 3.0,
                 conservative: bool = False) -> PlanResult:
        self._last_cert = None
        tm = {"front_s": 0.0, "mid_s": 0.0, "back_s": 0.0,
              "certify_s": 0.0, "refine_rounds": 0}
        t0 = time.time()
        front = self.generate_path(np.asarray(start), np.asarray(goal),
                                   occ2d_dev=occ2d_dev,
                                   conservative=conservative)
        tm["front_s"] = round(time.time() - t0, 2)
        empty = np.zeros((0, 3))
        if not front.success:
            return PlanResult(False, None, None, front.path, empty,
                              float("nan"), float("nan"), timings=tm)
        path = front.path
        q = self._subsample(path, parlength)
        if len(q) == 0:
            q = path[len(path) // 2][None]   # degenerate short path
        obstacles = self._harvest(q)

        n = len(q) + 1
        head = np.zeros((3, 3))
        tail = np.zeros((3, 3))
        head[0] = path[0]
        tail[0] = path[-1]
        # pin the continuous endpoints: xy from the requested start /
        # goal, yaw from the A* path's unwrapped endpoint yaw (the
        # reference snaps both to A* cell centers, plan_manager.cpp:
        # 143-147); the certificate and the ladder still guard the sweep
        head[0, :2] = np.asarray(start, float)[:2]
        tail[0, :2] = np.asarray(goal, float)[:2]
        times = np.full(n, self.config.inittime)
        ref_rots = np.stack([_rotz(w[2]) for w in q])

        t0 = time.time()
        mid = mid_end.optimize(head[None], tail[None], q[None],
                               times[None], ref_rots[None], self.config,
                               max_iters=mid_iters, device=self.device,
                               dtype=self.dtype)
        self._sync()
        tm["mid_s"] = round(time.time() - t0, 2)
        mid_cost = float(mid.cost[0])

        if len(obstacles) == 0:
            # nothing harvested near the corridor: certify the mid-end
            # trajectory map-wide; on violation fall through to the back
            # end with the violators as the obstacle set
            t0 = time.time()
            pts, sdf = self.certify(mid.traj)
            tm["certify_s"] += round(time.time() - t0, 2)
            self._last_cert = (pts, sdf)
            if len(pts) == 0 or not np.any(sdf < 0.5 *
                                           self.config.safety_hor):
                m = float(sdf.min()) if len(sdf) else float("inf")
                return PlanResult(True, mid.traj, mid.traj, path,
                                  obstacles, mid_cost, mid_cost,
                                  certified=True, min_cert_sdf=m,
                                  timings=tm)
            bad = sdf < 0.5 * self.config.safety_hor
            obstacles = np.concatenate(
                [pts[bad], np.zeros((int(bad.sum()), 1))], axis=1)

        obstacles = self._pad_obstacles(obstacles, headroom=max_active_add)
        t0 = time.time()
        back = self._back_end(head, tail, obstacles, mid.opt_x, back_iters)
        self._sync()
        tm["back_s"] = round(time.time() - t0, 2)

        # certify-and-refine (active-set expansion): every round
        # re-checks the whole map, adds the worst violating / near-active
        # voxels to the obstacle set, escalates the penalty weight and
        # the margin, and re-solves warm-started
        cfg = self.config
        weight_p, safety_hor = cfg.weight_p, cfg.safety_hor
        min_sdf = float("inf")
        prev_min = None
        budget = certify_rounds
        round_ = 0
        while True:
            t0 = time.time()
            pts, sdf = self.certify(back.traj)
            tm["certify_s"] += round(time.time() - t0, 2)
            self._last_cert = (pts, sdf)   # reused by plan()'s retry
            if BUS.stop_requested and round_ > 0:
                min_sdf = float(sdf.min()) if len(sdf) else float("inf")
                BUS.clear_stop()           # one-shot consume
                break
            min_sdf = float(sdf.min()) if len(sdf) else float("inf")
            if len(pts) == 0 or not np.any(sdf < 0.0):
                break                      # collision-free: done
            if round_ == budget:
                # near-miss extension: the equilibrium settled a few cm
                # inside the boundary; extra warm-started rounds are
                # cheaper than the next retry rung
                if -0.15 < min_sdf < 0.0 and budget < certify_rounds + 3:
                    budget += 1
                else:
                    break                  # out of refine budget
            bad = sdf < 0.5 * safety_hor
            order = np.argsort(sdf[bad])[:max_active_add]
            add = np.concatenate(
                [pts[bad][order], np.zeros((len(order), 1))], axis=1)
            merged = np.concatenate([obstacles, add], axis=0)
            # dedup on voxel identity so repeat rounds don't grow the set
            key = np.round(merged[:, :2] / self.grid.resolution).astype(
                np.int64)
            _, uniq = np.unique(key, axis=0, return_index=True)
            obstacles = self._pad_obstacles(merged[np.sort(uniq)])
            weight_p = weight_p * 4.0
            safety_hor = safety_hor + 0.1
            warm_x = back.opt_x
            # stalled-equilibrium escape: when an extension round fails
            # to improve min_sdf, push the nearest waypoints along the
            # violated voxel's swept-SDF gradient before re-solving
            stalled = (round_ >= certify_rounds and prev_min is not None
                       and min_sdf <= prev_min + 0.01)
            prev_min = min_sdf
            if stalled and math.isfinite(min_sdf):
                warm_x = self._nudge_waypoints(
                    warm_x[0].cpu().numpy(), back.traj,
                    pts[int(np.argmin(sdf))], -min_sdf + 0.1, n)[None]
            t0 = time.time()
            back = self._back_end(head, tail, obstacles, warm_x,
                                  back_iters, weight_p=weight_p,
                                  safety_hor=safety_hor,
                                  mu_schedule=(0.1, 0.01))
            self._sync()
            tm["back_s"] += round(time.time() - t0, 2)
            round_ += 1
        tm["refine_rounds"] = round_
        tm["n_obstacles"] = int(len(obstacles))
        return PlanResult(True, back.traj, mid.traj, path, obstacles,
                          mid_cost, float(back.cost[0]),
                          certified=(min_sdf > 0.0),
                          min_cert_sdf=min_sdf, timings=tm)

    def _back_end(self, head, tail, obstacles, warm_x, max_iters, **kw):
        return back_end.optimize(self.shape, head[None], tail[None],
                                 obstacles[None], warm_x, self.config,
                                 self.svs_cfg, max_iters=max_iters,
                                 solver=self.solver, device=self.device,
                                 dtype=self.dtype, **kw)

    def _nudge_waypoints(self, x: np.ndarray, traj, worst_pt,
                         push: float, n: int) -> np.ndarray:
        """Shift the waypoints nearest to the worst violated voxel along
        -(swept-SDF gradient) by ``push`` (Gaussian falloff with
        distance), escaping penalty equilibria the warm start keeps
        re-converging to. x is one plan's decision vector
        [tau (n); waypoints ((n-1)*3)]; returns a new one."""
        x = np.array(x, copy=True)
        q = svsdf_query(self.shape, traj, torch.as_tensor(
            np.asarray(worst_pt)[None, None, :2], dtype=torch.float32,
            device=traj.durations.device), self.svs_cfg)
        g = q.grad_world[0, 0].cpu().numpy()
        norm = float(np.linalg.norm(g))
        if not (np.isfinite(norm) and norm > 1e-6):
            return x
        delta = -(g / norm) * push
        wps = x[n:].reshape(n - 1, 3)
        d = np.linalg.norm(wps[:, :2] - np.asarray(worst_pt)[None, :2],
                           axis=1)
        w = np.exp(-(d / max(self.bd / 3.0, 1.0)) ** 2)
        wps[:, 0] += delta[0] * w
        wps[:, 1] += delta[1] * w
        return x


def _stamp_attempts(res: PlanResult, n: int,
                    attempt_log: list | None = None) -> PlanResult:
    tm = {**(res.timings or {}), "attempts": n}
    if attempt_log and len(attempt_log) > 1:
        tm["attempt_log"] = attempt_log
    return res._replace(timings=tm)


def _rotz(yaw: float) -> np.ndarray:
    c, s = math.cos(yaw), math.sin(yaw)
    return np.asarray([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
