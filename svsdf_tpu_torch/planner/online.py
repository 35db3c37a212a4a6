"""Online replanner (svsdf_tpu/planner/online.py): per-(map, shape)
device state built once, then each ``replan()`` is one batch-1
``plan_batch_e2e`` call: 3-D transition-checked wavefront front end with
route shaping, arc-length resample, nearest-obstacle harvest, staged
solve, certify-and-refine rounds, and the SVSDF certificate.

The JAX package runs the precompute and every replan under
``jax.default_matmul_precision(matmul_precision)``, "highest" by
default, which keeps the TPU's matrix unit in true float32. Here float32
products are full float32 already (TF32 is off for the whole package),
so the replanner has no such option.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from svsdf_tpu_torch import resolve_device
from svsdf_tpu_torch.models import shapes
from svsdf_tpu_torch.ops import esdf as esdf_ops
from svsdf_tpu_torch.ops import kernels as kops
from svsdf_tpu_torch.parallel import batch as pbatch
from svsdf_tpu_torch.utils import trajectory as trj
from svsdf_tpu_torch.utils.config import PlannerConfig
from svsdf_tpu_torch.utils.gridmap import GridMap


def front_end_maps(shape, occ2d, config: PlannerConfig,
                   yaw_substeps: int = 1, clearance_weight: float = 1.0,
                   tightness_weight: float = 3.0, device=None,
                   dtype=torch.float32):
    """The map products of the 3-D front end for one (map, shape):
    (feas (K, X, Y) bool, trans_feas (K, 5, 8, X, Y) bool, cell_cost
    (X, Y) float32). Stencils and the ESDF are computed in ``dtype``.

    The transition guard box covers the shape at the father pose one
    cell away, and rotations reach +-2 bins per cell move. The cell cost
    shapes the route: clearance (a pure geodesic hugs walls) plus
    tightness (cells where few yaw bins fit are corners the smoothed
    spline cannot realise)."""
    dev = resolve_device(device)
    res = config.occupancy_resolution
    occ2d = torch.as_tensor(np.ascontiguousarray(occ2d), device=dev)
    safemargin = max(config.front_end_safeh, res / 2.0)
    kernels = kops.rasterize_shape_kernels(
        shape, config.kernel_size, config.kernel_yaw_num, res, safemargin,
        yaw_substeps=yaw_substeps, device=dev, dtype=dtype)
    feas = kops.feasibility_maps(occ2d, kernels, device=dev)
    guard = (config.kernel_size // 2 + 2) * res
    stencils = kops.transition_stencils(
        shape, config.kernel_yaw_num, res, guard, n_deltas=5, device=dev,
        dtype=dtype)
    trans_feas = kops.transition_feasibility(occ2d, stencils, device=dev)
    es = esdf_ops.esdf(occ2d, res, device=dev, dtype=dtype)
    d_safe = config.safety_hor + 2.0 * res
    nb = feas.sum(0).to(torch.float32)
    tight = torch.clamp((6.0 - nb) / 6.0, 0.0, 1.0)
    cell_cost = (clearance_weight * torch.clamp_min(1.0 - es / d_safe, 0.0)
                 + tightness_weight * tight).to(torch.float32)
    return feas, trans_feas, cell_cost


class ReplanResult(NamedTuple):
    success: bool            # front end reached the goal
    traj: trj.Trajectory     # optimized trajectory, a batch of one, host
    cost: float
    cert_min: float          # min SVSDF over the harvested obstacles
    obstacles: np.ndarray    # (M, 2) harvested obstacle points


class OnlineReplanner:
    """Holds per-(map, shape) device state; replan() plans one trip.

    Example:
        rp = OnlineReplanner(cfg, map_points)
        res = rp.replan((1.0, 1.0), (20.0, 15.0))
        if res.success and res.cert_min > 0: execute(res.traj)

    ``device=None`` runs on CUDA and raises without it; ``dtype`` is the
    solve's and the precompute's type (the front end's fields stay
    float32).
    """

    def __init__(self, config: PlannerConfig, map_points: np.ndarray,
                 n_pieces: int = 8, n_obs: int = 48,
                 stages: Optional[tuple] = None, iters: int = 50,
                 conservative_yaw_substeps: int = 1,
                 refine_rounds: int = 2, refine_iters: int = 12,
                 refine_esc: float = 4.0,
                 cert_margin: Optional[float] = None,
                 refine_svs_cfg=None,
                 clearance_weight: float = 1.0,
                 tightness_weight: float = 3.0,
                 device=None, dtype=torch.float32):
        self.device = resolve_device(device)
        self.dtype = dtype
        #: wall-clock breakdown of the build, each phase closed by a
        #: device synchronize; the first replan() adds first_replan_s
        self.build_breakdown: dict = {}
        t0 = time.perf_counter()
        self.config = config
        self.n = n_pieces
        self.shape = shapes.shape_from_objpath(config.inputdata,
                                               config.poly_params)
        self.grid = GridMap.from_points(map_points,
                                        config.occupancy_resolution,
                                        config.sta_threshold)
        self.build_breakdown["grid_s"] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()
        self.feas, self.trans_feas, self.cell_cost = front_end_maps(
            self.shape, self.grid.occ2d, config, conservative_yaw_substeps,
            clearance_weight, tightness_weight, self.device, dtype)
        self._sync()
        self.build_breakdown["precompute_s"] = round(
            time.perf_counter() - t0, 1)
        occ = self.grid.occupied_centers_2d()
        if len(occ) == 0:                       # empty map: far dummy
            occ = np.asarray([[1e4, 1e4]], np.float32)
        self.occ_pts = torch.as_tensor(occ, device=self.device)
        self.n_obs = min(n_obs, len(occ))
        self.stages = (stages if stages is not None
                       else pbatch.default_stages_lowlat(iters))
        self.xy_min = torch.as_tensor(self.grid.xyz_min[:2],
                                      dtype=torch.float32, device=self.device)
        self.refine_rounds = refine_rounds
        self.refine_iters = refine_iters
        self.refine_esc = refine_esc
        self.cert_margin = (0.25 * config.safety_hor
                            if cert_margin is None else cert_margin)
        self.refine_svs_cfg = refine_svs_cfg

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _cell(self, p) -> np.ndarray:
        idx = self.grid.grid_index(np.asarray(
            [p[0], p[1], self.grid.xyz_min[2] + 1e-6]))
        return np.asarray(idx[:2], np.int64)

    def replan(self, start_xy, goal_xy) -> ReplanResult:
        first = "first_replan_s" not in self.build_breakdown
        t0 = time.perf_counter()
        s = torch.as_tensor(self._cell(start_xy), device=self.device)[None]
        g = torch.as_tensor(self._cell(goal_xy), device=self.device)[None]
        out = pbatch.plan_batch_e2e(
            self.shape, self.feas, self.occ_pts, s, g, self.config,
            self.stages, self.n, self.n_obs, self.grid.resolution,
            self.xy_min, refine_rounds=self.refine_rounds,
            refine_iters=self.refine_iters, refine_esc=self.refine_esc,
            cert_margin=float(self.cert_margin),
            trans_feas=self.trans_feas, cell_cost=self.cell_cost,
            refine_svs_cfg=self.refine_svs_cfg, device=self.device,
            dtype=self.dtype)
        ok, cost, cert, obstacles, coeffs, durations = (
            t.cpu() for t in (out.front_ok, out.cost, out.cert_min,
                              out.obstacles, out.coeffs, out.durations))
        if first:
            self.build_breakdown["first_replan_s"] = round(
                time.perf_counter() - t0, 1)
        return ReplanResult(bool(ok[0]), trj.Trajectory(coeffs, durations),
                            float(cost[0]), float(cert[0]),
                            obstacles[0].numpy())
