"""Numeric parity instruments against the reference pipeline
(svsdf_tpu/planner/parity.py).

1. ``reference_cost`` scores a trajectory on the reference back end's
   exact cost functional (costFunctionLmbmParallel,
   `src/planner_algorithm/include/planner_algorithm/back_end_optimizer.hpp:344-430`):

     J(traj) = minco energy + rho * sum(T)
             + weight_p * sum_obs smoothedL1(safety_hor - SVSDF(p), mu)

   with mu hardcoded 0.01 as in grad_cost_p_sw (:1011).

2. ``reference_mode_plan`` runs the pipeline restricted to the
   reference's algorithmic scope: A* -> mid end -> one back-end solve
   over the AABB-harvested obstacles, with no certify-refine rounds and
   no retry ladder (plan_manager.cpp:96-231). Its map-wide certificate
   measures what the reference's algorithm ships.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from svsdf_tpu_torch.ops import minco
from svsdf_tpu_torch.ops.svsdf import DEFAULT_CONFIG, SVSDFConfig, svsdf_query
from svsdf_tpu_torch.utils import trajectory as trj
from svsdf_tpu_torch.utils.config import PlannerConfig
from svsdf_tpu_torch.utils.transforms import smoothed_l1


class ReferenceCost(NamedTuple):
    energy: float      # minco spline energy
    time: float        # rho * sum(T)
    penalty: float     # weight_p * sum smoothedL1(safety_hor - svsdf)
    total: float
    min_svsdf: float   # min true SVSDF over the obstacle set
    n_active: int      # obstacles with nonzero hinge


def reference_cost(shape, traj: trj.Trajectory, obstacles,
                   cfg: PlannerConfig,
                   svs_cfg: SVSDFConfig = DEFAULT_CONFIG,
                   mu: float = 0.01) -> ReferenceCost:
    """Score one plan's trajectory (a batch of one) on the reference's
    back-end functional. obstacles: (M, >=2) world points; the z/yaw
    component is dropped (back_end_optimizer.hpp:792) and the points are
    float32, as the JAX package takes them. The SVSDF is the true one
    (GSIP interior distance), matching getTrueSDFofSweptVolume<true>
    (:795)."""
    obstacles = torch.as_tensor(np.asarray(obstacles)[:, :2],
                                dtype=torch.float32,
                                device=traj.durations.device)
    with torch.no_grad():
        energy = float(minco.energy(traj)[0])
        time_cost = float(cfg.rho * torch.sum(traj.durations[0]))
        if obstacles.shape[0]:
            res = svsdf_query(shape, traj, obstacles[None], svs_cfg,
                              with_inside=True)
            hinge = smoothed_l1(cfg.safety_hor - res.sdf[0], mu)
            penalty = float(cfg.weight_p * torch.sum(hinge))
            min_sdf = float(torch.min(res.sdf[0]))
            n_active = int(torch.sum(hinge > 0.0))
        else:
            penalty, min_sdf, n_active = 0.0, float("inf"), 0
    return ReferenceCost(energy, time_cost, penalty,
                         energy + time_cost + penalty, min_sdf, n_active)


def reference_mode_plan(planner, start, goal, mid_iters: int = 100,
                        back_iters: int = 200):
    """Run the pipeline restricted to the reference's scope (module
    docstring): one front-end pass, one mid-end solve, one back-end
    solve on the harvested AABB obstacles. Returns a PlanResult whose
    ``certified``/``min_cert_sdf`` report the map-wide certificate the
    reference never computes."""
    from svsdf_tpu_torch.planner import back_end, mid_end
    from svsdf_tpu_torch.planner.pipeline import PlanResult, _rotz

    start, goal = np.asarray(start), np.asarray(goal)
    front = planner.generate_path(start, goal)
    empty = np.zeros((0, 3))
    if not front.success:
        return PlanResult(False, None, None, front.path, empty,
                          float("nan"), float("nan"))
    path = front.path
    q = planner._subsample(path, 3.0)
    if len(q) == 0:
        q = path[len(path) // 2][None]
    obstacles = planner._harvest(q)
    n = len(q) + 1
    head = np.zeros((3, 3))
    tail = np.zeros((3, 3))
    head[0] = path[0]
    tail[0] = path[-1]
    times = np.full(n, planner.config.inittime)
    ref_rots = np.stack([_rotz(w[2]) for w in q])
    mid = mid_end.optimize(head[None], tail[None], q[None], times[None],
                           ref_rots[None], planner.config,
                           max_iters=mid_iters, device=planner.device,
                           dtype=planner.dtype)
    obstacles = planner._pad_obstacles(obstacles)
    back = back_end.optimize(planner.shape, head[None], tail[None],
                             obstacles[None], mid.opt_x, planner.config,
                             planner.svs_cfg, max_iters=back_iters,
                             solver=planner.solver, device=planner.device,
                             dtype=planner.dtype)
    pts, sdf = planner.certify(back.traj)
    min_sdf = float(sdf.min()) if len(sdf) else float("inf")
    return PlanResult(True, back.traj, mid.traj, path, obstacles,
                      float(mid.cost[0]), float(back.cost[0]),
                      certified=(min_sdf > 0.0), min_cert_sdf=min_sdf)
