"""Mid-end warm-start trajectory optimizer, MINCO + L-BFGS
(svsdf_tpu/planner/mid_end.py), batched over plans.

Re-design of OriTraj (`src/planner_algorithm/include/planner_algorithm/
mid_end.hpp` + `mid_end.cpp`): given the A* path's subsampled waypoints
Q and initial piece times, minimize

  cost = spline energy
       + rho_mid_end * sum(T)
       + weight_pr * sum_i ||junction_i - Q_i||^3        (waypoint pull)
       + integral( weight_v * L1s(|vel|^2 - vmax^2)
                 + weight_omg * L1s(|omg|^2 - omgmax^2)
                 + WC2-windowed weight_ar * L1s(attitude) ) dt

over x = (tau, xi) with T = forward_t(tau). The cost is one torch
function of x (B, 4N-3), differentiated by autograd.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from svsdf_tpu_torch import resolve_device
from svsdf_tpu_torch.ops import flatness, minco
from svsdf_tpu_torch.utils import lbfgs
from svsdf_tpu_torch.utils import trajectory as trj
from svsdf_tpu_torch.utils.config import PlannerConfig
from svsdf_tpu_torch.utils.transforms import (backward_t, forward_t,
                                              safe_norm, smoothed_l1)


def wc2(x):
    """C^1 window on [-1, 1] (WC2, mid_end.hpp:418-434)."""
    zero = torch.zeros_like(x)
    return torch.where(
        x < -1.0, zero,
        torch.where(x < -0.5, 2.0 * trj.ipow(x + 1.0, 2),
                    torch.where(x < 0.5, 1.0 - 2.0 * x * x,
                                torch.where(x < 1.0,
                                            2.0 * trj.ipow(x - 1.0, 2),
                                            zero))))


class MidEndProblem(NamedTuple):
    head: torch.Tensor        # (B, 3, 3) rows pos/vel/acc
    tail: torch.Tensor        # (B, 3, 3)
    ref_points: torch.Tensor  # (B, N-1, 3) A* waypoints Q
    ref_rots: torch.Tensor    # (B, N-1, 3, 3) attitude references


def attitude_cost(quat, rot_ref):
    """Attitude attraction 6 - 2*tr(R_ref^T R(q)) expanded in quaternion
    components (costaltitude, mid_end.hpp:374-392). quat (..., 4) wxyz,
    rot_ref (..., 3, 3); zero iff R(q) == R_ref."""
    w, x, y, z = (quat[..., 0], quat[..., 1], quat[..., 2],
                  quat[..., 3])
    a0, a1, a2 = (rot_ref[..., 0, 0], rot_ref[..., 0, 1],
                  rot_ref[..., 0, 2])
    b0, b1, b2 = (rot_ref[..., 1, 0], rot_ref[..., 1, 1],
                  rot_ref[..., 1, 2])
    c0, c1, c2 = (rot_ref[..., 2, 0], rot_ref[..., 2, 1],
                  rot_ref[..., 2, 2])
    return (2 * a0 * (2 * y * y + 2 * z * z - 1)
            + 2 * b1 * (2 * x * x + 2 * z * z - 1)
            + 2 * c2 * (2 * x * x + 2 * y * y - 1)
            + 2 * a1 * (2 * w * z - 2 * x * y)
            - 2 * a2 * (2 * w * y + 2 * x * z)
            - 2 * b0 * (2 * w * z + 2 * x * y)
            + 2 * b2 * (2 * w * x - 2 * y * z)
            + 2 * c0 * (2 * w * y - 2 * x * z)
            - 2 * c1 * (2 * w * x + 2 * y * z) + 6)


def _integral_penalty(traj: trj.Trajectory, cfg: PlannerConfig,
                      fparams: flatness.FlatnessParams, ref_rots):
    """Quadrature dynamic-feasibility penalty per plan: (B,)
    (addTimeIntPenalty, mid_end.hpp:436-601)."""
    res = cfg.integralIntervs
    dur = traj.durations                                     # (B, N)
    frac = torch.arange(res + 1, dtype=dur.dtype, device=dur.device) / res
    s = dur[..., None] * frac                                # (B, N, J)
    c = traj.coeffs                                          # (B, N, 6, 3)

    def at(order):
        beta = trj._basis(s, order)                          # (B, N, J, 6)
        return torch.einsum("bnjk,bnkd->bnjd", beta, c)

    vel = at(1)
    acc = at(2)
    jer = at(3)
    zero = torch.zeros_like(s)
    _, quat, omg = flatness.forward(vel, acc, jer, zero, zero, fparams)

    viola_vel = torch.sum(vel * vel, -1) - cfg.vmax ** 2
    viola_omg = torch.sum(omg * omg, -1) - cfg.omgmax ** 2
    pena = (cfg.weight_v * smoothed_l1(viola_vel, cfg.smoothingEps)
            + cfg.weight_omg * smoothed_l1(viola_omg, cfg.smoothingEps))

    if cfg.weight_ar != 0.0:
        # attitude attraction toward per-junction reference rotations,
        # windowed by WC2 across each piece (mid_end.hpp:374-416,497-580)
        nb = dur.shape[0]
        eye = torch.eye(3, dtype=dur.dtype, device=dur.device)
        eye = eye.expand(nb, 1, 3, 3)
        rot_l = torch.cat([eye, ref_rots], dim=1)            # (B, N, 3, 3)
        rot_r = torch.cat([ref_rots, eye], dim=1)
        mid = 0.5 * dur[..., None]
        use_l = s <= mid
        norm_t = torch.where(use_l, s / mid, (s - mid) / mid - 1.0)
        krt = wc2(norm_t)
        rot_ref = torch.where(use_l[..., None, None], rot_l[:, :, None],
                              rot_r[:, :, None])
        cost_att = attitude_cost(quat, rot_ref)
        pena = pena + (krt * cfg.weight_ar
                       * smoothed_l1(cost_att, cfg.smoothingEps))

    node = torch.ones(res + 1, dtype=dur.dtype, device=dur.device)
    node[0] = 0.5
    node[-1] = 0.5
    step = dur / res
    return torch.sum(pena * node * step[..., None], dim=(1, 2))


def make_cost_fn(problem: MidEndProblem, cfg: PlannerConfig):
    """Returns cost(x) -> (B,) with x (B, 4N-3) = [tau (N); xi (3(N-1))]."""
    n = problem.ref_points.shape[1] + 1
    fparams = flatness.FlatnessParams(
        mass=cfg.vehicleMass, grav=cfg.gravAcc, dh=cfg.horizDrag,
        dv=cfg.vertDrag, cp=cfg.parasDrag, veps=cfg.speedEps)

    def cost(x):
        tau = x[:, :n]
        wps = x[:, n:].reshape(x.shape[0], n - 1, 3)
        times = forward_t(tau)
        traj = minco.solve(times, problem.head, problem.tail, wps)
        c = minco.energy(traj)
        # waypoint attraction ||junction - Q||^3 (addPosePenalty with
        # alpha=0 evaluates each segment start, mid_end.hpp:213-275)
        junctions = traj.coeffs[:, 1:, 0, :]                 # (B, N-1, 3)
        diff = junctions - problem.ref_points
        c = c + cfg.weight_pr * torch.sum(trj.ipow(safe_norm(diff), 3), -1)
        c = c + _integral_penalty(traj, cfg, fparams, problem.ref_rots)
        c = c + cfg.rho_mid_end * torch.sum(times, -1)
        return c

    return cost


class MidEndResult(NamedTuple):
    traj: trj.Trajectory
    opt_x: torch.Tensor     # (B, 4N-3)
    cost: torch.Tensor      # (B,)
    n_iters: torch.Tensor   # (B,)


def optimize(head, tail, waypoints, times, ref_rots=None,
             cfg: PlannerConfig = PlannerConfig(), max_iters: int = 100,
             device=None, dtype=torch.float32) -> MidEndResult:
    """Run the mid end (getOriTraj, mid_end.cpp:3-94) on B plans.

    head/tail: (B, 3, 3) rows pos/vel/acc; waypoints: (B, N-1, 3);
    times: (B, N) initial piece durations; ref_rots: (B, N-1, 3, 3) or
    None for identities. Arrays or tensors, moved to ``device``
    (None: CUDA) in ``dtype``. max_iters=100 mirrors the earlyExit cap
    (mid_end.hpp:603-618: k > 1e2)."""
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    waypoints = t(waypoints)
    nb, nq = waypoints.shape[:2]
    n = nq + 1
    if ref_rots is None:
        ref_rots = torch.eye(3, dtype=dtype, device=dev).expand(
            nb, nq, 3, 3)
    problem = MidEndProblem(t(head), t(tail), waypoints, t(ref_rots))
    x0 = torch.cat([backward_t(t(times)), waypoints.reshape(nb, -1)], 1)
    cost = make_cost_fn(problem, cfg)
    params = lbfgs.LBFGSParams(
        mem_size=cfg.mem_size, max_iterations=max_iters,
        g_epsilon=max(cfg.g_epsilon, 1e-7), past=3,
        delta=cfg.relCostTolMidEnd)
    res = lbfgs.minimize(lbfgs.value_and_grad(cost), x0, params)
    times_o = forward_t(res.x[:, :n])
    wps = res.x[:, n:].reshape(nb, n - 1, 3)
    with torch.no_grad():
        traj = minco.solve(times_o, problem.head, problem.tail, wps)
    return MidEndResult(traj, res.x, res.f, res.n_iters)
