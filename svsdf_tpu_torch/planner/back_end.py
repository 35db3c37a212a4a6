"""SVSDF back-end trajectory cost, batched over plans
(svsdf_tpu/planner/back_end.py).

  cost = spline energy + rho * sum(T)
       + weight_p * sum_obstacles L1s(safety_hor - SVSDF(p_obs))

over x = (tau, xi). The SVSDF oracle (t*, sdf*, world gradient) runs
under ``torch.no_grad`` on a detached trajectory — the envelope theorem
kills the dt* term at the minimiser — and the penalty is re-expressed
through the first-order surrogate

  sdf~ = sdf* + g_rel0 . (p_rel(coeffs, T; t*) - p_rel0)

whose autograd gradient is the envelope gradient.

Cost functions take x (R, 4N-3) where R is the problem's plan count B
or a multiple B*C of it (the parallel line search's candidates, rows
lane-major); the problem tensors, and ``weight_p`` / ``safety_hor`` when
they are per-plan tensors (B, M) (the certify-refine escalation of
parallel/batch.py), are repeated to match.

``optimize`` is the single-plan pipeline's solve: the hinge-smoothing
continuation inside one ``lbfgs.minimize_scheduled`` loop with the
weak-Wolfe line search on the full cost, or with ``solver="lmbm"`` the
reference's bundle method (utils/lmbm.py), one solve per stage of the
ladder on the autograd gradient of the full cost.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from svsdf_tpu_torch import resolve_device
from svsdf_tpu_torch.ops import minco
from svsdf_tpu_torch.ops.svsdf import DEFAULT_CONFIG, SVSDFConfig, svsdf_query
from svsdf_tpu_torch.utils import trajectory as trj
from svsdf_tpu_torch.utils.config import PlannerConfig
from svsdf_tpu_torch.utils import lbfgs, lmbm
from svsdf_tpu_torch.utils.lbfgs import value_and_grad
from svsdf_tpu_torch.utils.transforms import forward_t, smoothed_l1


class BackEndProblem(NamedTuple):
    head: torch.Tensor        # (B, 3, 3)
    tail: torch.Tensor        # (B, 3, 3)
    obstacles: torch.Tensor   # (B, M, 2) world xy obstacle points


class OracleState(NamedTuple):
    """Frozen SVSDF linearisation at an iterate (leading plan axis)."""
    sdf0: torch.Tensor      # (B, M) oracle SVSDF at the iterate
    alpha: torch.Tensor     # (B, M) t*/T_total fraction
    g_rel0: torch.Tensor    # (B, M, 2) body-frame SDF gradient
    p_rel0: torch.Tensor    # (B, M, 2) body-frame point at linearisation


def svsdf_linearize(shape, traj: trj.Trajectory, obstacles,
                    svs_cfg: SVSDFConfig):
    """Run the SVSDF oracle without gradients and package the penalty
    linearisation state. Returns (OracleState, SVSDFResult)."""
    with torch.no_grad():
        traj_sg = trj.Trajectory(traj.coeffs.detach(),
                                 traj.durations.detach())
        obstacles = obstacles.detach()
        res = svsdf_query(shape, traj_sg, obstacles, svs_cfg,
                          with_inside=svs_cfg.use_inside)
        total = torch.sum(traj_sg.durations, dim=-1)[:, None]
        alpha = res.t_star / total
        t_eval = alpha * total
        xy0, _, R0 = trj.state_se2(traj_sg, t_eval)
        p_rel0 = trj.world_to_body(xy0, R0, obstacles)
        # body-frame gradient at the linearisation point: R0^T g_w
        g_rel0 = torch.einsum("bmij,bmi->bmj", R0, res.grad_world)
    return OracleState(res.sdf, alpha, g_rel0, p_rel0), res


def penalty_from_state(traj: trj.Trajectory, obstacles, st: OracleState,
                       wp, sh, mu):
    """Differentiable penalty at the frozen oracle state: (B,). The query
    time is alpha * sum(T), so re-timing gradients stay exact at
    boundary minimisers."""
    total = torch.sum(traj.durations, dim=-1)[:, None]
    t_eval = st.alpha * total
    xy, _, R = trj.state_se2(traj, t_eval)
    p_rel = trj.world_to_body(xy, R, obstacles)
    sdf_lin = st.sdf0 + torch.sum(st.g_rel0 * (p_rel - st.p_rel0), dim=-1)
    pen = smoothed_l1(sh - sdf_lin, mu)
    return torch.sum(wp * pen, dim=-1)


def svsdf_penalty(shape, traj: trj.Trajectory, obstacles,
                  cfg: PlannerConfig, svs_cfg: SVSDFConfig,
                  mu: float = 0.01, weight_p=None, safety_hor=None):
    """SVSDF safety penalty over obstacle points: (penalty (B,), result)."""
    wp = cfg.weight_p if weight_p is None else weight_p
    sh = cfg.safety_hor if safety_hor is None else safety_hor
    st, res = svsdf_linearize(shape, traj, obstacles, svs_cfg)
    return penalty_from_state(traj, obstacles, st, wp, sh, mu), res


def _expand(problem: BackEndProblem, rows: int) -> BackEndProblem:
    """Repeat each plan's problem rows // B times (lane-major)."""
    nb = problem.head.shape[0]
    if rows == nb:
        return problem
    if rows % nb:
        raise ValueError(f"{rows} cost rows for {nb} plans")
    rep = rows // nb
    return BackEndProblem(*(a.repeat_interleave(rep, dim=0)
                            for a in problem))


def _expand_weight(v, nb: int, rows: int):
    """A per-plan weight tensor (B, ...) repeated to ``rows`` cost rows as
    ``_expand`` repeats the problem; scalars pass through."""
    if not torch.is_tensor(v) or v.dim() == 0 or rows == nb:
        return v
    return v.repeat_interleave(rows // nb, dim=0)


def _traj(x, problem: BackEndProblem, n: int):
    tau = x[:, :n]
    wps = x[:, n:].reshape(x.shape[0], n - 1, 3)
    times = forward_t(tau)
    return minco.solve(times, problem.head, problem.tail, wps), times


def make_cost_fn(shape, problem: BackEndProblem, cfg: PlannerConfig,
                 svs_cfg: SVSDFConfig, n: int, mu: float = 0.01,
                 weight_p=None, safety_hor=None):
    """cost(x) -> (R,): the full cost, one oracle pass per call."""
    nb = problem.head.shape[0]

    def cost(x):
        rows = x.shape[0]
        prob = _expand(problem, rows)
        traj, times = _traj(x, prob, n)
        pen, _ = svsdf_penalty(shape, traj, prob.obstacles, cfg, svs_cfg,
                               mu=mu,
                               weight_p=_expand_weight(weight_p, nb, rows),
                               safety_hor=_expand_weight(safety_hor, nb,
                                                         rows))
        return minco.energy(traj) + pen + cfg.rho * torch.sum(times, -1)

    return cost


def make_cost_pair_fn(shape, problem: BackEndProblem, cfg: PlannerConfig,
                      svs_cfg: SVSDFConfig, n: int, mu: float = 0.01,
                      weight_p=None, safety_hor=None):
    """(full, frozen) cost pair for the frozen-oracle line search:

      full(x)        -> (f, grad, OracleState)  — one oracle pass
      frozen(x, st)  -> (f~, grad~)             — surrogate only
    """
    wp = cfg.weight_p if weight_p is None else weight_p
    sh = cfg.safety_hor if safety_hor is None else safety_hor
    nb = problem.head.shape[0]

    def _pen(traj, obstacles, st, rows):
        return penalty_from_state(traj, obstacles, st,
                                  _expand_weight(wp, nb, rows),
                                  _expand_weight(sh, nb, rows), mu)

    def full(x):
        prob = _expand(problem, x.shape[0])
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            traj, times = _traj(xr, prob, n)
            st, _ = svsdf_linearize(shape, traj, prob.obstacles, svs_cfg)
            pen = _pen(traj, prob.obstacles, st, x.shape[0])
            f = minco.energy(traj) + pen + cfg.rho * torch.sum(times, -1)
            (g,) = torch.autograd.grad(f.sum(), xr)
        return f.detach(), g, st

    def _frozen_f(x, st):
        prob = _expand(problem, x.shape[0])
        traj, times = _traj(x, prob, n)
        pen = _pen(traj, prob.obstacles, st, x.shape[0])
        return minco.energy(traj) + pen + cfg.rho * torch.sum(times, -1)

    def frozen(x, st):
        return value_and_grad(lambda xx: _frozen_f(xx, st))(x)

    return full, frozen


class BackEndResult(NamedTuple):
    traj: trj.Trajectory
    opt_x: torch.Tensor
    cost: torch.Tensor
    n_iters: torch.Tensor
    converged: torch.Tensor



#: upper bound on the scheduled solve's iterations (the budget itself is
#: max_iters plus the earlier stages')
_MAX_ITER_BOUND = 1024


#: the back-end solvers: the weak-Wolfe L-BFGS continuation and the
#: bundle method
SOLVERS = ("lbfgs", "lmbm")


def check_solver(solver: str) -> None:
    if solver not in SOLVERS:
        raise ValueError(f"unknown back-end solver {solver!r}; have "
                         f"{SOLVERS}")


def _f32(v, dtype, dev):
    """A Python scalar as the JAX package passes it: rounded to float32,
    then used in the working type."""
    return torch.tensor(v, dtype=torch.float32).to(device=dev, dtype=dtype)


def _run(shape, x0, problem: BackEndProblem, cfg: PlannerConfig,
         svs_cfg: SVSDFConfig, n: int, mu_values, stage_bounds,
         total_iters: int, weight_p, safety_hor, live: bool = False):
    """Smoothing-continuation solve: the hinge smoothing mu anneals
    from wide to the reference's 0.01 inside one scheduled L-BFGS loop,
    mu picked per lane from its iteration counter and the stage bounds.
    The wide stages give the nonsmooth landscape a broad basin (the role
    LMBM's bundle plays in the reference) before the sharp stage
    polishes."""

    def cost(x, it):
        stage = torch.sum(it[:, None] >= stage_bounds[None], dim=1)
        mu = mu_values[stage][:, None]
        prob = _expand(problem, x.shape[0])
        traj, times = _traj(x, prob, n)
        pen, _ = svsdf_penalty(shape, traj, prob.obstacles, cfg, svs_cfg,
                               mu=mu, weight_p=weight_p,
                               safety_hor=safety_hor)
        return minco.energy(traj) + pen + cfg.rho * torch.sum(times, -1)

    def vg(x, it):
        return value_and_grad(lambda xx: cost(xx, it))(x)

    params = lbfgs.LBFGSParams(
        mem_size=cfg.mem_size, max_iterations=_MAX_ITER_BOUND,
        g_epsilon=max(cfg.g_epsilon, 1e-7), past=3,
        delta=max(cfg.relCostTol, getattr(cfg, "back_rel_stall", 0.0)),
        max_linesearch=getattr(cfg, "back_max_ls", 40), live=live)
    res = lbfgs.minimize_scheduled(vg, x0, params, n_iters=total_iters,
                                   stage_bounds=stage_bounds)
    times = forward_t(res.x[:, :n])
    wps = res.x[:, n:].reshape(x0.shape[0], n - 1, 3)
    with torch.no_grad():
        traj = minco.solve(times, problem.head, problem.tail, wps)
    return BackEndResult(traj, res.x, res.f, res.n_iters, res.converged)


def _run_lmbm(shape, x0, problem: BackEndProblem, cfg: PlannerConfig,
              svs_cfg: SVSDFConfig, n: int, max_iters: int,
              mu_schedule: tuple, weight_p, safety_hor):
    """Per-stage LMBM continuation (the reference's solver,
    back_end_optimizer.cpp:30): one bundle solve per mu of the ladder,
    each restarting the bundle from the last stage's x, on the autograd
    gradient of the full cost (as the JAX package's jax.value_and_grad of
    ``make_cost_fn``). Every stage but the last gets
    max(max_iters // 2, 40) iterations."""
    x = x0
    iters_done = torch.zeros(x0.shape[0], dtype=torch.long,
                             device=x0.device)
    res = None
    for i, mu in enumerate(mu_schedule):
        cost = make_cost_fn(shape, problem, cfg, svs_cfg, n, mu=mu,
                            weight_p=weight_p, safety_hor=safety_hor)
        iters = max_iters if i == len(mu_schedule) - 1 else max(
            max_iters // 2, 40)
        res = lmbm.minimize(
            value_and_grad(cost), x,
            lmbm.LMBMParams(mem_size=cfg.mem_size, max_iterations=iters,
                            delta=max(cfg.relCostTol, cfg.back_rel_stall)))
        x = res.x
        iters_done = iters_done + res.n_iters
    times = forward_t(x[:, :n])
    wps = x[:, n:].reshape(x0.shape[0], n - 1, 3)
    with torch.no_grad():
        traj = minco.solve(times, problem.head, problem.tail, wps)
    return BackEndResult(traj, x, res.f, iters_done, res.converged)


def optimize(shape, head, tail, obstacles, opt_x,
             cfg: PlannerConfig = PlannerConfig(),
             svs_cfg: SVSDFConfig = DEFAULT_CONFIG,
             max_iters: int = 200,
             mu_schedule: tuple = (0.5, 0.1, 0.01),
             solver: str = "lbfgs",
             weight_p=None, safety_hor=None,
             live: bool = False, device=None,
             dtype=torch.float32) -> BackEndResult:
    """Run the back end from the mid end's warm start on B plans
    (optimize_traj_lmbm, back_end_optimizer.cpp:3-96).

    head/tail (B, 3, 3); obstacles (B, M, >=2), z/yaw dropped
    (pos_eva(2) = 0, back_end_optimizer.hpp:792); opt_x (B, 4N-3).
    Arrays or tensors, moved to ``device`` (None: CUDA) in ``dtype``.
    weight_p / safety_hor override the config values (the certify-refine
    escalation). They and the mu ladder are rounded to float32, as the
    JAX package passes them.

    The mu ladder is padded to 3 stage slots with zero-length stages;
    every stage but the last gets max(max_iters // 2, 40) iterations, the
    last max_iters. ``solver="lmbm"`` runs ``_run_lmbm`` on the ladder as
    given (mu as Python floats, as the JAX package's static schedule)."""
    check_solver(solver)
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    opt_x = t(opt_x)
    n = (opt_x.shape[1] + 3) // 4
    problem = BackEndProblem(t(head), t(tail), t(obstacles)[..., :2])
    wp = _f32(cfg.weight_p if weight_p is None else weight_p, dtype, dev)
    sh = _f32(cfg.safety_hor if safety_hor is None else safety_hor, dtype,
              dev)
    if solver == "lmbm":
        return _run_lmbm(shape, opt_x, problem, cfg, svs_cfg, n, max_iters,
                         tuple(mu_schedule), wp, sh)
    n_stage_slots = 3
    mus = list(mu_schedule)[:n_stage_slots]
    early = max(max_iters // 2, 40)
    iters = [early] * (len(mus) - 1) + [max_iters]
    while len(mus) < n_stage_slots:       # pad with zero-length stages
        mus.append(mus[-1])
        iters.append(0)
    bounds = torch.as_tensor(np.cumsum(iters[:-1]), dtype=torch.long,
                             device=dev)
    total = int(np.sum(iters))
    mu_values = _f32(mus, dtype, dev)
    return _run(shape, opt_x, problem, cfg, svs_cfg, n, mu_values, bounds,
                total, wp, sh, live)
