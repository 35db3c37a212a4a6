"""Scenario batching on one card (svsdf_tpu/parallel/batch.py, the
single-chip part).

``plan_batch`` and ``plan_batch_staged`` solve B independent back-end
problems in lockstep: the JAX package vmaps a per-plan solve, this
module runs the batch-native solver of utils/lbfgs.py on (B, ...)
tensors. Multi-device sharding and the end-to-end batch are not ported
yet.
"""

from __future__ import annotations

import torch

from svsdf_tpu_torch import resolve_device
from svsdf_tpu_torch.ops import minco
from svsdf_tpu_torch.ops.svsdf import SVSDFConfig
from svsdf_tpu_torch.planner import back_end
from svsdf_tpu_torch.utils import lbfgs
from svsdf_tpu_torch.utils.config import PlannerConfig
from svsdf_tpu_torch.utils.transforms import forward_t


def _to_device(x0_b, problems_b, device):
    dev = resolve_device(device)
    prob = back_end.BackEndProblem(*(a.to(dev) for a in problems_b))
    return x0_b.to(dev), prob


def _final_traj(x, head, tail, n):
    times = forward_t(x[:, :n])
    wps = x[:, n:].reshape(x.shape[0], n - 1, 3)
    with torch.no_grad():
        return minco.solve(times, head, tail, wps)


def plan_batch(shape, x0_b, problems_b, cfg: PlannerConfig,
               svs_cfg: SVSDFConfig, n: int, max_iters: int,
               max_linesearch: int = 4, device=None):
    """Lockstep back-end solve of B scenarios with the sequential
    weak-Wolfe line search. x0_b (B, 4N-3); problems_b a BackEndProblem
    with a leading plan axis. Returns a batched BackEndResult."""
    x0_b, prob = _to_device(x0_b, problems_b, device)
    cost = back_end.make_cost_fn(shape, prob, cfg, svs_cfg, n)
    params = lbfgs.LBFGSParams(mem_size=cfg.mem_size,
                               max_iterations=max_iters,
                               g_epsilon=1e-7, past=3,
                               delta=cfg.relCostTol,
                               max_linesearch=max_linesearch)
    res = lbfgs.minimize(lbfgs.value_and_grad(cost), x0_b, params)
    traj = _final_traj(res.x, prob.head, prob.tail, n)
    return back_end.BackEndResult(traj, res.x, res.f, res.n_iters,
                                  res.converged)


def plan_batch_staged(shape, x0_b, problems_b, cfg: PlannerConfig,
                      stages: tuple, n: int, max_linesearch: int = 4,
                      device=None):
    """Staged batched solve: stages run back to back, each warm-starting
    the next. Entries are (svs_cfg, iters[, ls[, ls_cand[, frozen_ls[,
    weight_mult]]]]) as in ``_staged_solve``. ``device=None`` runs on
    CUDA (and raises without it)."""
    x0_b, prob = _to_device(x0_b, problems_b, device)
    x, res, traj = _staged_solve(shape, cfg, stages, n, max_linesearch,
                                 x0_b, prob.head, prob.tail, prob.obstacles)
    return back_end.BackEndResult(traj, x, res.f, res.n_iters,
                                  res.converged)


def default_stages(total_iters: int = 50, ls: int = 4,
                   frozen_ls: bool = True,
                   scan_dtype: str | None = "bfloat16",
                   ls_candidates: int = 4) -> tuple:
    """Two-stage schedule of the JAX package: 80% outside-only SVSDF
    (coarse_n=96, table-parabola t*), then 20% full GSIP polish
    (coarse_n=128, two wide rounds, gsip_topk=6), with the frozen-oracle
    parallel line search. Defaults are the JAX package's, including
    ``scan_dtype="bfloat16"``; the CUDA coarse scan runs float32 only,
    so card runs pass ``scan_dtype=None``."""
    fast = SVSDFConfig(coarse_n=96, refine_rounds=0, refine_n=16,
                       use_inside=False, scan_dtype=scan_dtype)
    polish = SVSDFConfig(coarse_n=128, refine_rounds=2, refine_n=16,
                         gsip_iters=3, gsip_coarse_n=32,
                         gsip_refine_rounds=1, gsip_topk=6,
                         scan_dtype=scan_dtype)
    k = max(total_iters // 5, 5)
    return ((fast, total_iters - k, ls, ls_candidates, frozen_ls),
            (polish, k, ls, ls_candidates, frozen_ls))


def default_stages_lowlat(total_iters: int = 50,
                          ls_candidates: int = 4,
                          scan_dtype: str | None = "bfloat16") -> tuple:
    """Low-latency schedule for small batches: the same two stages with
    the parallel (non-frozen) line search and gsip_topk=8."""
    fast = SVSDFConfig(coarse_n=96, refine_rounds=0, refine_n=16,
                       use_inside=False, scan_dtype=scan_dtype)
    polish = SVSDFConfig(coarse_n=128, refine_rounds=2, refine_n=16,
                         gsip_iters=3, gsip_coarse_n=32,
                         gsip_refine_rounds=1, gsip_topk=8,
                         scan_dtype=scan_dtype)
    k = max(total_iters // 5, 5)
    return ((fast, total_iters - k, 2, ls_candidates),
            (polish, k, 2, ls_candidates))


def _staged_solve(shape, cfg, stages, n, max_linesearch,
                  x0, head, tail, obstacles):
    """Warm-started stage loop. Stage entries:
    (svs_cfg, iters[, ls[, ls_cand[, frozen_ls[, weight_mult]]]]) —
    frozen_ls=True selects the frozen-oracle line search (one SVSDF
    oracle evaluation per iteration); weight_mult scales cfg.weight_p
    for that stage."""
    prob = back_end.BackEndProblem(head, tail, obstacles)
    x = x0
    res = None
    for stage in stages:
        svs_cfg, iters = stage[0], stage[1]
        ls = stage[2] if len(stage) > 2 else max_linesearch
        ls_cand = stage[3] if len(stage) > 3 else 0
        frozen_ls = stage[4] if len(stage) > 4 else False
        wmult = stage[5] if len(stage) > 5 else 1.0
        wp = cfg.weight_p * wmult if wmult != 1.0 else None
        params = lbfgs.LBFGSParams(
            mem_size=cfg.mem_size, max_iterations=iters,
            g_epsilon=1e-7, past=3, delta=cfg.relCostTol,
            max_linesearch=ls, ls_candidates=ls_cand)
        if frozen_ls:
            full, frz = back_end.make_cost_pair_fn(shape, prob, cfg,
                                                   svs_cfg, n, weight_p=wp)
            res = lbfgs.minimize(full, x, params, frozen=frz)
        else:
            cost = back_end.make_cost_fn(shape, prob, cfg, svs_cfg, n,
                                         weight_p=wp)
            res = lbfgs.minimize(lbfgs.value_and_grad(cost), x, params)
        x = res.x
    traj = _final_traj(x, head, tail, n)
    return x, res, traj
