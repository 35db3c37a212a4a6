"""Scenario batching on one card and sharded planning over ranks
(svsdf_tpu/parallel/batch.py).

``plan_batch`` and ``plan_batch_staged`` solve B independent back-end
problems in lockstep: the JAX package vmaps a per-plan solve, this
module runs the batch-native solver of utils/lbfgs.py on (B, ...)
tensors. ``plan_batch_e2e`` adds the device wavefront front end and the
certify-and-refine rounds in front of and behind the same solve.

The sharded functions (``make_mesh``, ``sharded_value_and_grad``,
``sharded_plan_batch``, ``sharded_step``, ``sharded_plan_batch_e2e``)
are the JAX package's ``shard_map`` solves over a (scn, obs) mesh of
``torch.distributed`` ranks (parallel/multihost.py): scenarios are split
over the scn axis, each scenario's obstacle points over the obs axis,
and the partial costs and gradients of an obs row are summed by an
``all_reduce`` inside every cost evaluation (the reference's
omp-critical gradient merge, back_end_optimizer.hpp:855-863). Each
takes the whole batch, held by every rank, and returns the rank's
scenario slice (``multihost.fetch_global`` gathers it).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from svsdf_tpu_torch import resolve_device
from svsdf_tpu_torch.ops import minco
from svsdf_tpu_torch.ops.svsdf import (SVSDFConfig, linspace, linspace_1d,
                                       svsdf_query)
from svsdf_tpu_torch.parallel import multihost
from svsdf_tpu_torch.planner import back_end, wavefront
from svsdf_tpu_torch.utils import lbfgs
from svsdf_tpu_torch.utils import trajectory as trj
from svsdf_tpu_torch.utils.config import PlannerConfig
from svsdf_tpu_torch.utils.profiling import host_bool, span
from svsdf_tpu_torch.utils.transforms import backward_t, forward_t

PI = math.pi


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
    with span("batch.staged"):
        x0_b, prob = _to_device(x0_b, problems_b, device)
        x, res, traj = _staged_solve(shape, cfg, stages, n, max_linesearch,
                                     x0_b, prob.head, prob.tail,
                                     prob.obstacles)
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
    ``scan_dtype="bfloat16"``, which the CUDA coarse scan runs in its
    bfloat16 form (``scan_dtype=None`` scans in float32)."""
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
        with span("batch.stage"):
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


# ---------------------------------------------------------------------------
# batched end-to-end planning: device wavefront front end + staged solve
# (+ certify-refine)
# ---------------------------------------------------------------------------

class E2EBatchResult(NamedTuple):
    front_ok: torch.Tensor    # (B,) wavefront reached the goal
    x: torch.Tensor           # (B, 4N-3) final decision vectors
    cost: torch.Tensor        # (B,)
    cert_min: torch.Tensor    # (B,) min SVSDF over harvested obstacles
    head: torch.Tensor        # (B, 3, 3)
    tail: torch.Tensor        # (B, 3, 3)
    obstacles: torch.Tensor   # (B, M, 2)
    coeffs: torch.Tensor      # (B, N, 6, 3)
    durations: torch.Tensor   # (B, N)


def _cumsum(x):
    """Prefix sum along axis 1 accumulated in x's own dtype. The JAX
    package sums float32 in float32, in order; torch's CPU cumsum
    accumulates float32 in float64, so a host tensor goes through
    numpy's sequential float32 sum. On the card, torch.cumsum."""
    if x.is_cuda:
        return torch.cumsum(x, dim=1)
    return torch.from_numpy(np.cumsum(x.numpy(), axis=1, dtype=x.numpy().dtype))


def _resample_path(path_ij, yaw_bins, length, n, resolution, xy_min,
                   yaw_num, dtype):
    """(B, L, 2) padded cells + bins -> head, tail (B, 3, 3) and the
    (B, n+1, 3) states evenly spaced by arc length, yaw unwrapped.

    As in the JAX package, the cell centres, yaws and arc lengths are
    float32 (the front end's type) and the interpolation runs in
    ``dtype``."""
    nb, L = path_ij.shape[:2]
    f32 = torch.float32
    xy = xy_min + (path_ij.to(f32) + 0.5) * resolution       # (B, L, 2)
    yaw_raw = 2.0 * PI * yaw_bins.to(f32) / yaw_num - PI
    # unwrap along the path (the padding repeats the last entry: dy 0)
    dy = yaw_raw[:, 1:] - yaw_raw[:, :-1]
    dy = torch.remainder(dy + PI, 2.0 * PI) - PI
    yaw = torch.cat([yaw_raw[:, :1],
                     yaw_raw[:, :1] + _cumsum(dy)], dim=1)
    dxy = xy[:, 1:] - xy[:, :-1]
    seg = torch.sqrt(dxy[..., 0] * dxy[..., 0] + dxy[..., 1] * dxy[..., 1])
    cum = torch.cat([torch.zeros_like(seg[:, :1]),
                     _cumsum(seg)], dim=1).to(dtype)      # (B, L)
    last = torch.clamp_max(length - 1, L - 1)
    total = torch.gather(cum, 1, last[:, None].long())        # (B, 1)
    t = linspace_1d(0.0, 1.0, n + 1, dtype, cum.device) * total
    idx = torch.clamp(torch.searchsorted(cum.contiguous(), t.contiguous(),
                                         right=True) - 1, 0, L - 2)
    c0 = torch.gather(cum, 1, idx)
    sg = torch.gather(seg, 1, idx)
    w = torch.where(sg > 1e-9, (t - c0) / torch.clamp_min(sg, 1e-9).to(dtype),
                    0.0)
    w = torch.clamp(w, 0.0, 1.0)[..., None]                  # (B, n+1, 1)
    take = lambda a, i: torch.gather(
        a, 1, i[..., None].expand(-1, -1, a.shape[-1])).to(dtype)
    pos = take(xy, idx) * (1 - w) + take(xy, idx + 1) * w
    yw = (take(yaw[..., None], idx) * (1 - w)
          + take(yaw[..., None], idx + 1) * w)
    states = torch.cat([pos, yw], dim=-1)                    # (B, n+1, 3)
    head = torch.zeros((nb, 3, 3), dtype=dtype, device=states.device)
    tail = torch.zeros_like(head)
    head[:, 0] = states[:, 0]
    tail[:, 0] = states[:, -1]
    return head, tail, states


def _harvest_topm(occ_pts, states, m):
    """(Mocc, 2) occupied cell centres -> for each plan the m closest to
    its path states (head and tail included), nearest first. Ties go to
    the lower index, as jax.lax.top_k orders them: grid centres tie in
    distance all the time, and the order sets the penalty sum's
    rounding."""
    diff = occ_pts[None, :, None, :] - states[:, None, :, :2]  # (B, Mo, S, 2)
    d = torch.sqrt(diff[..., 0] * diff[..., 0]
                   + diff[..., 1] * diff[..., 1]).amin(dim=2)  # (B, Mo)
    idx = torch.sort(d, dim=1, stable=True).indices[:, :m]
    return occ_pts[idx]                                       # (B, m, 2)


def _sweep_harvest(traj, occ_pts, n, n_obs):
    """Obstacles nearest the trajectory's sweep at 4n+1 times."""
    ts = linspace(traj.total_duration, 4 * n + 1)
    sweep_xy, _, _ = trj.state_se2(traj, ts)
    return _harvest_topm(occ_pts, sweep_xy, n_obs)


def _cert_cfg(stages):
    """Certificate oracle: the last stage's, with a dense float32 scan."""
    last = stages[-1][0]
    return dataclasses.replace(last, coarse_n=max(192, last.coarse_n),
                               scan_dtype=None)


def _certify_refine(shape, cfg, stages, n, max_linesearch, occ_pts, n_obs,
                    x, head, tail, obstacles, refine_rounds: int,
                    refine_iters: int, refine_esc: float,
                    cert_margin: float, refine_fast: bool = True,
                    cost0=None, refine_svs_cfg=None):
    """Certify-and-refine rounds of B lanes (the batched counterpart of
    the JAX package's ``lax.fori_loop`` body). Each round re-harvests the
    n_obs occupied cells nearest the current sweep, certifies with a
    dense float32 oracle, keeps the best iterate so far, nudges stalled
    deep violators, escalates per-point penalty weights and the margin,
    and re-solves the violating lanes warm-started.

    JAX runs the whole round under ``lax.cond(best_cert >= margin)`` and
    the solve under ``lax.cond(viol)``; vmapped, both become per-lane
    selects. Here a lane that skips keeps its whole carry, round counter
    included; the round is skipped on the host when no lane needs it,
    and the solve runs only on the lanes that need it (lanes are
    independent, so the values are the same). Returns (x, obstacles,
    cost)."""
    cert_cfg = _cert_cfg(stages)
    solve_stage = stages[0] if refine_fast else stages[-1]
    if refine_svs_cfg is not None:
        svs_cfg = refine_svs_cfg
    else:
        tk = solve_stage[0].gsip_topk
        svs_cfg = dataclasses.replace(
            solve_stage[0], coarse_n=max(192, solve_stage[0].coarse_n),
            scan_dtype=None, gsip_topk=max(8, tk) if tk else 0)
    ls = solve_stage[2] if len(solve_stage) > 2 else max_linesearch
    # refine solves keep the sequential weak-Wolfe search
    frozen_ls = solve_stage[4] if len(solve_stage) > 4 else False
    params = lbfgs.LBFGSParams(
        mem_size=cfg.mem_size, max_iterations=refine_iters, g_epsilon=1e-7,
        past=3, delta=cfg.relCostTol, max_linesearch=ls, ls_candidates=0)
    nb, dtype, dev = x.shape[0], x.dtype, x.device
    lanes = torch.arange(nb, device=dev)
    m_obs = obstacles.shape[1]
    cost = (torch.full((nb,), math.inf, dtype=dtype, device=dev)
            if cost0 is None else cost0.to(dtype))
    mult = torch.ones(nb, dtype=dtype, device=dev)
    best_x = x
    best_cert = torch.full((nb,), -math.inf, dtype=dtype, device=dev)
    sdf_best = torch.zeros((nb, m_obs), dtype=dtype, device=dev)
    grad_best = torch.zeros((nb, m_obs, 2), dtype=dtype, device=dev)
    r = torch.zeros(nb, dtype=torch.long, device=dev)
    sel = lbfgs._sel                          # per-lane torch.where

    for _ in range(refine_rounds):
        # whole-round skip once the best certificate clears the margin
        need = ~(best_cert >= cert_margin)
        if not host_bool(need.any(), "batch.certify_round"):
            break
        traj = _final_traj(x, head, tail, n)
        with torch.no_grad():
            obs_cand = _sweep_harvest(traj, occ_pts, n, n_obs)
            q = svsdf_query(shape, traj, obs_cand, cert_cfg,
                            with_inside=False)
        cert_cand = q.sdf.amin(dim=1)
        # best so far: every round judges the last solve against the
        # best certificate and re-solves from the best iterate
        better = cert_cand > best_cert
        stalled = ~better
        n_best_x = sel(better, x, best_x)
        n_best_cert = torch.maximum(cert_cand, best_cert)
        n_sdf_best = sel(better, q.sdf, sdf_best)
        n_obstacles = sel(better, obs_cand, obstacles)
        n_grad_best = sel(better, q.grad_world, grad_best)
        xx = n_best_x
        cert = n_best_cert
        viol = cert < cert_margin
        # stalled deep violators: push the waypoints nearest the worst
        # point along -grad(swept SDF)
        i_worst = torch.argmin(n_sdf_best, dim=1)
        g = n_grad_best[lanes, i_worst]                      # (B, 2)
        gn = torch.sqrt(g[:, 0] * g[:, 0] + g[:, 1] * g[:, 1])
        push = torch.where(gn > 1e-6, (-cert + 0.1)
                           / torch.clamp_min(gn, 1e-6), 0.0)
        wps_b = xx[:, n:].reshape(nb, n - 1, 3)
        wd = wps_b[..., :2] - n_obstacles[lanes, i_worst][:, None]
        wdist = torch.sqrt(wd[..., 0] * wd[..., 0] + wd[..., 1] * wd[..., 1])
        u = wdist / 3.0
        fall = torch.exp(-(u * u))[..., None]                # (B, n-1, 1)
        nudge_on = viol & stalled & (r > 0) & (cert < -0.15)
        on = torch.where(nudge_on, 1.0, 0.0).to(dtype)
        shove = (-g[:, None] * push[:, None, None] * fall
                 * on[:, None, None])
        wps_n = torch.cat([wps_b[..., :2] + shove, wps_b[..., 2:]], dim=-1)
        xx = torch.cat([xx[:, :n], wps_n.reshape(nb, -1)], dim=1)
        # per-point graded escalation: mult^1 deep inside, mult^0.5 at
        # the margin, braking to base weight at margin + 0.3 m
        n_mult = torch.where(viol, mult * refine_esc, mult)
        severity = torch.clamp((cert_margin + 0.3 - n_sdf_best) / 0.6,
                               0.0, 1.0)
        wp = cfg.weight_p * torch.pow(n_mult[:, None], severity)
        sh = cfg.safety_hor + torch.clamp_max(
            0.05 * (r + 1).to(dtype), 0.1)[:, None] * (
                n_sdf_best < cert_margin).to(dtype)
        n_cost = cost
        solve = need & viol
        if host_bool(solve.any(), "batch.certify_solve"):
            idx = torch.nonzero(solve)[:, 0]
            prob = back_end.BackEndProblem(head[idx], tail[idx],
                                           n_obstacles[idx])
            if frozen_ls:
                full, frz = back_end.make_cost_pair_fn(
                    shape, prob, cfg, svs_cfg, n, weight_p=wp[idx],
                    safety_hor=sh[idx])
                res = lbfgs.minimize(full, xx[idx], params, frozen=frz)
            else:
                cfn = back_end.make_cost_fn(shape, prob, cfg, svs_cfg, n,
                                            weight_p=wp[idx],
                                            safety_hor=sh[idx])
                res = lbfgs.minimize(lbfgs.value_and_grad(cfn), xx[idx],
                                     params)
            xx = xx.index_copy(0, idx, res.x.to(dtype))
            n_cost = cost.index_copy(0, idx, res.f.to(dtype))
        # r counts executed rounds (skipped rounds do not escalate)
        x = sel(need, xx, x)
        cost = sel(need, n_cost, cost)
        mult = sel(need, n_mult, mult)
        best_x = sel(need, n_best_x, best_x)
        best_cert = sel(need, n_best_cert, best_cert)
        sdf_best = sel(need, n_sdf_best, sdf_best)
        obstacles = sel(need, n_obstacles, obstacles)
        grad_best = sel(need, n_grad_best, grad_best)
        r = torch.where(need, r + 1, r)

    # final judgment: if the last solve regressed, return the best iterate
    traj = _final_traj(x, head, tail, n)
    with torch.no_grad():
        obs_f = _sweep_harvest(traj, occ_pts, n, n_obs)
        cert_f = svsdf_query(shape, traj, obs_f, cert_cfg,
                             with_inside=False).sdf.amin(dim=1)
    keep = cert_f >= best_cert
    return sel(keep, x, best_x), sel(keep, obs_f, obstacles), cost


def _occ_points(occ_pts, dev, dtype):
    """Obstacle candidates on ``dev``; a float array keeps its dtype."""
    occ = torch.as_tensor(occ_pts, device=dev)
    return occ if occ.is_floating_point() else occ.to(dtype)


def front_end(feas, occ_pts, starts_ij, goals_ij, cfg: PlannerConfig,
              n: int, n_obs: int, resolution, xy_min,
              max_path_len: int | None = None, trans_feas=None,
              yaw_weight: float = 0.25, cell_cost=None, device=None,
              dtype=torch.float32):
    """The front end of ``plan_batch_e2e``: wavefront field and path per
    plan, arc-length resample, nearest-obstacle harvest and the initial
    decision vector. Returns (front_ok (B,), head, tail (B, 3, 3),
    obstacles (B, n_obs, 2), x0 (B, 4n-3))."""
    with span("batch.front_end"):
        dev = resolve_device(device)
        occ_pts = _occ_points(occ_pts, dev, dtype)
        feas = torch.as_tensor(feas, device=dev).bool()
        starts = torch.as_tensor(starts_ij, device=dev).long()
        goals = torch.as_tensor(goals_ij, device=dev).long()
        xy_min = torch.as_tensor(xy_min, dtype=torch.float32, device=dev)
        free = torch.any(feas, dim=0)
        if max_path_len is None:
            max_path_len = 4 * int(free.shape[0] + free.shape[1])
        nb = starts.shape[0]
        with torch.no_grad():
            if trans_feas is not None:
                # yaw in the search graph: transition-checked (cell, bin) moves
                dist3 = wavefront.distance_field_3d(
                    feas, trans_feas, goals, yaw_weight,
                    max_iters=max_path_len + 8, cell_cost=cell_cost,
                    device=dev)
                path, yaws, length, ok = wavefront.extract_path_3d(
                    dist3, trans_feas, starts, max_path_len, yaw_weight,
                    cell_cost=cell_cost, device=dev)
            else:
                dist = wavefront.distance_field(free, goals,
                                                max_iters=max_path_len + 8,
                                                device=dev)
                path, length, ok = wavefront.extract_path(
                    dist, starts, max_path_len, device=dev)
                # Viterbi DP yaw: globally minimal total rotation
                yaws = wavefront.assign_yaws_dp(feas, path, device=dev)
            head, tail, states = _resample_path(path, yaws, length, n,
                                                float(resolution), xy_min,
                                                feas.shape[0], dtype)
            obs = _harvest_topm(occ_pts, states, n_obs)
            tau = backward_t(torch.full((n,), cfg.inittime,
                                        dtype=torch.float32,
                                        device=dev)).to(dtype)
            x0 = torch.cat([tau.expand(nb, n),
                            states[:, 1:-1].reshape(nb, -1)], dim=1)
        return ok, head, tail, obs, x0


def plan_batch_e2e(shape, feas, occ_pts, starts_ij, goals_ij,
                   cfg: PlannerConfig, stages: tuple, n: int, n_obs: int,
                   resolution, xy_min, max_linesearch: int = 2,
                   max_path_len: int | None = None, refine_rounds: int = 0,
                   refine_iters: int = 12, refine_esc: float = 4.0,
                   cert_margin: float = 0.0, trans_feas=None,
                   yaw_weight: float = 0.25, refine_fast: bool = False,
                   cell_cost=None, refine_svs_cfg=None, device=None,
                   dtype=torch.float32) -> E2EBatchResult:
    """Batched end-to-end planning of B plans on one map: wavefront front
    end (geodesic field, greedy descent, yaw bins), arc-length resample
    to an n-piece spline, nearest-obstacle harvest, staged back-end
    solve, optional certify-and-refine rounds, and a per-plan SVSDF
    certificate.

    feas (K, X, Y) bool yaw-bin feasibility; occ_pts (Mocc, 2) occupied
    cell centres; starts_ij / goals_ij (B, 2) int cells. With
    ``trans_feas`` (K, D, 8, X, Y) the front end searches (yaw bin, x, y)
    states with transition-checked edges (and ``cell_cost`` (X, Y) route
    shaping); without it, the 2-D field with the DP yaw assignment.
    max_path_len bounds the path and the field's sweeps (4*(X+Y) by
    default). refine_rounds > 0 runs ``_certify_refine``.

    The trajectory, x, head and tail are in ``dtype``; the front end's
    field and cell centres are float32; the obstacles keep occ_pts's
    dtype, as in the JAX package. ``device=None`` runs on CUDA and raises
    without it. Returns E2EBatchResult."""
    with span("batch.e2e"):
        dev = resolve_device(device)
        occ = _occ_points(occ_pts, dev, dtype)
        ok, head, tail, obs, x0 = front_end(
            feas, occ, starts_ij, goals_ij, cfg, n, n_obs, resolution,
            xy_min, max_path_len, trans_feas, yaw_weight, cell_cost, dev,
            dtype)
        x, res, traj = _staged_solve(shape, cfg, stages, n, max_linesearch,
                                     x0, head, tail, obs)
        cost = res.f
        with span("batch.certify"):
            if refine_rounds > 0:
                x, obs, cost = _certify_refine(
                    shape, cfg, stages, n, max_linesearch, occ, n_obs, x,
                    head, tail, obs, refine_rounds, refine_iters,
                    refine_esc, cert_margin, refine_fast, cost0=cost,
                    refine_svs_cfg=refine_svs_cfg)
                traj = _final_traj(x, head, tail, n)
                # final certificate over a fresh harvest at the refined
                # sweep
                with torch.no_grad():
                    obs = _sweep_harvest(traj, occ, n, n_obs)
            with torch.no_grad():
                cert = svsdf_query(shape, traj, obs, _cert_cfg(stages),
                                   with_inside=False).sdf.amin(dim=1)
        return E2EBatchResult(ok, x, cost, cert, head, tail, obs,
                              traj.coeffs, traj.durations)


# ---------------------------------------------------------------------------
# sharded planning over a (scn, obs) mesh of ranks
# ---------------------------------------------------------------------------

def make_mesh(n_scn: int, n_obs: int, device=None) -> multihost.RankMesh:
    """A (scn, obs) mesh of the job's ranks, obs innermost. n_scn * n_obs
    must be the job's rank count (1 x 1 in a single process): a process
    is one device, where the JAX package may take the first n_scn * n_obs
    of a process's several devices. ``device=None`` is the rank's CUDA
    device (raises without a card)."""
    return multihost.RankMesh(n_scn, n_obs, device=device)


def _shard(mesh, x_b, head_b, tail_b, obs_b):
    """This rank's block of the whole batch: its scenario slice, and of
    each scenario's obstacles its obs shard (raises if a count does not
    divide by its mesh axis)."""
    scn = ("scn",)
    return (multihost.global_batch_array(x_b, mesh, scn),
            multihost.global_batch_array(head_b, mesh, scn),
            multihost.global_batch_array(tail_b, mesh, scn),
            multihost.global_batch_array(obs_b, mesh, ("scn", "obs")))


def _local_cost(shape, cfg, svs_cfg, n, n_obs_shards, head, tail, obs):
    """The rank's partial cost over its obstacle shard: the replicated
    base term (energy + rho * sum(T)) divided by the obs-shard count plus
    the shard's penalty, so that summing BOTH value and gradient over the
    obs row gives the whole cost and its gradient (summing the value
    alone leaves each rank with its own shard's penalty gradient). With
    one shard it is ``back_end.make_cost_fn``, the same expression."""
    prob = back_end.BackEndProblem(head, tail, obs)
    if n_obs_shards == 1:
        return back_end.make_cost_fn(shape, prob, cfg, svs_cfg, n)

    def cost(x):
        p = back_end._expand(prob, x.shape[0])
        traj, times = back_end._traj(x, p, n)
        pen, _ = back_end.svsdf_penalty(shape, traj, p.obstacles, cfg,
                                        svs_cfg)
        base = minco.energy(traj) + cfg.rho * torch.sum(times, -1)
        return base / n_obs_shards + pen

    return cost


def _obs_reduced(vg, mesh):
    """vg with f and g summed over the rank's obs row: one all_reduce of
    [f, g] per evaluation. Every rank of the row then holds the same bits,
    so the solver's host branches (done masks, line-search exits) agree
    and the row's ranks call the all_reduce in lockstep. With one obs
    shard there is nothing to reduce and no collective runs."""
    if mesh.shape["obs"] == 1:
        return vg
    group = mesh.obs_group

    def fun(x):
        f, g = vg(x)
        buf = torch.cat([f[:, None], g], dim=1).contiguous()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        return buf[:, 0], buf[:, 1:]

    return fun


def sharded_value_and_grad(shape, mesh, cfg: PlannerConfig,
                           svs_cfg: SVSDFConfig, n: int):
    """f(x_b, head_b, tail_b, obs_b) -> (cost, grad) of the rank's scenario
    slice, with obstacle points sharded over the mesh's obs axis and
    scenarios over scn; the obs-row partial costs and gradients are summed
    by an all_reduce."""
    n_obs_shards = mesh.shape["obs"]

    def run(x_b, head_b, tail_b, obs_b):
        x, head, tail, obs = _shard(mesh, x_b, head_b, tail_b, obs_b)
        vg = lbfgs.value_and_grad(_local_cost(shape, cfg, svs_cfg, n,
                                              n_obs_shards, head, tail, obs))
        return _obs_reduced(vg, mesh)(x)

    return run


def sharded_plan_batch(shape, mesh, cfg: PlannerConfig, svs_cfg: SVSDFConfig,
                       n: int, max_iters: int = 50, max_linesearch: int = 2):
    """The full sharded solve: the batched L-BFGS loop on each rank's
    scenario slice, every cost evaluation inside it summed over the obs
    row (so the row's ranks advance one identical solve in lockstep).
    Returns f(x_b, head_b, tail_b, obs_b) -> (x, cost, iters, converged)
    of the rank's scenario slice."""
    n_obs_shards = mesh.shape["obs"]
    params = lbfgs.LBFGSParams(mem_size=cfg.mem_size,
                               max_iterations=max_iters,
                               g_epsilon=1e-7, past=3,
                               delta=cfg.relCostTol,
                               max_linesearch=max_linesearch)

    def run(x_b, head_b, tail_b, obs_b):
        x, head, tail, obs = _shard(mesh, x_b, head_b, tail_b, obs_b)
        vg = lbfgs.value_and_grad(_local_cost(shape, cfg, svs_cfg, n,
                                              n_obs_shards, head, tail, obs))
        res = lbfgs.minimize(_obs_reduced(vg, mesh), x, params)
        return res.x, res.f, res.n_iters, res.converged

    return run


def sharded_step(shape, mesh, cfg: PlannerConfig, svs_cfg: SVSDFConfig,
                 n: int, lr: float = 1e-2):
    """One sharded gradient step over the batch: step(x_b, head_b, tail_b,
    obs_b) -> (x - lr * grad, cost) of the rank's scenario slice."""
    vg = sharded_value_and_grad(shape, mesh, cfg, svs_cfg, n)

    def step(x_b, head_b, tail_b, obs_b):
        cost, grad = vg(x_b, head_b, tail_b, obs_b)
        x = multihost.global_batch_array(x_b, mesh, ("scn",))
        return x - lr * grad, cost

    return step


def sharded_plan_batch_e2e(shape, mesh, cfg: PlannerConfig, stages: tuple,
                           n: int, n_obs: int, resolution, xy_min,
                           max_linesearch: int = 2, refine_rounds: int = 0,
                           refine_iters: int = 12, refine_esc: float = 4.0,
                           cert_margin: float = 0.0):
    """End-to-end planning with the scenarios split over the mesh's scn
    axis: the front end couples no scenarios, so each rank runs
    ``plan_batch_e2e`` on its slice with the map products (feas, occ_pts)
    replicated, and no collective runs at all. Returns f(feas, occ_pts,
    starts_ij, goals_ij) -> E2EBatchResult of the rank's slice."""
    def run(feas, occ_pts, starts_ij, goals_ij):
        starts = multihost.global_batch_array(starts_ij, mesh, ("scn",))
        goals = multihost.global_batch_array(goals_ij, mesh, ("scn",))
        return plan_batch_e2e(shape, feas, occ_pts, starts, goals, cfg,
                              stages, n, n_obs, resolution, xy_min,
                              max_linesearch, refine_rounds=refine_rounds,
                              refine_iters=refine_iters,
                              refine_esc=refine_esc,
                              cert_margin=cert_margin, device=mesh.device)

    return run
