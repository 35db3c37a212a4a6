"""Nonsmooth-capable L-BFGS, batch-native (svsdf_tpu/utils/lbfgs.py).

The JAX package vmaps a ``lax.while_loop`` solver over plans. Here the
solver works on a batch directly: x is (B, n), every carried quantity
has a leading lane axis, and the outer loop runs while any lane is
active, merging each step into the carry with
``torch.where(active, new, old)`` — the semantics of a vmapped
``while_loop``, so each lane follows exactly its own single-lane
iterates. The loop tests the done mask on the host once per iteration.

``minimize_scheduled`` adds the continuation hooks of the JAX package's
solver of the same name (an iteration budget, stage bounds the solver
jumps to on convergence, the lane's iteration counter passed to the
objective) and its live debug-bus wire; ``minimize`` is its special
case without them.

Objective contract (``minimize``; ``minimize_scheduled`` passes each
row's iteration counter as a second argument):
  * ``fun(x) -> (f (R,), g (R, n))`` or, with ``frozen``,
    ``fun(x) -> (f, g, state)`` where ``state`` is a tuple/NamedTuple
    of tensors with a leading lane axis;
  * ``frozen(x, state) -> (f~, g~)`` is the cheap surrogate.
  R is B, or B*C when the parallel line search evaluates C candidates
  per lane in one call: rows are lane-major (row r belongs to lane
  r // C), and the solver repeats ``state`` to match.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from svsdf_tpu_torch.utils.profiling import host_bool, span


@dataclasses.dataclass(frozen=True)
class LBFGSParams:
    mem_size: int = 16
    max_iterations: int = 300
    g_epsilon: float = 1e-6     # ||g||_inf termination
    past: int = 3               # delta-based convergence window
    delta: float = 1e-9         # relative cost-decrease tolerance
    max_linesearch: int = 40
    f_dec_coeff: float = 1e-4   # Armijo c1
    s_curv_coeff: float = 0.9   # weak-Wolfe c2
    cautious_factor: float = 1e-6
    init_step: float = 1.0
    max_nulls: int = 12         # consecutive null steps before giving up
    #: >0: parallel line search over this many geometric trial steps
    ls_candidates: int = 0
    #: accepted and ignored: in JAX the unroll factor of the two-loop
    #: recursion's lax.scan; the eager loop here has nothing to unroll
    scan_unroll: int = 4
    #: inverse-Hessian apply: compact representation (None -> True, the
    #: JAX package's default) or the two-loop recursion (False)
    compact: bool | None = None
    #: report every iteration (it, f, ||g||_inf) to the debug bus,
    #: service its pause/step gate and stop on its stop flag (the
    #: reference's DBSendOptiStep live wire); single solves only
    live: bool = False


class LBFGSResult(NamedTuple):
    x: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    n_iters: torch.Tensor
    converged: torch.Tensor


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _norm(a):
    return torch.sqrt(torch.sum(a * a, dim=-1))


def _sel(mask, a, b):
    """torch.where with a lane mask (B,) broadcast over trailing dims."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def _tree_sel(mask, a, b):
    if a is None:
        return None
    if torch.is_tensor(a):
        return _sel(mask, a, b)
    return type(a)(*(_tree_sel(mask, x, y) for x, y in zip(a, b)))


def _tree_repeat(a, rep):
    if a is None or rep == 1:
        return a
    if torch.is_tensor(a):
        return a.repeat_interleave(rep, dim=0)
    return type(a)(*(_tree_repeat(x, rep) for x in a))


def _weak_wolfe_search(fun, x, f0, g0, d, p: LBFGSParams, t0, live):
    """Lewis–Overton bisection line search as a masked per-lane loop.
    ``live`` marks the lanes whose result is used. Returns
    (t, x_new, f_new, g_new, ok, x_trial, g_trial)."""
    dg0 = _dot(g0, d)
    nb = x.shape[0]
    k = torch.zeros(nb, dtype=torch.long, device=x.device)
    t = t0
    lo = torch.zeros_like(f0)
    hi = torch.full_like(f0, math.inf)
    xt, ft, gt = x, f0, g0
    ok = torch.zeros(nb, dtype=torch.bool, device=x.device)
    while True:
        run = live & (k < p.max_linesearch) & ~ok
        if not host_bool(torch.any(run), "lbfgs.wolfe"):
            break
        xt_n = x + t[:, None] * d
        ft_n, gt_n = fun(xt_n)
        armijo = ft_n <= f0 + p.f_dec_coeff * t * dg0
        curv = _dot(gt_n, d) >= p.s_curv_coeff * dg0
        ok_n = armijo & curv
        new_hi = torch.where(armijo, hi, t)
        new_lo = torch.where(armijo & ~curv, t, lo)
        new_t = torch.where(
            ok_n, t,
            torch.where(torch.isinf(new_hi),
                        2.0 * torch.maximum(new_lo, t),
                        0.5 * (new_lo + new_hi)))
        k = torch.where(run, k + 1, k)
        t = torch.where(run, new_t, t)
        lo = torch.where(run, new_lo, lo)
        hi = torch.where(run, new_hi, hi)
        xt = _sel(run, xt_n, xt)
        ft = torch.where(run, ft_n, ft)
        gt = _sel(run, gt_n, gt)
        ok = torch.where(run, ok_n, ok)
    # accept a decrease even without Wolfe (nonsmooth kinks)
    accept = ok | (ft < f0)
    x_new = _sel(accept, xt, x)
    f_new = torch.where(accept, ft, f0)
    g_new = _sel(accept, gt, g0)
    return t, x_new, f_new, g_new, accept, xt, gt


#: geometric trial-step grid of the parallel search, descending so
#: "largest Armijo-passing step" = first passing entry
_LS_GRID = (2.0, 1.0, 0.5, 0.25, 0.125, 0.0625, 0.03125, 0.015625,
            0.0078125, 0.00390625, 0.001953125, 0.0009765625)


def _parallel_line_search(fun, x, f0, g0, d, p: LBFGSParams, t0, live):
    """Evaluate ls_candidates trial steps of every lane in one (B*C)
    call; pick the largest Armijo-passing one, else the best plain
    decrease, else a null step."""
    del live
    dg0 = _dot(g0, d)
    nb, n = x.shape
    c = p.ls_candidates
    grid = torch.as_tensor(_LS_GRID[:c], dtype=x.dtype, device=x.device)
    ts = t0[:, None] * grid                                  # (B, C)
    xt = x[:, None] + ts[..., None] * d[:, None]             # (B, C, n)
    ft, gt = fun(xt.reshape(nb * c, n))
    ft = ft.reshape(nb, c)
    gt = gt.reshape(nb, c, n)
    armijo = ft <= f0[:, None] + p.f_dec_coeff * ts * dg0[:, None]
    any_armijo = torch.any(armijo, dim=1)
    first_pass = torch.argmax(armijo.to(torch.int32), dim=1)
    best = torch.argmin(ft, dim=1)
    pick = torch.where(any_armijo, first_pass, best)
    t = torch.gather(ts, 1, pick[:, None])[:, 0]
    fp = torch.gather(ft, 1, pick[:, None])[:, 0]
    xp = torch.gather(xt, 1, pick[:, None, None].expand(nb, 1, n))[:, 0]
    gp = torch.gather(gt, 1, pick[:, None, None].expand(nb, 1, n))[:, 0]
    accept = any_armijo | (fp < f0)
    x_new = _sel(accept, xp, x)
    f_new = torch.where(accept, fp, f0)
    g_new = _sel(accept, gp, g0)
    return t, x_new, f_new, g_new, accept, xp, gp


def two_loop(g, s_hist, y_hist, rho, n_corr, head):
    """Two-loop recursion over each lane's ring buffer: H g (B, n)."""
    nb, m, _ = s_hist.shape
    ar = torch.arange(m, device=g.device)
    lanes = torch.arange(nb, device=g.device)
    idxs = (head[:, None] - 1 - ar) % m                     # newest->oldest
    valid = ar[None] < n_corr[:, None]                       # (B, m)
    q = g
    alphas = []
    for i in range(m):
        j = idxs[:, i]
        s, y, r = s_hist[lanes, j], y_hist[lanes, j], rho[lanes, j]
        a = torch.where(valid[:, i], r * _dot(s, q), torch.zeros_like(r))
        q = q - a[:, None] * y * valid[:, i, None]
        alphas.append(a)
    newest = idxs[:, 0]
    sn, yn = s_hist[lanes, newest], y_hist[lanes, newest]
    sy = _dot(sn, yn)
    yy = _dot(yn, yn)
    gamma = torch.where((n_corr > 0) & (yy > 0),
                        sy / torch.clamp_min(yy, 1e-30), torch.ones_like(yy))
    r_ = q * gamma[:, None]
    for i in range(m):
        ii = m - 1 - i                                       # oldest->newest
        j = idxs[:, ii]
        s, y, rh = s_hist[lanes, j], y_hist[lanes, j], rho[lanes, j]
        b = torch.where(valid[:, ii], rh * _dot(y, r_), torch.zeros_like(rh))
        r_ = r_ + (alphas[ii] - b)[:, None] * s * valid[:, ii, None]
    return r_


def compact_apply(g, s_hist, y_hist, rho, n_corr, head):
    """H g via the compact representation (Byrd–Nocedal–Schnabel 1994),
    columns oldest->newest, invalid slots neutralised (zero column,
    unit diagonal). Equal to two_loop's H for the same pairs."""
    del rho
    nb, m, n = s_hist.shape
    ar = torch.arange(m, device=g.device)
    lanes = torch.arange(nb, device=g.device)
    order = (head[:, None] - m + ar) % m                     # (B, m)
    valid = ar[None] >= (m - n_corr[:, None])
    gidx = order[..., None].expand(nb, m, n)
    S = torch.where(valid[..., None], torch.gather(s_hist, 1, gidx),
                    torch.zeros((), dtype=g.dtype, device=g.device))
    Y = torch.where(valid[..., None], torch.gather(y_hist, 1, gidx),
                    torch.zeros((), dtype=g.dtype, device=g.device))
    StY = S @ Y.transpose(1, 2)                              # (B, m, m)
    D = torch.diagonal(StY, dim1=1, dim2=2)
    R = torch.triu(StY) + torch.diag_embed(
        torch.where(valid, torch.zeros_like(D), torch.ones_like(D)))
    YtY = Y @ Y.transpose(1, 2)
    newest = (head - 1) % m
    sn, yn = s_hist[lanes, newest], y_hist[lanes, newest]
    sy = _dot(sn, yn)
    yy = _dot(yn, yn)
    gamma = torch.where((n_corr > 0) & (yy > 0),
                        sy / torch.clamp_min(yy, 1e-30), torch.ones_like(yy))
    p_ = (S @ g[..., None])                                  # (B, m, 1)
    q = (Y @ g[..., None])
    t1 = torch.linalg.solve_triangular(R, p_, upper=True)
    t2 = D[..., None] * t1 + gamma[:, None, None] * (YtY @ t1) \
        - gamma[:, None, None] * q
    t3 = torch.linalg.solve_triangular(R.transpose(1, 2), t2, upper=False)
    return (gamma[:, None] * g + (t3.transpose(1, 2) @ S)[:, 0]
            - gamma[:, None] * (t1.transpose(1, 2) @ Y)[:, 0])


def minimize(fun: Callable, x0, params: LBFGSParams = LBFGSParams(),
             frozen: Callable | None = None) -> LBFGSResult:
    """Minimize a batch of independent objectives, x0 (B, n).

    Without ``frozen``: fun(x) -> (f, g). With ``frozen`` (frozen-oracle
    line search): fun(x) -> (f, g, state) and frozen(x, state) -> (f~, g~);
    the line search runs on the surrogate at the carried state and the
    true cost is evaluated once per iteration, at the chosen trial
    point, behind an Armijo gate on the true cost."""
    if frozen is None:
        return minimize_scheduled(lambda x, it: fun(x), x0, params)
    return minimize_scheduled(lambda x, it: fun(x), x0, params,
                              frozen=lambda x, it, st: frozen(x, st))


def _live_observer(it, f, gnorm) -> bool:
    """Host side of LBFGSParams.live: record the iteration on the debug
    bus, service its pause/step gate, and report whether a stop was
    requested."""
    from svsdf_tpu_torch.utils.debugbus import BUS

    BUS.log_scalar("opti_cost", float(f), step=int(it))
    BUS.log_scalar("opti_gnorm", float(gnorm), step=int(it))
    BUS.wait_if_paused()
    return BUS.stop_requested


def minimize_scheduled(fun: Callable, x0,
                       params: LBFGSParams = LBFGSParams(),
                       n_iters=None, stage_bounds=None,
                       frozen: Callable | None = None) -> LBFGSResult:
    """Minimize fun(x, it) -> (f, g) for a batch x0 (B, n), where ``it``
    (R,) is each row's lane iteration counter: the hook for continuation
    schedules (the back end's hinge-smoothing mu ladder) to live inside
    one optimizer loop.

    n_iters: optional iteration budget (<= params.max_iterations).

    stage_bounds: optional (S,) iteration indices where the objective
    changes. A lane that converges before the last bound jumps to the
    next bound (entering the next stage) instead of finishing, clears
    its stall and null-step state and re-evaluates f and g there.
    Curvature pairs carry across stages.

    frozen: optional surrogate (x, it, state) -> (f~, g~); fun is then
    (x, it) -> (f, g, state), as in ``minimize``. With ``params.live``
    the debug bus sees every iteration of lane 0 (a single-solve path,
    B = 1) and its stop flag ends the solve."""
    p = params
    nb, n = x0.shape
    m = p.mem_size
    dtype, dev = x0.dtype, x0.device
    use_compact = True if p.compact is None else p.compact
    apply_h = compact_apply if use_compact else two_loop
    search = (_parallel_line_search if p.ls_candidates > 0
              else _weak_wolfe_search)
    if p.live and nb != 1:
        raise ValueError("live=True observes a single solve (B = 1)")
    total = p.max_iterations if n_iters is None else int(n_iters)
    bounds = (None if stage_bounds is None else torch.as_tensor(
        stage_bounds, dtype=torch.long, device=dev).reshape(-1))

    def rows(it, xx):
        return _tree_repeat(it, xx.shape[0] // nb)

    it = torch.zeros(nb, dtype=torch.long, device=dev)
    if frozen is None:
        f, g = fun(x0, it)
        fro = None
    else:
        f, g, fro = fun(x0, it)
    x = x0
    ga = g
    s_hist = torch.zeros((nb, m, n), dtype=dtype, device=dev)
    y_hist = torch.zeros((nb, m, n), dtype=dtype, device=dev)
    rho = torch.zeros((nb, m), dtype=dtype, device=dev)
    n_corr = torch.zeros(nb, dtype=torch.long, device=dev)
    head = torch.zeros(nb, dtype=torch.long, device=dev)
    past_f = torch.full((nb, p.past), math.inf, dtype=dtype, device=dev)
    past_f[:, 0] = f
    nulls = torch.zeros(nb, dtype=torch.long, device=dev)
    done = torch.amax(torch.abs(g), dim=1) < p.g_epsilon
    converged = done.clone()
    lanes = torch.arange(nb, device=dev)

    while True:
        active = ~done & (it < total) & (it < p.max_iterations)
        if not host_bool(torch.any(active), "lbfgs.active"):
            break
        with span("lbfgs.direction"):
            d = -apply_h(ga, s_hist, y_hist, rho, n_corr, head)
            dg = _dot(d, ga)
            d = _sel(dg < 0, d, -ga)
            t0 = torch.where(n_corr == 0,
                             1.0 / torch.clamp_min(_norm(d), 1.0),
                             torch.full_like(dg, p.init_step))
        it_c = it
        if frozen is None:
            with span("lbfgs.line_search"):
                t, x_new, f_new, g_new, ok, _, g_trial = search(
                    lambda xt: fun(xt, rows(it_c, xt)), x, f, ga, d, p, t0,
                    active)
            fro_new = fro
        else:
            fro_c = fro

            def fro_fun(xt):
                return frozen(xt, rows(it_c, xt),
                              _tree_repeat(fro_c, xt.shape[0] // nb))

            with span("lbfgs.line_search"):
                t, _, _, _, _, x_trial, _ = search(
                    fro_fun, x, f, ga, d, p, t0, active)
            f_t, g_t, fro_t = fun(x_trial, it_c)
            ok = f_t <= f + p.f_dec_coeff * t * _dot(ga, d)
            x_new = _sel(ok, x_trial, x)
            f_new = torch.where(ok, f_t, f)
            g_new = _sel(ok, g_t, g)
            g_trial = g_t
            fro_new = _tree_sel(ok, fro_t, fro)

        s = x_new - x
        y = g_new - g
        sy = _dot(s, y)
        gnorm = _norm(g)
        do_update = ok & (sy > p.cautious_factor * _dot(s, s) * gnorm)
        s_upd = s_hist.clone()
        s_upd[lanes, head] = s
        y_upd = y_hist.clone()
        y_upd[lanes, head] = y
        rho_upd = rho.clone()
        rho_upd[lanes, head] = 1.0 / torch.clamp_min(sy, 1e-30)
        s_hist_n = _sel(do_update, s_upd, s_hist)
        y_hist_n = _sel(do_update, y_upd, y_hist)
        rho_n = _sel(do_update, rho_upd, rho)
        head_n = torch.where(do_update, (head + 1) % m, head)
        n_corr_n = torch.where(do_update, torch.clamp_max(n_corr + 1, m),
                               n_corr)

        # LMBM-style null step: aggregate the rejected trial's
        # subgradient with the current aggregate (min-norm convex
        # combination) and stay at x
        diff = g_trial - ga
        denom = _dot(diff, diff)
        lam = torch.clamp(_dot(ga, ga - g_trial)
                          / torch.clamp_min(denom, 1e-30), 0.0, 1.0)
        ga_null = lam[:, None] * g_trial + (1.0 - lam)[:, None] * ga
        ga_n = _sel(ok, g_new, ga_null)
        nulls_n = torch.where(ok, torch.zeros_like(nulls), nulls + 1)

        g_inf = torch.amax(torch.abs(ga_n), dim=1) / torch.clamp_min(
            _norm(x_new), 1.0)
        small_grad = g_inf < p.g_epsilon
        slot = it % p.past
        fpast = torch.gather(past_f, 1, slot[:, None])[:, 0]
        rel_dec = (fpast - f_new) / torch.clamp_min(torch.abs(f_new), 1e-30)
        stalled = ok & (it >= p.past) & (rel_dec < p.delta)
        conv_n = small_grad | stalled
        finished = conv_n | (nulls_n >= p.max_nulls)
        past_n = past_f.clone()
        past_n[lanes, slot] = f_new
        g_at_x = _sel(ok, g_new, g)
        it_n = it + 1
        done_n = finished
        if bounds is not None:
            # a lane that finished a stage early jumps to the next stage
            # bound (the objective changes there) with cleared stall and
            # null state and f, g re-evaluated under the new objective;
            # only finishing the last stage ends its solve
            nxt = torch.amin(torch.where(bounds[None] > it[:, None],
                                         bounds[None],
                                         torch.full_like(bounds[None],
                                                         total)), dim=1)
            jump = finished & (nxt < total)
            it_n = torch.where(jump, nxt, it_n)
            nulls_n = torch.where(jump, torch.zeros_like(nulls_n), nulls_n)
            past_n = _sel(jump, torch.full_like(past_n, math.inf), past_n)
            done_n = finished & ~jump
            if host_bool(torch.any(jump & active), "lbfgs.jump"):
                if frozen is None:
                    f_j, g_j = fun(x_new, nxt)
                else:
                    f_j, g_j, fro_j = fun(x_new, nxt)
                    fro_new = _tree_sel(jump, fro_j, fro_new)
                f_new = torch.where(jump, f_j, f_new)
                g_at_x = _sel(jump, g_j, g_at_x)
                ga_n = _sel(jump, g_j, ga_n)
        if p.live:
            stop = _live_observer(it[0], f_new[0],
                                  torch.amax(torch.abs(ga_n[0])))
            done_n = done_n | stop

        x = _sel(active, x_new, x)
        f = torch.where(active, f_new, f)
        g = _sel(active, g_at_x, g)
        ga = _sel(active, ga_n, ga)
        fro = _tree_sel(active, fro_new, fro)
        s_hist = _sel(active, s_hist_n, s_hist)
        y_hist = _sel(active, y_hist_n, y_hist)
        rho = _sel(active, rho_n, rho)
        n_corr = torch.where(active, n_corr_n, n_corr)
        head = torch.where(active, head_n, head)
        past_f = _sel(active, past_n, past_f)
        nulls = torch.where(active, nulls_n, nulls)
        it = torch.where(active, it_n, it)
        done = torch.where(active, done_n, done)
        converged = torch.where(active, conv_n, converged)

    return LBFGSResult(x, f, g, it, converged)


def value_and_grad(cost: Callable) -> Callable:
    """x (R, n) -> (cost (R,), per-row gradient (R, n)); rows are
    independent, so the gradient of the summed cost is per row."""
    def vg(x):
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            f = cost(xr)
            (g,) = torch.autograd.grad(f.sum(), xr)
        return f.detach(), g
    return vg
