"""Limited-Memory Bundle Method, batch-native (svsdf_tpu/utils/lmbm.py).

The reference back end's solver (lmbm.h:214, lmbm_main.f / lmbm_sub.f;
Haarala-Miettinen-Makela 2004) as the JAX package re-designs it:

  * a limited-memory L-BFGS metric D (the two-loop recursion of
    utils/lbfgs.py);
  * the SERIOUS / NULL step dichotomy with a halving line search: a
    serious step needs sufficient decrease, otherwise the trial point's
    subgradient enters the bundle and x stays;
  * the 3-element subgradient aggregation of lmbm_sub.f: minimise over
    the simplex phi(l) = ||l1 xi_m + l2 xi_k + l3 xi_a||_D^2
    + 2 (l2 beta_k + l3 beta_a), with the subgradient locality measures
    beta = max(|f(x) - f(y) + xi.(x - y)|, gamma ||x - y||^2), solved in
    closed form over the simplex's 7 faces (``_simplex_qp3``);
  * the stopping test w = ||xi_agg||_D^2 + 2 beta_agg <= eps.

Where the JAX package vmaps a ``lax.while_loop`` over problems, here x is
(B, n) and every carried quantity has a leading lane axis; the loops run
while any lane is active and merge each step with ``torch.where`` (the
semantics of a vmapped while-loop), so each lane follows its own
single-lane iterates. ``minimize`` is the batch; ``minimize_batched`` is
the same function under the JAX package's name.

Objective: fun(x (B, n)) -> (f (B,), subgradient (B, n)).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from svsdf_tpu_torch.utils.lbfgs import _dot, _norm, _sel, two_loop


class LMBMParams(NamedTuple):
    mem_size: int = 7
    max_iterations: int = 200
    eps: float = 1e-5           # stopping tolerance on w
    gamma: float = 0.25         # distance-measure parameter (rpar(4))
    eps_l: float = 1e-4         # sufficient-decrease coeff (rpar(2) epsl)
    eps_r: float = 0.25         # null-step threshold coeff
    theta_max: float = 2.0      # max step
    t_min: float = 1e-12
    max_nulls: int = 30         # consecutive nulls before giving up
    delta: float = 1e-9         # relative cost stall tolerance
    past: int = 5


class LMBMResult(NamedTuple):
    x: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor             # final aggregate subgradient
    n_iters: torch.Tensor
    converged: torch.Tensor


def _simplex_qp3(G, b):
    """argmin over the 3-simplex of l^T G l + 2 b^T l, for each lane:
    G (B, 3, 3) PSD, b (B, 3) -> l (B, 3). Evaluates all 7 faces (3
    vertices, 3 edges, the interior) and keeps the feasible minimiser."""
    nb = G.shape[0]
    eye = torch.eye(3, dtype=G.dtype, device=G.device)
    cands = [eye[0].expand(nb, 3), eye[1].expand(nb, 3),
             eye[2].expand(nb, 3)]
    # edges: l = (u, 1-u) on the pairs (i, j), a quadratic in u
    for i, j in ((0, 1), (0, 2), (1, 2)):
        a2 = G[:, i, i] - 2 * G[:, i, j] + G[:, j, j]
        a1 = G[:, i, j] - G[:, j, j] + b[:, i] - b[:, j]
        u = torch.clamp(-a1 / torch.clamp_min(a2, 1e-30), 0.0, 1.0)
        u = torch.where(a2 > 1e-30, u,
                        torch.where(a1 > 0, torch.zeros_like(u),
                                    torch.ones_like(u)))
        li = torch.zeros((nb, 3), dtype=G.dtype, device=G.device)
        li[:, i] = u
        li[:, j] = 1.0 - u
        cands.append(li)
    # interior: the KKT system (G l + b = nu 1, 1^T l = 1)
    gr = G + 1e-10 * eye
    kkt = torch.zeros((nb, 4, 4), dtype=G.dtype, device=G.device)
    kkt[:, :3, :3] = 2.0 * gr
    kkt[:, :3, 3] = 1.0
    kkt[:, 3, :3] = 1.0
    rhs = torch.cat([-2.0 * b, torch.ones((nb, 1), dtype=G.dtype,
                                          device=G.device)], dim=1)
    # a singular system (a degenerate bundle) gives non-finite l, which
    # the feasibility test rejects, as jnp.linalg.solve's does
    l_int = torch.linalg.solve_ex(kkt, rhs)[0][:, :3]
    feas = torch.all(l_int >= -1e-9, dim=1)
    cands.append(_sel(feas, torch.clamp(l_int, 0.0, 1.0), cands[0]))
    L = torch.stack(cands, dim=1)                          # (B, 7, 3)
    L = L / torch.clamp_min(L.sum(-1, keepdim=True), 1e-30)
    vals = (torch.einsum("bki,bij,bkj->bk", L, G, L)
            + 2.0 * torch.einsum("bki,bi->bk", L, b))
    pick = torch.argmin(vals, dim=1)
    return L[torch.arange(nb, device=G.device), pick]


def minimize(fun: Callable, x0, params: LMBMParams = LMBMParams()
             ) -> LMBMResult:
    """Minimise the nonsmooth objectives fun: x (B, n) -> (f, subgradient)
    of a batch, lane by lane."""
    p = params
    nb, n = x0.shape
    m = p.mem_size
    dtype, dev = x0.dtype, x0.device

    def fun_c(x):
        f, g = fun(x)
        return f.to(dtype), g.to(dtype)

    x = x0
    f, g = fun_c(x0)
    ga = g
    beta_a = torch.zeros(nb, dtype=dtype, device=dev)
    s_hist = torch.zeros((nb, m, n), dtype=dtype, device=dev)
    y_hist = torch.zeros((nb, m, n), dtype=dtype, device=dev)
    rho = torch.zeros((nb, m), dtype=dtype, device=dev)
    n_corr = torch.zeros(nb, dtype=torch.long, device=dev)
    head = torch.zeros(nb, dtype=torch.long, device=dev)
    past_f = torch.full((nb, p.past), float("inf"), dtype=dtype, device=dev)
    past_f[:, 0] = f
    nulls = torch.zeros(nb, dtype=torch.long, device=dev)
    it = torch.zeros(nb, dtype=torch.long, device=dev)
    done = _dot(g, g) < p.eps
    converged = done.clone()
    lanes = torch.arange(nb, device=dev)

    while True:
        active = ~done & (it < p.max_iterations)
        if not bool(torch.any(active)):
            break
        d = -two_loop(ga, s_hist, y_hist, rho, n_corr, head)
        dga = _dot(d, ga)
        d = _sel(dga < 0, d, -ga)              # safeguard descent
        # desirable decrease w = -xi_a.d + 2 beta_a
        w = torch.clamp_min(-_dot(ga, d) + 2.0 * beta_a, 1e-30)

        # two-point line search, the move capped at theta_max
        dnorm = torch.clamp_min(_norm(d), 1e-30)
        t = torch.clamp_max(p.theta_max / dnorm, 1.0)
        fy, gy = fun_c(x + t[:, None] * d)
        serious = fy <= f - p.eps_l * t * w
        t_eval = t
        t_next = torch.where(serious, t, 0.5 * t)
        k = 1
        while True:
            run = active & ~serious & (t_next > p.t_min)
            if k >= 10 or not bool(torch.any(run)):
                break
            fy_n, gy_n = fun_c(x + t_next[:, None] * d)
            ser_n = fy_n <= f - p.eps_l * t_next * w
            fy = torch.where(run, fy_n, fy)
            gy = _sel(run, gy_n, gy)
            serious = torch.where(run, ser_n, serious)
            t_eval = torch.where(run, t_next, t_eval)
            t_next = torch.where(run & ~ser_n, 0.5 * t_next, t_next)
            k += 1
        y = x + t_eval[:, None] * d

        # serious step: the metric's curvature pair
        s = y - x
        u = gy - g
        sy = _dot(s, u)
        do_update = serious & (sy > 1e-12)
        s_upd = s_hist.clone()
        s_upd[lanes, head] = s
        y_upd = y_hist.clone()
        y_upd[lanes, head] = u
        rho_upd = rho.clone()
        rho_upd[lanes, head] = 1.0 / torch.clamp_min(sy, 1e-30)
        s_hist_n = _sel(do_update, s_upd, s_hist)
        y_hist_n = _sel(do_update, y_upd, y_hist)
        rho_n = _sel(do_update, rho_upd, rho)
        head_n = torch.where(do_update, (head + 1) % m, head)
        n_corr_n = torch.where(do_update, torch.clamp_max(n_corr + 1, m),
                               n_corr)

        # null step: 3-subgradient aggregation under the old metric
        dxy = y - x
        beta_k = torch.maximum(torch.abs(f - fy + _dot(gy, dxy)),
                               p.gamma * _dot(dxy, dxy))
        xs = torch.stack([g, gy, ga], dim=1)               # (B, 3, n)
        dx = torch.stack([two_loop(xs[:, i], s_hist, y_hist, rho, n_corr,
                                  head) for i in range(3)], dim=1)
        G = xs @ dx.transpose(1, 2)
        G = 0.5 * (G + G.transpose(1, 2))
        bvec = torch.stack([torch.zeros_like(beta_k), beta_k, beta_a], 1)
        lam = _simplex_qp3(G, bvec)
        ga_new = (lam[:, :, None] * xs).sum(1)
        beta_new = lam[:, 1] * beta_k + lam[:, 2] * beta_a

        x_n = _sel(serious, y, x)
        f_n = torch.where(serious, fy, f)
        g_n = _sel(serious, gy, g)
        ga_n = _sel(serious, gy, ga_new)
        beta_n = torch.where(serious, torch.zeros_like(beta_new), beta_new)
        nulls_n = torch.where(serious, torch.zeros_like(nulls), nulls + 1)

        # restart (lmbm_main.f irest): a near-zero aggregate with a large
        # locality measure means the bundle's subgradients cancelled;
        # reset to the subgradient at x and drop the metric
        deadlock = (~serious & (_dot(ga_n, ga_n) < 1e-4 * _dot(g_n, g_n))
                    & (beta_n > p.eps))
        ga_n = _sel(deadlock, g_n, ga_n)
        beta_n = torch.where(deadlock, torch.zeros_like(beta_n), beta_n)
        n_corr_n = torch.where(deadlock, torch.zeros_like(n_corr_n),
                               n_corr_n)

        # stopping: w_stop = xi_a . D xi_a + 2 beta_a
        w_stop = _dot(ga_n, two_loop(ga_n, s_hist_n, y_hist_n, rho_n,
                                    n_corr_n, head_n)) + 2.0 * beta_n
        small = w_stop < p.eps
        slot = it % p.past
        fpast = torch.gather(past_f, 1, slot[:, None])[:, 0]
        rel_dec = (fpast - f_n) / torch.clamp_min(torch.abs(f_n), 1e-30)
        stalled = serious & (it >= p.past) & (rel_dec < p.delta)
        conv_n = small | stalled
        done_n = conv_n | (nulls_n >= p.max_nulls)
        past_n = past_f.clone()
        past_n[lanes, slot] = f_n

        x = _sel(active, x_n, x)
        f = torch.where(active, f_n, f)
        g = _sel(active, g_n, g)
        ga = _sel(active, ga_n, ga)
        beta_a = torch.where(active, beta_n, beta_a)
        s_hist = _sel(active, s_hist_n, s_hist)
        y_hist = _sel(active, y_hist_n, y_hist)
        rho = _sel(active, rho_n, rho)
        n_corr = torch.where(active, n_corr_n, n_corr)
        head = torch.where(active, head_n, head)
        past_f = _sel(active, past_n, past_f)
        nulls = torch.where(active, nulls_n, nulls)
        it = torch.where(active, it + 1, it)
        done = torch.where(active, done_n, done)
        converged = torch.where(active, conv_n, converged)

    return LMBMResult(x, f, ga, it, converged)


def minimize_batched(fun: Callable, x0_batch,
                     params: LMBMParams = LMBMParams()) -> LMBMResult:
    """The JAX package's vmapped entry point: here ``minimize`` is
    already the batch."""
    return minimize(fun, x0_batch, params)
