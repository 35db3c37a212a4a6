"""Implicit swept-volume SDF queries, batched over plans
(svsdf_tpu/ops/svsdf.py).

For each query point the swept-volume SDF is the minimum over
trajectory time of the robot SDF. ``tstar_search_batch`` takes it from
a dense coarse scan over K shared time samples (the CUDA kernel of
ops/cuda_svsdf.py on the card) refined either by the table parabola
through the argmin's neighbours or by wide refinement rounds. Points
inside the swept volume get the GSIP expanding-disk interior distance
(``_gsip_inside``).

All functions take a leading plan axis: trajectory (B, N, 6, 3),
points (B, M, 2); results are (B, M) / (B, M, 2). Where the JAX package
runs a batch-global ``lax.cond`` under vmap, this module runs the branch
if any plan needs it and then selects per plan.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from svsdf_tpu_torch.ops import cuda_svsdf
from svsdf_tpu_torch.utils import trajectory as trj
from svsdf_tpu_torch.utils.profiling import host_bool, span

PI = math.pi

#: per-GSIP-iteration theta resolution schedule (SampleSet2D
#: initSet/expandSet: theta_res0 = pi+0.1, /=3 each expand, floor 0.3)
_GSIP_THETA_RES = []
_tr = PI + 0.1
for _ in range(16):
    _GSIP_THETA_RES.append(_tr)
    _tr = max(0.3, _tr / 3.0)


@dataclasses.dataclass(frozen=True)
class SVSDFConfig:
    """Search-resolution knobs; fields and defaults as the JAX package.
    ``use_pallas`` and ``pallas_min_points`` are accepted and ignored:
    on CUDA the coarse scan is always the kernel. ``gsip_fori`` is
    accepted and ignored too: in JAX it pads every GSIP round to one
    shape for ``fori_loop``, with the same values; the eager loop here
    has no shape to fix."""
    coarse_n: int = 256
    refine_rounds: int = 3
    refine_n: int = 32
    gsip_iters: int = 8
    gsip_max_samples: int = 21
    gsip_r0: float = 10.0
    gsip_tol: float = 0.1
    gsip_coarse_n: int = 96
    gsip_refine_rounds: int = 0
    use_inside: bool = True
    gsip_topk: int = 0
    scan_dtype: str | None = None
    gsip_fori: bool = False
    refine_interp_n: int = 0
    use_pallas: bool | None = None
    pallas_min_points: int = 4096


DEFAULT_CONFIG = SVSDFConfig()


class SVSDFResult(NamedTuple):
    sdf: torch.Tensor         # (B, M) swept-volume SDF (negative inside)
    t_star: torch.Tensor      # (B, M) minimizing trajectory time
    grad_world: torch.Tensor  # (B, M, 2) world-frame spatial gradient


def sdf_at_time(shape, traj: trj.Trajectory, p_world, t):
    """Robot SDF at world points for trajectory times t
    (getSDFAtTimeStamp, sw_manager.hpp:738-752). t has the plan axis
    first, (B, ...); p_world (B, ..., 2) broadcasts against it."""
    t = torch.as_tensor(t, dtype=traj.coeffs.dtype, device=traj.coeffs.device)
    xy, _, R = trj.state_se2(traj, t)
    p_rel = trj.world_to_body(xy, R, p_world)
    return shape.sdf_t(p_rel, t)


class PoseTable(NamedTuple):
    """Trajectory poses at K shared time samples per plan."""
    ts: torch.Tensor      # (B, K)
    xy: torch.Tensor      # (B, K, 2)
    cos: torch.Tensor     # (B, K)
    sin: torch.Tensor     # (B, K)


def linspace(stop, n: int):
    """jnp.linspace(0, stop, n) per plan: stop (B,) -> (B, n), computed
    as JAX does (stop * (k / (n-1)), exact endpoint)."""
    step = (torch.arange(n - 1, dtype=stop.dtype, device=stop.device)
            / (n - 1))
    return torch.cat([stop[:, None] * step, stop[:, None]], dim=1)


def linspace_1d(start: float, stop: float, n: int, dtype, device):
    """jnp.linspace(start, stop, n) for Python-float bounds, rounded as
    XLA compiles it on the CPU: the division by n-1 becomes a product
    with the reciprocal, and for start == 0 the product reassociates to
    (stop * (1/(n-1))) * k; exact endpoint."""
    if n == 1:
        return torch.full((1,), start, dtype=dtype, device=device)
    k = torch.arange(n - 1, dtype=dtype, device=device)
    rcp = 1.0 / (n - 1)
    if start == 0.0:
        out = (stop * rcp) * k
    else:
        step = k * rcp
        out = start * (1 - step) + stop * step
    return torch.cat([out, torch.full((1,), stop, dtype=dtype,
                                      device=device)])


def make_pose_table(traj: trj.Trajectory, n: int) -> PoseTable:
    ts = linspace(traj.total_duration, n)
    xy, yaw, _ = trj.state_se2(traj, ts)
    return PoseTable(ts, xy, torch.cos(yaw), torch.sin(yaw))


def _sdf_from_table(shape, table: PoseTable, points, dtype=None):
    """SDF of M points at the table's K shared times: (B, M, K)."""
    if dtype is not None:
        dt = cuda_svsdf.scan_type(dtype)
        table = PoseTable(*(v.to(dt) for v in table))
        points = points.to(dt)
    d = points[:, :, None, :] - table.xy[:, None]
    c, s = table.cos[:, None], table.sin[:, None]
    prx = c * d[..., 0] + s * d[..., 1]
    pry = -s * d[..., 0] + c * d[..., 1]
    return shape.sdf_xy_t(prx, pry, table.ts[:, None])


def _sdf_points_times(shape, traj, points, t):
    """SDF of M points, each at its own S times: points (B, M, 2),
    t (B, M, S) -> (B, M, S), by exact per-point pose evaluation."""
    xy, yaw, _ = trj.state_se2(traj, t)
    d = points[:, :, None, :] - xy
    c, s = torch.cos(yaw), torch.sin(yaw)
    prx = c * d[..., 0] + s * d[..., 1]
    pry = -s * d[..., 0] + c * d[..., 1]
    return shape.sdf_xy_t(prx, pry, t)


class FineTable(NamedTuple):
    """Dense (xy, yaw) pose samples for interpolated pose reads."""
    xy: torch.Tensor    # (B, K_f, 2)
    yaw: torch.Tensor   # (B, K_f)


def make_fine_table(traj: trj.Trajectory, n: int) -> FineTable:
    ts = linspace(traj.total_duration, n)
    xy, yaw, _ = trj.state_se2(traj, ts)
    return FineTable(xy, yaw)


def _sdf_points_times_interp(shape, ft: FineTable, total, points, t):
    """_sdf_points_times with the pose lerped from a shared fine table."""
    b, kf = ft.yaw.shape
    tot = total.reshape(b, *([1] * (t.dim() - 1)))
    u = torch.clamp(t / tot, 0.0, 1.0) * (kf - 1)
    i0 = torch.clamp(u.to(torch.int32), 0, kf - 2).long()
    w = (u - i0)[..., None]
    flat = i0.reshape(b, -1)

    def take(a, idx):                       # a (B, K_f, ...) at idx
        if a.dim() == 2:
            return torch.gather(a, 1, idx).reshape(t.shape)
        return torch.gather(a, 1, idx[..., None].expand(-1, -1, 2)
                            ).reshape(t.shape + (2,))

    xy = take(ft.xy, flat) * (1.0 - w) + take(ft.xy, flat + 1) * w
    yaw = (take(ft.yaw, flat) * (1.0 - w[..., 0])
           + take(ft.yaw, flat + 1) * w[..., 0])
    d = points[:, :, None, :] - xy
    c, s = torch.cos(yaw), torch.sin(yaw)
    prx = c * d[..., 0] + s * d[..., 1]
    pry = -s * d[..., 0] + c * d[..., 1]
    return shape.sdf_xy_t(prx, pry, t)


def _clip(x, lo, hi):
    """jnp.clip with tensor (or scalar) bounds."""
    lo = lo if torch.is_tensor(lo) else x.new_full((), lo)
    hi = hi if torch.is_tensor(hi) else x.new_full((), hi)
    return torch.minimum(torch.maximum(x, lo), hi)


def tstar_search_batch(shape, traj, points, cfg: SVSDFConfig,
                       table: PoseTable | None = None):
    """Batched argmin of the robot SDF over trajectory time.

    points (B, M, 2) -> (sdf_min (B, M), t_star (B, M)). The coarse scan
    runs on the table's K shared samples through
    ``cuda_svsdf.coarse_scan``; refine_rounds == 0 takes the parabola
    through the argmin's neighbours, otherwise wide refinement rounds
    sample refine_n times across the bracketing cell."""
    total = traj.total_duration                              # (B,)
    with span("oracle.scan"):
        if table is None:
            table = make_pose_table(traj, cfg.coarse_n)
        best, i, fm, fp = cuda_svsdf.coarse_scan(
            shape, points, table.xy, table.cos, table.sin,
            scan_dtype=cfg.scan_dtype, ts=table.ts)
    with span("oracle.refine"):
        k = table.ts.shape[1]
        dt = (total / (k - 1))[:, None]                      # (B, 1)
        t0 = i.to(points.dtype) * dt
        tot = total[:, None]

        if cfg.refine_rounds == 0:
            # vertex of the parabola through (f[i-1], f[i], f[i+1])
            denom = fm - 2.0 * best + fp
            pos = denom > 1e-9
            delta = torch.where(
                pos, 0.5 * (fm - fp) / torch.where(pos, denom,
                                                   torch.ones_like(denom)),
                torch.zeros_like(denom))
            delta = _clip(delta, -1.0, 1.0)
            interior = (i > 0) & (i < k - 1) & pos
            t_star = torch.where(interior, _clip(t0 + delta * dt, 0.0, tot),
                                 t0)
            f_star = torch.where(interior, best - 0.25 * (fm - fp) * delta,
                                 best)
            return torch.minimum(f_star, best), t_star

        lo = _clip(t0 - dt, 0.0, tot)
        hi = _clip(t0 + dt, 0.0, tot)

        sn = max(cfg.refine_n, 4)
        # in the trajectory's dtype, which the obstacle points need not share
        u = linspace(total.new_ones((1,)), sn)[0]            # (S,)
        t_star = t0
        if cfg.refine_interp_n > 0:
            ft = make_fine_table(traj, cfg.refine_interp_n)
            sample = lambda tc: _sdf_points_times_interp(shape, ft, total,
                                                         points, tc)
        else:
            sample = lambda tc: _sdf_points_times(shape, traj, points, tc)
        for _ in range(max(1, cfg.refine_rounds)):
            t_cand = lo[..., None] + (hi - lo)[..., None] * u  # (B, M, S)
            f = sample(t_cand)
            fj, j = torch.min(f, dim=-1)
            tj = torch.gather(t_cand, -1, j[..., None])[..., 0]
            better = fj < best
            best = torch.minimum(fj, best)
            t_star = torch.where(better, tj, t_star)
            h = (hi - lo) / (sn - 1)
            lo = _clip(tj - h, 0.0, tot)
            hi = _clip(tj + h, 0.0, tot)
        return best, t_star


def _grad_world_at(shape, traj, p, t):
    """World-frame spatial SDF gradient at (p, t): R(t) @ dsdf/dp_rel,
    the autograd gradient of the shape SDF at p_rel. p (B, M, 2),
    t (B, M) -> (B, M, 2)."""
    xy, yaw, R = trj.state_se2(traj, t)
    p_rel = trj.world_to_body(xy, R, p)
    with torch.enable_grad():
        q = p_rel.detach().requires_grad_(True)
        (g_rel,) = torch.autograd.grad(shape.sdf_t(q, t).sum(), q)
    return torch.einsum("...ij,...j->...i", R, g_rel)


def _vnorm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _pick_gsip_velocity(traj, t_star):
    """If the velocity at t* is degenerate near either trajectory end,
    scan at 0.1 s steps toward the interior for the first
    non-degenerate one. t_star (B, P) -> (B, P, 2)."""
    total = traj.total_duration
    v = trj.eval_at(traj, t_star, 1)[..., :2]
    deg = _vnorm(v) < 0.01
    tot = total.reshape(-1, *([1] * (t_star.dim() - 1)))
    one = torch.ones_like(t_star)
    sign = torch.where(t_star < 0.1, one,
                       torch.where(t_star > tot - 0.1, -one,
                                   torch.zeros_like(t_star)))
    n_scan = 16
    steps = torch.arange(1, n_scan + 1, dtype=t_star.dtype,
                         device=t_star.device)
    cand_t = _clip(t_star[..., None] + (sign * 0.1)[..., None] * steps,
                   0.0, tot[..., None])
    cand_v = trj.eval_at(traj, cand_t, 1)[..., :2]        # (B, P, 16, 2)
    ok = _vnorm(cand_v) >= 0.01
    first = torch.argmax(ok.to(torch.int32), dim=-1)
    found = torch.any(ok, dim=-1) & (sign != 0.0)
    v_first = torch.gather(cand_v, -2,
                           first[..., None, None].expand(
                               *first.shape, 1, 2))[..., 0, :]
    v_repl = torch.where(found[..., None], v_first, v)
    return torch.where(deg[..., None], v_repl, v)


def _gsip_inside(shape, traj, p, t_star0, cfg: SVSDFConfig,
                 table: PoseTable | None = None):
    """Expanding-disk GSIP solve for points inside the swept volume.

    p (B, P, 2), t_star0 (B, P). Finds r* = radius of the largest disk
    centred at p inside the swept volume; returns (-r*, t*, world
    gradient toward the binding boundary point). ``table`` is the
    shared gsip_coarse_n pose table."""
    with span("oracle.gsip"):
        inner_cfg = dataclasses.replace(
            cfg, coarse_n=cfg.gsip_coarse_n,
            refine_rounds=cfg.gsip_refine_rounds,
            refine_n=min(cfg.refine_n, 16))
        if table is None:
            table = make_pose_table(traj, cfg.gsip_coarse_n)
        nb, npt = t_star0.shape

        vel = _pick_gsip_velocity(traj, t_star0)
        theta_init = torch.atan2(vel[..., 0], -vel[..., 1])

        carry = (torch.full_like(t_star0, cfg.gsip_r0), theta_init,
                 theta_init, t_star0,
                 torch.zeros_like(t_star0, dtype=torch.bool))

        def gsip_iter(carry, theta_res, n_samp):
            r, theta0, theta_star, t_star, done = carry
            steps = torch.arange(n_samp, dtype=theta0.dtype, device=p.device)
            thetas = theta0[..., None] + theta_res * steps    # (B, P, S)
            ys = p[:, :, None, :] + r[..., None, None] * torch.stack(
                [torch.cos(thetas), torch.sin(thetas)], -1)
            g, ts = tstar_search_batch(shape, traj,
                                       ys.reshape(nb, npt * n_samp, 2),
                                       inner_cfg, table=table)
            g = g.reshape(nb, npt, n_samp)
            ts = ts.reshape(nb, npt, n_samp)
            jstar = torch.argmax(g, dim=-1, keepdim=True)
            max_g = torch.gather(g, -1, jstar)[..., 0]
            new_r = r - max_g
            new_theta_star = torch.gather(thetas, -1, jstar)[..., 0]
            new_t_star = torch.gather(ts, -1, jstar)[..., 0]
            new_done = done | (torch.abs(max_g) < cfg.gsip_tol)
            return (torch.where(done, r, new_r),
                    torch.where(done, theta0, new_theta_star),
                    torch.where(done, theta_star, new_theta_star),
                    torch.where(done, t_star, new_t_star),
                    new_done)

        for k in range(cfg.gsip_iters):
            n_samp = min(int(math.ceil(2.0 * PI / _GSIP_THETA_RES[k])),
                         cfg.gsip_max_samples)
            carry = gsip_iter(carry, _GSIP_THETA_RES[k], n_samp)
        r_star, _, theta_star, t_star, _ = carry

        corner = p + r_star[..., None] * torch.stack(
            [torch.cos(theta_star), torch.sin(theta_star)], -1)
        gdir = corner - p
        gnorm = _vnorm(gdir)[..., None]
        grad_world = torch.where(gnorm > 1e-12,
                                 gdir / torch.clamp_min(gnorm, 1e-12),
                                 torch.zeros_like(gdir))
        return -r_star, t_star, grad_world


def _take(a, idx):
    """a (B, M, ...) gathered at idx (B, K) along the point axis."""
    if a.dim() == 2:
        return torch.gather(a, 1, idx)
    return torch.gather(a, 1, idx[..., None].expand(-1, -1, a.shape[-1]))


def _put(a, idx, v):
    """Out-of-place scatter a[b, idx[b, k]] = v[b, k], v cast to a's
    dtype (as JAX's ``.at[].set``)."""
    v = v.to(a.dtype)
    if a.dim() == 2:
        return a.scatter(1, idx, v)
    return a.scatter(1, idx[..., None].expand(-1, -1, a.shape[-1]), v)


def svsdf_query(shape, traj: trj.Trajectory, points,
                cfg: SVSDFConfig = DEFAULT_CONFIG,
                with_inside: bool = True) -> SVSDFResult:
    """Batched true swept-volume SDF query: points (B, M, 2).

    Outside points get the min-over-time robot SDF; inside points
    (sdf < 0) get the GSIP interior distance. The interior solve runs
    only if some plan has an inside point, and its results are kept
    only for those plans (the per-plan semantics of the JAX package's
    ``lax.cond``)."""
    sdf, t_star = tstar_search_batch(shape, traj, points, cfg)
    grad_world = _grad_world_at(shape, traj, points, t_star)
    if not with_inside:
        return SVSDFResult(sdf, t_star, grad_world)

    inside = sdf < 0.0
    plan_inside = torch.any(inside, dim=1)                     # (B,)
    if not host_bool(torch.any(plan_inside), "svsdf.inside"):
        return SVSDFResult(sdf, t_star, grad_world)

    gsip_table = make_pose_table(traj, cfg.gsip_coarse_n)
    m = points.shape[1]
    topk = cfg.gsip_topk if 0 < cfg.gsip_topk < m else 0
    if topk:
        # the topk most-interior points; ties in lower-index-first order
        # (jax.lax.top_k), hence the stable sort
        idx = torch.sort(-sdf, dim=1, descending=True,
                         stable=True).indices[:, :topk]
        pts_k, t_k = _take(points, idx), _take(t_star, idx)
        ins_k = _take(inside, idx)
        g_sdf, g_t, g_grad = _gsip_inside(shape, traj, pts_k, t_k, cfg,
                                          table=gsip_table)
        s2 = _put(sdf, idx, torch.where(ins_k, g_sdf, _take(sdf, idx)))
        t2 = _put(t_star, idx, torch.where(ins_k, g_t, t_k))
        g2 = _put(grad_world, idx, torch.where(
            ins_k[..., None], g_grad, _take(grad_world, idx)))
    else:
        g_sdf, g_t, g_grad = _gsip_inside(shape, traj, points, t_star, cfg,
                                          table=gsip_table)
        s2 = torch.where(inside, g_sdf, sdf)
        t2 = torch.where(inside, g_t, t_star)
        g2 = torch.where(inside[..., None], g_grad, grad_world)
    sel = plan_inside[:, None]
    return SVSDFResult(torch.where(sel, s2, sdf),
                       torch.where(sel, t2, t_star),
                       torch.where(sel[..., None], g2, grad_world))


def svsdf_grid(shape, traj: trj.Trajectory, xs, ys,
               cfg: SVSDFConfig = DEFAULT_CONFIG,
               with_inside: bool = False):
    """Dense SVSDF field over a 2-D grid for each plan: xs (X,), ys (Y,)
    -> (B, X, Y)."""
    with span("oracle.grid"):
        gx, gy = torch.meshgrid(xs, ys, indexing="ij")
        pts = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
        b = traj.durations.shape[0]
        pts = pts[None].expand(b, -1, -1).contiguous()
        res = svsdf_query(shape, traj, pts, cfg, with_inside=with_inside)
        return res.sdf.reshape(b, len(xs), len(ys))
