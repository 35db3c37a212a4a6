"""MINCO S3 (minimum-jerk) spline parameterization, batched over plans
(svsdf_tpu/ops/minco.py).

Quintic pieces with non-uniform times: given head/tail states (pos,
vel, acc), intermediate waypoints and piece durations, solve the
C^4-continuity system for the coefficients. The hot path assembles the
system in per-piece normalized time (entries scale as duration ratios,
not T^5) in band storage and solves it with block cyclic reduction
(ops/block_cr.py); gradients to waypoints and durations come from
autograd through the CR solve's ``autograd.Function``. ``solve_raw``
solves the raw-time system (``build_bands``) by the same CR route, the
JAX package's cross-check of the normalized assembly; ``solve_s`` and
``energy_s`` are the general MINCO_S{s}NU family (s = 2, 3, 4) with a
dense solve.

Shapes: times (B, N), head/tail (B, 3, D) (``solve_s``: (B, s, D)),
waypoints (B, N-1, D).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from svsdf_tpu_torch.ops.banded import LBW, NDIAG
from svsdf_tpu_torch.ops.block_cr import banded_solve_cr
from svsdf_tpu_torch.utils.profiling import span
from svsdf_tpu_torch.utils.trajectory import Trajectory, ipow


@functools.lru_cache(maxsize=None)
def _index_plan(n: int):
    """Static (rows, cols, piece, power, coef) plan of the raw-time
    system: value = coef * T_piece^power."""
    rows, cols, piece, power, coef = [], [], [], [], []

    def add(r, c, i, k, a):
        rows.append(r); cols.append(c); piece.append(i)
        power.append(k); coef.append(a)

    add(0, 0, 0, 0, 1.0)
    add(1, 1, 0, 0, 1.0)
    add(2, 2, 0, 0, 2.0)

    for i in range(n - 1):
        r = 6 * i + 3
        add(r, 6 * i + 3, i, 0, 6.0)
        add(r, 6 * i + 4, i, 1, 24.0)
        add(r, 6 * i + 5, i, 2, 60.0)
        add(r, 6 * i + 9, i, 0, -6.0)
        r = 6 * i + 4
        add(r, 6 * i + 4, i, 0, 24.0)
        add(r, 6 * i + 5, i, 1, 120.0)
        add(r, 6 * i + 10, i, 0, -24.0)
        r = 6 * i + 5
        for k in range(6):
            add(r, 6 * i + k, i, k, 1.0)
        r = 6 * i + 6
        for k in range(6):
            add(r, 6 * i + k, i, k, 1.0)
        add(r, 6 * i + 6, i, 0, -1.0)
        r = 6 * i + 7
        for k in range(1, 6):
            add(r, 6 * i + k, i, k - 1, float(k))
        add(r, 6 * i + 7, i, 0, -1.0)
        r = 6 * i + 8
        for k in range(2, 6):
            add(r, 6 * i + k, i, k - 2, float(k * (k - 1)))
        add(r, 6 * i + 8, i, 0, -2.0)

    i = n - 1
    r = 6 * n - 3
    for k in range(6):
        add(r, 6 * i + k, i, k, 1.0)
    r = 6 * n - 2
    for k in range(1, 6):
        add(r, 6 * i + k, i, k - 1, float(k))
    r = 6 * n - 1
    for k in range(2, 6):
        add(r, 6 * i + k, i, k - 2, float(k * (k - 1)))

    return (np.asarray(rows), np.asarray(cols), np.asarray(piece),
            np.asarray(power), np.asarray(coef, dtype=np.float64))


def _set_rhs(rhs, head, tail, waypoints, n):
    rhs[:, 0:3, :] = head
    if n > 1:
        wrows = torch.arange(n - 1, device=rhs.device) * 6 + 5
        rhs[:, wrows, :] = waypoints
    rhs[:, 6 * n - 3:, :] = tail
    return rhs


def build_system(times, head, tail, waypoints):
    """Dense (B, 6N, 6N) system and (B, 6N, D) rhs of the raw-time
    parameterization (test oracle)."""
    nb, n = times.shape
    d = head.shape[-1]
    rows, cols, piece, power, coef = _index_plan(n)
    tp = torch.stack([ipow(times, k) for k in range(6)], dim=1)  # (B,6,N)
    vals = (torch.as_tensor(coef, dtype=times.dtype, device=times.device)
            * tp[:, torch.as_tensor(power), torch.as_tensor(piece)])
    flat = torch.as_tensor(rows * 6 * n + cols, device=times.device)
    m = torch.zeros((nb, 36 * n * n), dtype=times.dtype,
                    device=times.device).index_add(1, flat, vals)
    rhs = torch.zeros((nb, 6 * n, d), dtype=times.dtype, device=times.device)
    rhs = _set_rhs(rhs, head, tail, waypoints, n)
    return m.reshape(nb, 6 * n, 6 * n), rhs


def _band_scatter(rows, cols, piece, power, coef, n):
    """One-hot (6N*13, E) matrix mapping the E stencil values of an index
    plan to flattened band storage, with the plan's piece, power, coef."""
    diag = cols - rows + LBW
    if not ((diag >= 0).all() and (diag < NDIAG).all()):
        raise AssertionError("stencil leaves the band")
    e = len(rows)
    s = np.zeros((6 * n * NDIAG, e), np.float64)
    flat = rows * NDIAG + diag
    for k in range(e):
        s[flat[k], k] += 1.0
    return s, np.asarray(piece), np.asarray(power), \
        np.asarray(coef, np.float64)


@functools.lru_cache(maxsize=None)
def _plan_tensors(n: int, norm: bool, dtype, device: str):
    """The band scatter of the normalized (``norm``) or raw-time plan as
    tensors on the solve's device (built once per (n, dtype, device), not
    per cost evaluation)."""
    plan = _index_plan_norm(n) if norm else _index_plan(n)
    s, piece, power, coef = _band_scatter(*plan, n)
    dev = torch.device(device)
    return (torch.as_tensor(s.T, dtype=dtype, device=dev),
            torch.as_tensor(piece, device=dev),
            torch.as_tensor(power, device=dev),
            torch.as_tensor(coef, dtype=dtype, device=dev))


def build_bands(times, head, tail, waypoints):
    """The raw-time system assembled directly in band storage (bandwidth
    6, the structure the reference's BandedSystem exploits,
    minco.hpp:43-198): bands (B, 6N, 13), rhs (B, 6N, D)."""
    nb, n = times.shape
    d = head.shape[-1]
    dtype, dev = times.dtype, times.device
    s_t, piece, power, coef = _plan_tensors(int(n), False, dtype, str(dev))
    tp = torch.stack([ipow(times, k) for k in range(6)], dim=1)   # (B,6,N)
    vals = coef * tp[:, power, piece]                             # (B, E)
    bands = torch.matmul(vals, s_t).reshape(nb, 6 * n, NDIAG)
    rhs = torch.zeros((nb, 6 * n, d), dtype=dtype, device=dev)
    return bands, _set_rhs(rhs, head, tail, waypoints, n)


@functools.lru_cache(maxsize=None)
def _index_plan_norm(n: int):
    """Scatter plan of the per-piece normalized-time system: each piece
    is parameterized on u = s/T_i, continuity rows are multiplied
    through by T_{i+1}^o, so entries are coef * rho_piece^power with
    rho_i = T_{i+1}/T_i."""
    rows, cols, piece, power, coef = [], [], [], [], []

    def add(r, c, i, k, a):
        rows.append(r); cols.append(c); piece.append(i)
        power.append(k); coef.append(a)

    def dcoef(k, o):
        a = 1.0
        for j in range(o):
            a *= (k - j)
        return a

    add(0, 0, 0, 0, 1.0)
    add(1, 1, 0, 0, 1.0)
    add(2, 2, 0, 0, 2.0)

    for i in range(n - 1):
        r = 6 * i + 3
        for k in range(3, 6):
            add(r, 6 * i + k, i, 3, dcoef(k, 3))
        add(r, 6 * i + 9, i, 0, -6.0)
        r = 6 * i + 4
        for k in range(4, 6):
            add(r, 6 * i + k, i, 4, dcoef(k, 4))
        add(r, 6 * i + 10, i, 0, -24.0)
        r = 6 * i + 5
        for k in range(6):
            add(r, 6 * i + k, i, 0, 1.0)
        r = 6 * i + 6
        for k in range(6):
            add(r, 6 * i + k, i, 0, 1.0)
        add(r, 6 * i + 6, i, 0, -1.0)
        r = 6 * i + 7
        for k in range(1, 6):
            add(r, 6 * i + k, i, 1, dcoef(k, 1))
        add(r, 6 * i + 7, i, 0, -1.0)
        r = 6 * i + 8
        for k in range(2, 6):
            add(r, 6 * i + k, i, 2, dcoef(k, 2))
        add(r, 6 * i + 8, i, 0, -2.0)

    i = n - 1
    for o, r in ((0, 6 * n - 3), (1, 6 * n - 2), (2, 6 * n - 1)):
        for k in range(o, 6):
            add(r, 6 * i + k, i, 0, dcoef(k, o))

    return (np.asarray(rows), np.asarray(cols), np.asarray(piece),
            np.asarray(power), np.asarray(coef, dtype=np.float64))


def build_bands_norm(times, head, tail, waypoints):
    """Normalized-time system in band storage: bands (B, 6N, 13),
    rhs (B, 6N, D). The solution is the normalized coefficient vector
    (c_k = c^_k / T_i^k)."""
    nb, n = times.shape
    d = head.shape[-1]
    dtype, dev = times.dtype, times.device
    s_t, piece, power, coef = _plan_tensors(int(n), True, dtype, str(dev))

    rho = torch.cat([times[:, 1:] / times[:, :-1],
                     torch.ones((nb, 1), dtype=dtype, device=dev)], 1)
    rp = torch.stack([ipow(rho, k) for k in range(5)], dim=1)   # (B,5,N)
    vals = coef * rp[:, power, piece]                           # (B, E)
    bands = torch.matmul(vals, s_t).reshape(nb, 6 * n, NDIAG)

    t0 = times[:, 0]
    tn = times[:, -1]
    one = torch.ones_like(t0)
    scale_h = torch.stack([one, t0, t0 * t0], dim=1)            # (B, 3)
    scale_t = torch.stack([one, tn, tn * tn], dim=1)
    rhs = torch.zeros((nb, 6 * n, d), dtype=dtype, device=dev)
    rhs = _set_rhs(rhs, head * scale_h[..., None], tail * scale_t[..., None],
                   waypoints, n)
    return bands, rhs


def solve(times, head, tail, waypoints) -> Trajectory:
    """Waypoints + times -> batched quintic Trajectory. Differentiable
    with respect to times and waypoints (and head/tail)."""
    nb, n = times.shape
    with span("minco.solve"):
        bands, rhs = build_bands_norm(times, head, tail, waypoints)
        ch = banded_solve_cr(bands, rhs).reshape(nb, n, 6, -1)
        tinv = torch.stack([ipow(times, -k) for k in range(6)], dim=2)
        return Trajectory(coeffs=ch * tinv[..., None], durations=times)


def solve_raw(times, head, tail, waypoints) -> Trajectory:
    """The raw-time (unnormalized) system solved by block cyclic
    reduction, the JAX package's ``SOLVER = "cr"`` route: the cross-check
    of the normalized assembly."""
    nb, n = times.shape
    bands, rhs = build_bands(times, head, tail, waypoints)
    c = banded_solve_cr(bands, rhs)
    return Trajectory(coeffs=c.reshape(nb, n, 6, -1), durations=times)


def solve_dense(times, head, tail, waypoints) -> Trajectory:
    """Dense torch.linalg.solve of the raw-time system (test oracle)."""
    nb, n = times.shape
    m, rhs = build_system(times, head, tail, waypoints)
    c = torch.linalg.solve(m, rhs)
    return Trajectory(coeffs=c.reshape(nb, n, 6, -1), durations=times)


def energy(traj: Trajectory):
    """Integral of squared jerk per plan: (B,)."""
    c3 = traj.coeffs[:, :, 3, :]
    c4 = traj.coeffs[:, :, 4, :]
    c5 = traj.coeffs[:, :, 5, :]
    t1 = traj.durations
    t2 = t1 * t1
    t3 = t2 * t1
    t4 = t2 * t2
    t5 = t4 * t1
    per_piece = (36.0 * torch.sum(c3 * c3, -1) * t1 +
                 144.0 * torch.sum(c4 * c3, -1) * t2 +
                 192.0 * torch.sum(c4 * c4, -1) * t3 +
                 240.0 * torch.sum(c5 * c3, -1) * t3 +
                 720.0 * torch.sum(c5 * c4, -1) * t4 +
                 720.0 * torch.sum(c5 * c5, -1) * t5)
    return torch.sum(per_piece, dim=-1)


# ---------------------------------------------------------------------------
# General MINCO_S{s}NU: s = 2 (cubic, min-acc), 3 (quintic, min-jerk),
# 4 (septic, min-snap), the family of minco.hpp (MINCO_S2NU :201,
# MINCO_S3NU :397, MINCO_S4NU :658), assembled densely and solved with
# torch.linalg.solve (not on the optimizer's path).
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _index_plan_s(n: int, s: int):
    """Scatter plan of the 2sN x 2sN C^{2s-2} continuity system."""
    nc = 2 * s                      # coefficients per piece
    rows, cols, piece, power, coef = [], [], [], [], []

    def add(r, c, i, k, a):
        rows.append(r); cols.append(c); piece.append(i)
        power.append(k); coef.append(a)

    def dcoef(k, order):
        a = 1.0
        for j in range(order):
            a *= (k - j)
        return a

    # head: derivatives 0..s-1 of piece 0 at local time 0
    for o in range(s):
        add(o, o, 0, 0, dcoef(o, o))

    for i in range(n - 1):
        r0 = nc * i + s
        # high-order continuity: orders s..2s-2 (s-1 rows)
        for idx, o in enumerate(range(s, 2 * s - 1)):
            r = r0 + idx
            for k in range(o, nc):
                add(r, nc * i + k, i, k - o, dcoef(k, o))
            add(r, nc * (i + 1) + o, i, 0, -dcoef(o, o))
        # waypoint position row
        r = r0 + (s - 1)
        for k in range(nc):
            add(r, nc * i + k, i, k, 1.0)
        # low-order continuity: orders 0..s-1 (s rows)
        for o in range(s):
            r = r0 + s + o
            for k in range(o, nc):
                add(r, nc * i + k, i, k - o, dcoef(k, o))
            add(r, nc * (i + 1) + o, i, 0, -dcoef(o, o))

    # tail: derivatives 0..s-1 of piece n-1 at local time T
    i = n - 1
    for o in range(s):
        r = nc * n - s + o
        for k in range(o, nc):
            add(r, nc * i + k, i, k - o, dcoef(k, o))

    return (np.asarray(rows), np.asarray(cols), np.asarray(piece),
            np.asarray(power), np.asarray(coef, dtype=np.float64))


def solve_s(s: int, times, head, tail, waypoints) -> Trajectory:
    """General MINCO solve of order s, batched: head/tail (B, s, D)
    boundary derivative rows, waypoints (B, N-1, D). Returns a Trajectory
    with 2s coefficients a piece."""
    nb, n = times.shape
    nc = 2 * s
    d = head.shape[-1]
    dtype, dev = times.dtype, times.device
    rows, cols, piece, power, coef = _index_plan_s(n, s)
    tp = torch.stack([ipow(times, k) for k in range(nc)], dim=1)  # (B,nc,N)
    vals = (torch.as_tensor(coef, dtype=dtype, device=dev)
            * tp[:, torch.as_tensor(power), torch.as_tensor(piece)])
    flat = torch.as_tensor(rows * nc * n + cols, device=dev)
    m = torch.zeros((nb, (nc * n) ** 2), dtype=dtype,
                    device=dev).index_add(1, flat, vals)
    rhs = torch.zeros((nb, nc * n, d), dtype=dtype, device=dev)
    rhs[:, 0:s] = head
    if n > 1:
        wrows = torch.arange(n - 1, device=dev) * nc + s + (s - 1)
        rhs[:, wrows] = waypoints
    rhs[:, nc * n - s:] = tail
    c = torch.linalg.solve(m.reshape(nb, nc * n, nc * n), rhs)
    return Trajectory(coeffs=c.reshape(nb, n, nc, -1), durations=times)


def energy_s(traj: Trajectory, s: int):
    """Integral of the squared s-th derivative over each plan's
    trajectory, (B,) (getEnergy of each MINCO family: minco.hpp:341,
    536, 816)."""
    coeffs = traj.coeffs
    nc = coeffs.shape[2]
    degs = np.arange(nc)
    fac = np.ones(nc)
    for j in range(s):
        fac *= np.maximum(degs - j, 0)
    dt, dev = coeffs.dtype, coeffs.device
    d = coeffs * torch.as_tensor(fac, dtype=dt, device=dev)[:, None]
    d = d[:, :, s:, :]                              # powers 0..nc-s-1
    k = d.shape[2]
    powers = np.arange(k)[:, None] + np.arange(k)[None, :] + 1
    pw = torch.as_tensor(powers, dtype=dt, device=dev)
    t = traj.durations[:, :, None, None] ** pw               # (B, N, k, k)
    gram = torch.einsum("bnid,bnjd->bnij", d, d)
    return torch.sum(gram * t / pw, dim=(1, 2, 3))
