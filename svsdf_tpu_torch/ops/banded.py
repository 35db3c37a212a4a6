"""Banded LU solve of the MINCO continuity system, bandwidth 6, no
pivoting (svsdf_tpu/ops/banded.py), batched over plans.

The system is banded with lower and upper bandwidth 6 (BandedSystem,
minco.hpp:43-198; factorizeLU is explicitly "without pivoting",
minco.hpp:99). This is the sequential solver: one elimination step a
row, each touching a fixed (7, 13) window of the padded band storage, in
the JAX package's operation order. The hot path takes block cyclic
reduction (ops/block_cr.py); this solver is the other route, the oracle
the CR solve and ``minco.solve_raw`` are held against.

Band storage: bands[..., i, d] = M[i, i + d - LBW] for d in [0, 13), so
d = 6 is the main diagonal. Rows are padded by LBW on both sides
internally, so window slices never clamp.

``banded_solve`` is an ``autograd.Function`` whose backward is the
adjoint solve with the same factorization (the reference's solveAdj,
minco.hpp:167-198), as the JAX package's custom VJP: not autograd
through the elimination loop. Every function takes a leading plan axis:
bands (B, n, 13), right-hand sides (B, n, d).
"""

from __future__ import annotations

import torch

LBW = 6          # lower bandwidth
UBW = 6          # upper bandwidth
NDIAG = LBW + UBW + 1


def _band_index(n: int, device):
    """(valid (n, 13), column index j clipped to [0, n)) of band storage."""
    i = torch.arange(n, device=device)[:, None]
    d = torch.arange(NDIAG, device=device)[None, :]
    j = i + d - LBW
    return (j >= 0) & (j < n), torch.clamp(j, 0, n - 1)


def dense_to_bands(m):
    """(..., n, n) dense -> (..., n, 13) band storage (for tests)."""
    m = torch.as_tensor(m)
    n = m.shape[-1]
    valid, jc = _band_index(n, m.device)
    vals = torch.gather(m, -1, jc.expand(m.shape[:-2] + jc.shape))
    return torch.where(valid, vals, torch.zeros((), dtype=m.dtype,
                                                device=m.device))


def _pad_rows(a):
    """Pad LBW zero rows above and below the row axis (-2)."""
    pad = torch.zeros(a.shape[:-2] + (LBW, a.shape[-1]), dtype=a.dtype,
                      device=a.device)
    return torch.cat([pad, a, pad], dim=-2)


def _factor_forward(bands, rhs):
    """Fused banded LU factorization + forward substitution. Returns
    (lu_padded, y): y solves L y = rhs with unit L; lu_padded holds U and
    the L multipliers, padded by LBW rows top and bottom."""
    n = bands.shape[-2]
    bp = _pad_rows(bands)
    # keep the padded pivots non-zero (those rows are never used)
    bp[:, :LBW, LBW] = 1.0
    bp[:, n + LBW:, LBW] = 1.0
    xp = _pad_rows(rhs)
    for k in range(n):
        r = k + LBW
        inv = 1.0 / bp[:, r, LBW]
        # L multipliers: row k+i holds column k at band index LBW-i
        li = torch.stack([bp[:, r + i, LBW - i] for i in range(1, LBW + 1)],
                         dim=1) * inv[:, None]                   # (B, 6)
        urow = bp[:, r, LBW + 1:].clone()                        # U[k, k+1..]
        for i in range(1, LBW + 1):
            c0 = LBW + 1 - i
            bp[:, r + i, c0:c0 + UBW] = (bp[:, r + i, c0:c0 + UBW]
                                         - li[:, i - 1:i] * urow)
            bp[:, r + i, LBW - i] = li[:, i - 1]
        xp[:, r + 1:r + LBW + 1] = (xp[:, r + 1:r + LBW + 1]
                                    - li[..., None] * xp[:, r:r + 1])
    return bp, xp[:, LBW:LBW + n]


def _back_substitute(lu_p, y):
    """Solve U x = y given the padded factored bands."""
    n = y.shape[-2]
    xp = _pad_rows(y)
    for k in range(n - 1, -1, -1):
        r = k + LBW
        acc = xp[:, r]
        for j in range(1, UBW + 1):
            acc = acc - lu_p[:, r, LBW + j, None] * xp[:, r + j]
        xp[:, r] = acc / lu_p[:, r, LBW, None]
    return xp[:, LBW:LBW + n]


def _adjoint_solve(lu_p, rhs):
    """Solve M^T x = rhs with the same factorization (solveAdj,
    minco.hpp:167-198): U^T (lower, non-unit) forward, then L^T (upper,
    unit) backward."""
    n = rhs.shape[-2]
    xp = _pad_rows(rhs)
    for k in range(n):
        r = k + LBW
        xk = xp[:, r] / lu_p[:, r, LBW, None]
        # (U^T)[k+j, k] = U[k, k+j] eliminates downward
        upd = torch.stack([lu_p[:, r, LBW + j, None] * xk
                           for j in range(1, UBW + 1)], dim=1)
        xp[:, r] = xk
        xp[:, r + 1:r + UBW + 1] = xp[:, r + 1:r + UBW + 1] - upd
    for k in range(n - 1, -1, -1):
        r = k + LBW
        xk = xp[:, r]
        # x[k] -= L[k+i, k] x[k+i], L[k+i, k] stored at lu[k+i, LBW-i]
        for i in range(1, LBW + 1):
            xk = xk - lu_p[:, r + i, LBW - i, None] * xp[:, r + i]
        xp[:, r] = xk
    return xp[:, LBW:LBW + n]


class _BandedSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, bands, rhs):
        with torch.no_grad():
            lu_p, y = _factor_forward(bands.detach(), rhs.detach())
            x = _back_substitute(lu_p, y)
        ctx.save_for_backward(lu_p, x)
        return x

    @staticmethod
    def backward(ctx, x_bar):
        lu_p, x = ctx.saved_tensors
        # rhs_bar = M^-T x_bar;  M_bar = -rhs_bar x^T restricted to the band
        rhs_bar = _adjoint_solve(lu_p, x_bar)
        n = x.shape[-2]
        valid, jc = _band_index(n, x.device)
        outer = rhs_bar @ x.transpose(-1, -2)                     # (B, n, n)
        vals = torch.gather(outer, -1, jc.expand(outer.shape[:-2] + jc.shape))
        bands_bar = torch.where(valid, -vals,
                                torch.zeros((), dtype=x.dtype,
                                            device=x.device))
        return bands_bar, rhs_bar


def banded_solve(bands, rhs):
    """Solve M x = rhs for M in band storage: bands (B, n, 13), rhs
    (B, n, d) -> x (B, n, d). Gradients reach both bands and rhs through
    the adjoint solve."""
    return _BandedSolve.apply(bands, rhs)
