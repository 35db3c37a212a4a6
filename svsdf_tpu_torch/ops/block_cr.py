"""Block cyclic-reduction solve of the MINCO continuity system, batched
over plans (svsdf_tpu/ops/block_cr.py).

The 6Nx6N system is block tridiagonal in 6x6 blocks. Even-odd block
cyclic reduction eliminates the odd block unknowns with one batched
unpivoted 6x6 Gauss-Jordan per level, recurses on the even half and
back-substitutes. Two-sided max equilibration and one round of
iterative refinement keep it in the sequential solver's accuracy class
in float32 (the JAX module docstring has the measurements).

Every function takes a leading plan axis: bands (B, 6N, 13),
right-hand sides (B, 6N, D). ``banded_solve_cr`` is an
``autograd.Function`` whose backward is the CR solve of the transposed
system, as the JAX package's custom VJP. On CUDA tensors each direction
is one launch of the hand-written kernel of ``ops/cuda_minco.py``
(``csrc/minco_cr.cu``), which computes what ``_cr_core`` and the band
gradient compute; the plain functions here are the CPU route and what
the card tests hold the kernel against.
"""

from __future__ import annotations

import torch

from svsdf_tpu_torch.ops import cuda_minco
from svsdf_tpu_torch.ops.banded import LBW, NDIAG
from svsdf_tpu_torch.utils.profiling import span

BS = 6   # block size (quintic pieces: 6 coefficients)

#: iterative refinement rounds after the first CR solve
REFINE = 1

#: pivot clamp for the unpivoted 6x6 elimination
_PIV_EPS = 1e-30


def bands_to_blocks(bands):
    """(B, 6N, 13) band storage -> block tridiagonal (A, B, C), each
    (B, N, 6, 6), with A[:, 0] = C[:, N-1] = 0."""
    nb, n6, _ = bands.shape
    n = n6 // BS
    rows = bands.reshape(nb, n, BS, NDIAG)              # [b, i, a, d]
    a = torch.arange(BS, device=bands.device)[:, None]
    b = torch.arange(BS, device=bands.device)[None, :]
    out = []
    for o in (-1, 0, 1):
        d = 6 * o + b - a + 6                            # (6, 6)
        valid = (d >= 0) & (d < NDIAG)
        dc = torch.clamp(d, 0, NDIAG - 1)
        blk = torch.gather(rows, 3, dc.expand(nb, n, BS, BS))
        out.append(torch.where(valid, blk, torch.zeros_like(blk)))
    A, B, C = out
    A[:, 0] = 0.0
    C[:, n - 1] = 0.0
    return A, B, C


def _solve_blocks(B, rhs):
    """Batched 6x6 solve: B (..., 6, 6), rhs (..., 6, m) -> (..., 6, m).
    Unrolled Gauss-Jordan, no pivoting, pivots clamped away from 0."""
    aug = torch.cat([B, rhs], dim=-1)                   # (..., 6, 6+m)
    for j in range(BS):
        piv = aug[..., j, j][..., None]
        small = torch.abs(piv) < _PIV_EPS
        piv = torch.where(small, torch.where(
            piv < 0, torch.full_like(piv, -_PIV_EPS),
            torch.full_like(piv, _PIV_EPS)), piv)
        rj = aug[..., j, :] / piv                        # (..., 6+m)
        fac = aug[..., :, j][..., None]                  # (..., 6, 1)
        aug = aug - fac * rj[..., None, :]
        aug[..., j, :] = rj
    return aug[..., BS:]


def block_tridiag_solve(A, B, C, d):
    """Even-odd block cyclic reduction. A, B, C: (Bt, N, 6, 6) with
    A[:, 0] = C[:, N-1] = 0; d: (Bt, N, 6, D). Returns x (Bt, N, 6, D)."""
    n = A.shape[1]
    if n == 1:
        return _solve_blocks(B, d)

    n_orig = n
    if n % 2:
        # pad with a decoupled identity block (x_pad = 0)
        nb = A.shape[0]
        eye = torch.eye(BS, dtype=B.dtype, device=B.device).expand(
            nb, 1, BS, BS)
        zero = torch.zeros((nb, 1, BS, BS), dtype=B.dtype, device=B.device)
        A = torch.cat([A, zero], 1)
        B = torch.cat([B, eye], 1)
        C = torch.cat([C, zero], 1)
        d = torch.cat([d, torch.zeros_like(d[:, :1])], 1)
        n += 1

    Ae, Be, Ce, de = A[:, 0::2], B[:, 0::2], C[:, 0::2], d[:, 0::2]
    Ao, Bo, Co, do = A[:, 1::2], B[:, 1::2], C[:, 1::2], d[:, 1::2]

    sol = _solve_blocks(Bo, torch.cat([Ao, Co, do], dim=-1))
    SA, SC, Sd = sol[..., :BS], sol[..., BS:2 * BS], sol[..., 2 * BS:]

    # even equation 2k couples odd neighbours 2k-1 (odd idx k-1) and
    # 2k+1 (odd idx k): x_{2k+1} = Sd[k] - SA[k] x_{2k} - SC[k] x_{2k+2}
    SC_dn = torch.cat([torch.zeros_like(SC[:, :1]), SC[:, :-1]], 1)
    SA_dn = torch.cat([torch.zeros_like(SA[:, :1]), SA[:, :-1]], 1)
    Sd_dn = torch.cat([torch.zeros_like(Sd[:, :1]), Sd[:, :-1]], 1)

    Bp = Be - Ae @ SC_dn - Ce @ SA
    Ap = -Ae @ SA_dn
    Cp = -Ce @ SC
    dp = de - Ae @ Sd_dn - Ce @ Sd
    Ap[:, 0] = 0.0
    Cp[:, -1] = 0.0

    xe = block_tridiag_solve(Ap, Bp, Cp, dp)

    xe_up = torch.cat([xe[:, 1:], torch.zeros_like(xe[:, :1])], 1)
    xo = Sd - SA @ xe - SC @ xe_up

    x = torch.stack([xe, xo], dim=2).reshape(xe.shape[0], n, BS, -1)
    return x[:, :n_orig]


def equilibrate(bands):
    """Two-sided max equilibration: (scaled_bands, r, c) with
    scaled[i, d] = r[i] * bands[i, d] * c[i + d - 6]."""
    nb, n, _ = bands.shape
    r = 1.0 / torch.clamp_min(torch.amax(torch.abs(bands), dim=2), 1e-30)
    b1 = bands * r[..., None]
    pad = torch.zeros((nb, LBW, NDIAG), dtype=b1.dtype, device=b1.device)
    bp = torch.cat([pad, torch.abs(b1), pad], 1)
    # column j entries live at bands[j + 6 - d, d]
    cols = torch.stack([bp[:, LBW + 6 - d: LBW + 6 - d + n, d]
                        for d in range(NDIAG)], dim=1)   # (B, 13, n)
    c = 1.0 / torch.clamp_min(torch.amax(cols, dim=1), 1e-30)
    ones = torch.ones((nb, LBW), dtype=c.dtype, device=c.device)
    cpad = torch.cat([ones, c, ones], 1)
    idx = (torch.arange(n, device=bands.device)[:, None]
           + torch.arange(NDIAG, device=bands.device)[None, :])
    return b1 * cpad[:, idx], r, c


def band_matvec(bands, x):
    """y[i] = sum_d bands[i, d] * x[i + d - 6]; x (B, n, D)."""
    n = x.shape[1]
    z = torch.zeros_like(x[:, :LBW])
    xp = torch.cat([z, x, z], 1)
    acc = bands[:, :, 0:1] * xp[:, 0:n]
    for dd in range(1, NDIAG):
        acc = acc + bands[:, :, dd:dd + 1] * xp[:, dd:dd + n]
    return acc


def band_matvec_t(bands, x):
    """y = M^T x: bandsT[i, d] = bands[i + d - 6, 12 - d]."""
    n = x.shape[1]
    pad = torch.zeros_like(bands[:, :LBW])
    bp = torch.cat([pad, bands, pad], 1)
    bt = torch.stack([bp[:, dd: dd + n, NDIAG - 1 - dd]
                      for dd in range(NDIAG)], dim=2)
    return band_matvec(bt, x)


def _cr_core(bands, rhs, refine_rounds, transpose):
    """Equilibrated CR solve of M x = rhs (or M^T x = rhs) with
    iterative refinement."""
    nb, n6, d = rhs.shape
    sb, r, c = equilibrate(bands)
    A, B, C = bands_to_blocks(sb)
    if transpose:
        # (D_r M D_c)^T = D_c M^T D_r: x = r * CR_T(scaled)(c * b)
        At = torch.cat([torch.zeros_like(C[:, :1]),
                        C[:, :-1].transpose(-1, -2)], 1)
        Bt = B.transpose(-1, -2)
        Ct = torch.cat([A[:, 1:].transpose(-1, -2),
                        torch.zeros_like(A[:, :1])], 1)
        A, B, C = At, Bt, Ct
        pre, post = c, r
        matvec = band_matvec_t
    else:
        pre, post = r, c
        matvec = band_matvec

    def solve_once(b):
        y = block_tridiag_solve(A, B, C,
                                (b * pre[..., None]).reshape(nb, -1, BS, d))
        return y.reshape(nb, n6, d) * post[..., None]

    x = solve_once(rhs)
    for _ in range(refine_rounds):
        x = x + solve_once(rhs - matvec(bands, x))
    return x


class _BandedSolveCR(torch.autograd.Function):
    """Solve M x = rhs by equilibrated block CR; the backward pass is
    the transposed CR solve (rhs_bar) and -rhs_bar x^T restricted to
    the band (bands_bar). CUDA tensors launch the kernel, one launch a
    direction; CPU tensors take the plain functions."""

    @staticmethod
    def forward(ctx, bands, rhs):
        if bands.is_cuda:
            bands = bands.contiguous()
            x = cuda_minco.forward(bands, rhs.contiguous(), REFINE)
        else:
            x = _cr_core(bands, rhs, REFINE, False)
        ctx.save_for_backward(bands, x)
        return x

    @staticmethod
    def backward(ctx, x_bar):
        # on a CUDA tensor the autograd engine's own thread runs this
        with span("minco.backward"):
            bands, x = ctx.saved_tensors
            if bands.is_cuda:
                return cuda_minco.backward(bands, x, x_bar.contiguous(),
                                           REFINE)
            return plain_backward(bands, x, x_bar.contiguous())


def plain_backward(bands, x, x_bar):
    """(bands_bar, rhs_bar) of x = M^-1 rhs as plain tensor code: the
    transposed CR solve and -rhs_bar x^T restricted to the band."""
    rhs_bar = _cr_core(bands, x_bar, REFINE, True)
    return band_gradient(rhs_bar, x), rhs_bar


def band_gradient(rhs_bar, x):
    """bands_bar (B, n, 13) = -rhs_bar x^T on the band, 0 outside the
    matrix, through the full (B, n, n) outer product."""
    n = x.shape[1]
    i = torch.arange(n, device=x.device)[:, None]
    d = torch.arange(NDIAG, device=x.device)[None, :]
    j = i + d - LBW
    valid = (j >= 0) & (j < n)
    outer = torch.matmul(rhs_bar, x.transpose(-1, -2))  # (B, n, n)
    jc = torch.clamp(j, 0, n - 1).expand(x.shape[0], n, NDIAG)
    gathered = torch.gather(outer, 2, jc)
    return torch.where(valid, -gathered, torch.zeros_like(gathered))


def banded_solve_cr(bands, rhs):
    """Solve M x = rhs, M in (B, 6N, 13) band storage, rhs (B, 6N, D),
    by equilibrated block cyclic reduction + refinement."""
    return _BandedSolveCR.apply(bands, rhs)
