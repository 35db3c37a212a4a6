"""Piecewise-polynomial trajectory evaluation, batched over plans
(svsdf_tpu/utils/trajectory.py).

A trajectory is a batch of B plans:

  coeffs:    (B, N, 6, D)  ascending-power coefficients per piece
  durations: (B, N)        per-piece durations

Query times carry the same leading plan axis: t (B, ...). The local
time stays differentiable with respect to the durations: the piece
index and the clip bound are taken from detached durations (``detach``
where JAX uses ``stop_gradient``), so d s / d T_j = -1 for j < i.
``max_rate`` and its two forms run on the host in numpy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Trajectory(NamedTuple):
    coeffs: torch.Tensor     # (B, N, 6, D)
    durations: torch.Tensor  # (B, N)

    @property
    def num_pieces(self):
        return self.coeffs.shape[1]

    @property
    def dim(self):
        return self.coeffs.shape[-1]

    @property
    def total_duration(self):
        return torch.sum(self.durations, dim=-1)


def ipow(x, p: int):
    """x ** p for an integer p by binary exponentiation, in the order
    XLA's integer_pow multiplies (so values agree with JAX to the bit
    where the surrounding arithmetic does)."""
    if p == 0:
        return torch.ones_like(x)
    y = abs(p)
    acc = None
    base = x
    while y > 0:
        if y & 1:
            acc = base if acc is None else acc * base
        y >>= 1
        if y > 0:
            base = base * base
    return 1.0 / acc if p < 0 else acc


def _basis(s, order: int, nc: int = 6):
    """Time-power basis row beta_order(s): (..., nc), with
    beta_k = k!/(k-order)! * s^(k-order) for k >= order, else 0."""
    if not 0 <= order < nc:
        raise ValueError(order)
    z = torch.zeros_like(s)
    o = torch.ones_like(s)
    rows = [z] * order
    for k in range(order, nc):
        fac = 1.0
        for j in range(order):
            fac *= (k - j)
        p = k - order
        rows.append(fac * o if p == 0 else fac * ipow(s, p))
    return torch.stack(rows, dim=-1)


def _flat_times(t, b):
    t = torch.as_tensor(t)
    if t.dim() == 0 or t.shape[0] != b:
        raise ValueError(f"times need a leading plan axis of {b}")
    return t.reshape(b, -1)


def locate_piece(durations, t):
    """(piece index, local time) for times t (B, ...). Out-of-range
    times clamp to the first/last piece."""
    b, n = durations.shape
    shape = t.shape
    tq = _flat_times(t, b)
    cum = torch.cumsum(durations, dim=-1)
    idx = torch.clamp(torch.searchsorted(cum.detach().contiguous(),
                                         tq.detach().contiguous(),
                                         right=True), 0, n - 1)
    cum0 = torch.cat([torch.zeros_like(cum[:, :1]), cum], dim=-1)
    start = torch.where(idx > 0, torch.gather(cum0, 1, idx),
                        torch.zeros_like(tq))
    s = tq - start
    ti = torch.gather(durations, 1, idx).detach()
    s = torch.minimum(torch.maximum(s, torch.zeros_like(s)), ti)
    return idx.reshape(shape), s.reshape(shape)


def eval_at_gather(traj: Trajectory, t, order: int = 0):
    """Evaluate by gathering the located piece's coefficients. The basis
    terms are summed in ascending power, one after the other: the order
    XLA's dot takes on the host, so in float64 the values equal the JAX
    package's ``eval_at`` to the bit up to 16 pieces, past which XLA's
    cumulative sum of the durations regroups (the command stream samples
    with it)."""
    b = traj.coeffs.shape[0]
    idx, s = locate_piece(traj.durations, t)
    shape = s.shape
    idx = idx.reshape(b, -1)
    nc, d = traj.coeffs.shape[2:]
    c = torch.gather(traj.coeffs, 1,
                     idx[..., None, None].expand(-1, -1, nc, d))
    beta = _basis(s.reshape(b, -1), order, nc)          # (B, Q, nc)
    out = beta[..., 0, None] * c[..., 0, :]
    for k in range(1, nc):
        out = out + beta[..., k, None] * c[..., k, :]
    return out.reshape(shape + (d,))


def eval_at(traj: Trajectory, t, order: int = 0):
    """Evaluate the order-th derivative at times t (B, ...) -> (B, ..., D).

    Every piece's polynomial is evaluated at its clipped local time
    and combined with a one-hot piece mask (the JAX package's gather-free
    form); the mask and the clip bound come from detached durations."""
    b, n = traj.durations.shape
    shape = t.shape
    tq = _flat_times(t, b)                                  # (B, Q)
    dur = traj.durations
    cum = torch.cumsum(dur, dim=-1)                         # (B, N)
    starts = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], -1)
    cum_sg = cum.detach()
    idx = torch.sum(tq[..., None] >= cum_sg[:, None, :-1], dim=-1)
    one_hot = (idx[..., None] == torch.arange(n, device=idx.device)
               ).to(traj.coeffs.dtype)                      # (B, Q, N)
    s = tq[..., None] - starts[:, None, :]                  # (B, Q, N)
    s = torch.minimum(torch.maximum(s, torch.zeros_like(s)),
                      dur.detach()[:, None, :])
    beta = _basis(s, order, traj.coeffs.shape[2])           # (B, Q, N, nc)
    vals = torch.einsum("bqnk,bnkd->bqnd", beta, traj.coeffs)
    out = torch.einsum("bqn,bqnd->bqd", one_hot, vals)
    return out.reshape(shape + (traj.coeffs.shape[-1],))


def pos(traj, t):
    return eval_at(traj, t, 0)


def vel(traj, t):
    return eval_at(traj, t, 1)


def acc(traj, t):
    return eval_at(traj, t, 2)


def jerk(traj, t):
    return eval_at(traj, t, 3)


def snap(traj, t):
    return eval_at(traj, t, 4)


def state_se2(traj: Trajectory, t):
    """(xy (..., 2), yaw (...), R (..., 2, 2)) at times t (B, ...) for a
    trajectory whose third channel is yaw."""
    p = eval_at(traj, t, 0)
    xy = p[..., :2]
    yaw = p[..., 2]
    c, s = torch.cos(yaw), torch.sin(yaw)
    R = torch.stack([torch.stack([c, -s], dim=-1),
                     torch.stack([s, c], dim=-1)], dim=-2)
    return xy, yaw, R


def world_to_body(xy, R, p_world):
    """p_rel = R^T (p - x) for planar poses."""
    d = p_world - xy
    return torch.stack([R[..., 0, 0] * d[..., 0] + R[..., 1, 0] * d[..., 1],
                        R[..., 0, 1] * d[..., 0] + R[..., 1, 1] * d[..., 1]],
                       dim=-1)


def _piece_deriv_coeffs(coeffs: np.ndarray, order: int) -> np.ndarray:
    """Ascending-power coefficients of the order-th derivative."""
    c = np.asarray(coeffs, float)
    for _ in range(order):
        nc = c.shape[0]
        c = c[1:] * np.arange(1, nc)[:, None]
    return c


def max_rate(traj: Trajectory, order: int = 1, dims=(0, 1)) -> np.ndarray:
    """Exact max |d^order p/dt^order| over each plan's trajectory for the
    given dims: (B,) on the host (Piece::getMaxVelRate/getMaxAccRate,
    trajectory.hpp:206-303: stationary points of |v|^2 via numpy
    companion-matrix roots; exact up to root polish)."""
    coeffs = traj.coeffs.detach().cpu().double().numpy()   # (B, N, nc, D)
    durs = traj.durations.detach().cpu().double().numpy()  # (B, N)
    out = np.zeros(coeffs.shape[0])
    for b in range(coeffs.shape[0]):
        best = 0.0
        for i in range(coeffs.shape[1]):
            d = _piece_deriv_coeffs(coeffs[b, i], order)[:, list(dims)]
            # |v|^2 polynomial (ascending powers) and its derivative
            sq = np.zeros(2 * d.shape[0] - 1)
            for k in range(d.shape[1]):
                sq += np.convolve(d[:, k], d[:, k])
            dsq = sq[1:] * np.arange(1, len(sq))
            cands = [0.0, durs[b, i]]
            nz = np.nonzero(np.abs(dsq) > 1e-14)[0]
            if len(nz):
                dsq_t = dsq[:nz[-1] + 1]
                if len(dsq_t) > 1:
                    roots = np.roots(dsq_t[::-1])
                    cands += [float(r.real) for r in roots
                              if abs(r.imag) < 1e-9
                              and 0.0 <= r.real <= durs[b, i]]
            for t in cands:
                best = max(best, float(np.polyval(sq[::-1], t)))
        out[b] = np.sqrt(max(best, 0.0))
    return out


def max_vel_rate(traj: Trajectory, dims=(0, 1)) -> np.ndarray:
    return max_rate(traj, 1, dims)


def max_acc_rate(traj: Trajectory, dims=(0, 1)) -> np.ndarray:
    return max_rate(traj, 2, dims)
