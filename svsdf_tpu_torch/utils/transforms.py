"""Decision-variable transforms and penalty smoothers
(svsdf_tpu/utils/transforms.py). Elementwise, so any leading batch
shape works; gradients come from autograd."""

from __future__ import annotations

import torch


def forward_t(tau):
    """tau -> T (strictly positive)."""
    pos = (0.5 * tau + 1.0) * tau + 1.0
    neg = 1.0 / ((0.5 * tau - 1.0) * tau + 1.0)
    return torch.where(tau > 0.0, pos, neg)


def backward_t(t):
    """T -> tau (inverse of forward_t)."""
    zero = t.new_zeros(())
    hi = torch.sqrt(torch.maximum(2.0 * t - 1.0, zero)) - 1.0
    lo = 1.0 - torch.sqrt(torch.maximum(
        2.0 / torch.maximum(t, t.new_full((), 1e-30)) - 1.0, zero))
    return torch.where(t > 1.0, hi, lo)


def smoothed_l1(x, mu):
    """C^2 smoothed hinge: 0 for x<=0, cubic blend on (0, mu],
    x - mu/2 beyond."""
    xdmu = x / mu
    blend = (mu - 0.5 * x) * xdmu * xdmu * xdmu
    return torch.where(x <= 0.0, torch.zeros_like(x),
                       torch.where(x > mu, x - 0.5 * mu, blend))


def safe_norm(v, dim=-1, eps=0.0):
    """Norm with zero (not NaN) gradient at v == 0."""
    n2 = torch.sum(v * v, dim=dim)
    safe = torch.where(n2 > 0.0, n2, torch.ones_like(n2))
    return torch.where(n2 > 0.0, torch.sqrt(safe),
                       torch.full_like(n2, eps))
