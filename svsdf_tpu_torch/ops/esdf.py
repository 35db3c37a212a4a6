"""Euclidean signed distance fields (svsdf_tpu/ops/esdf.py).

Re-design of GridMap3D::generateESDF3d + fillESDF
(`src/map_manager/src/Gridmap3D.cpp:366-538`). Each 1-D pass of the
separable squared-distance transform is the exact brute-force minimum

  d2[i] = min_j (i - j)^2 + f[j]

over one axis, as one dense (..., n, n) tensor: O(n^2) per axis, fully
parallel, and exact for any seed. ``esdf`` returns the reference's signed
field: positive distance outside obstacles, negative inside, in world
units.
"""

from __future__ import annotations

import torch

from svsdf_tpu_torch import resolve_device

_BIG = 1e12


def _as_occ(occ, device):
    return torch.as_tensor(occ, device=resolve_device(device))


def _dt1d_bruteforce(f, axis):
    """Exact 1-D squared-distance transform along ``axis``."""
    n = f.shape[axis]
    f = torch.movedim(f, axis, -1)
    i = torch.arange(n, device=f.device)
    d2 = ((i[:, None] - i[None, :]) ** 2).to(f.dtype)      # (n, n)
    out = torch.amin(f[..., None, :] + d2, dim=-1)
    return torch.movedim(out, -1, axis)


def distance_transform_sq(occ, device=None, dtype=torch.float32):
    """Squared Euclidean distance (in cells) to the nearest occupied
    cell, for a binary occupancy array of any rank."""
    occ = _as_occ(occ, device)
    f = torch.where(occ > 0, torch.zeros((), dtype=dtype, device=occ.device),
                    torch.full((), _BIG, dtype=dtype, device=occ.device))
    for axis in range(f.dim()):
        f = _dt1d_bruteforce(f, axis)
    return f


def esdf(occ, resolution: float, device=None, dtype=torch.float32):
    """Signed Euclidean distance field (world units): positive in free
    space, negative inside obstacles (the two-phase construction of
    generateESDF3d, Gridmap3D.cpp:366-497). ``device=None`` runs on
    CUDA and raises without it."""
    occ = _as_occ(occ, device)
    pos = torch.sqrt(distance_transform_sq(occ, occ.device, dtype))
    # the complement's seeds: 1 - occ > 0, i.e. occ <= 0
    neg = torch.sqrt(distance_transform_sq(occ <= 0, occ.device, dtype))
    return resolution * torch.where(occ > 0, -neg, pos)


def esdf_with_grad(occ, resolution: float, device=None,
                   dtype=torch.float32):
    """(field, gradient (..., ndim)): central differences inside,
    one-sided differences at the map border."""
    f = esdf(occ, resolution, device, dtype)
    grads = []
    for axis in range(f.dim()):
        n = f.shape[axis]
        fp = torch.cat([f.narrow(axis, 1, n - 1), f.narrow(axis, n - 1, 1)],
                       axis)
        fm = torch.cat([f.narrow(axis, 0, 1), f.narrow(axis, 0, n - 1)],
                       axis)
        denom = torch.full((n,), 2.0, dtype=dtype, device=f.device)
        denom[0] = 1.0
        denom[-1] = 1.0
        shape = [1] * f.dim()
        shape[axis] = -1
        grads.append((fp - fm) / (denom.reshape(shape) * resolution))
    return f, torch.stack(grads, dim=-1)
