"""Euclidean signed distance fields (svsdf_tpu/ops/esdf.py).

Re-design of GridMap3D::generateESDF3d + fillESDF
(`src/map_manager/src/Gridmap3D.cpp:366-538`). Each 1-D pass of the
separable squared-distance transform is the exact brute-force minimum

  d2[i] = min_j (i - j)^2 + f[j]

over one axis, as one dense (..., n, n) tensor: O(n^2) per axis, fully
parallel, and exact for any seed. ``esdf`` returns the reference's signed
field: positive distance outside obstacles, negative inside, in world
units; ``interp_sdf`` reads it trilinearly at world points.
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


def interp_sdf(field, xyz_min, resolution, points):
    """Trilinear interpolation of a 3-D SDF grid (X, Y, Z) at world points
    (..., 3) (getSDFValue, GridMap3D.h:55-88): one value per point, so a
    single point (3,) gives a 0-D tensor. Runs where ``field`` lies and
    is differentiable in ``points`` (GridMap.sdf_value_with_grad)."""
    field = torch.as_tensor(field)
    dt, dev = field.dtype, field.device
    pts = torch.as_tensor(points, dtype=dt, device=dev)
    rel = (pts - torch.as_tensor(xyz_min, dtype=dt, device=dev)) \
        / resolution - 0.5
    hi = torch.as_tensor(field.shape, device=dev) - 2
    lo = torch.minimum(torch.maximum(torch.floor(rel).long(),
                                     torch.zeros_like(hi)), hi)
    # clip as JAX's jnp.clip: max then min, so a point on a cell face
    # takes half of each side's gradient, as jax.grad does
    zero = torch.zeros((), dtype=dt, device=dev)
    frac = torch.minimum(torch.maximum(rel - lo.to(dt), zero), zero + 1.0)
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]

    def at(dx, dy, dz):
        return field[lo[..., 0] + dx, lo[..., 1] + dy, lo[..., 2] + dz]

    c00 = at(0, 0, 0) * (1 - fx) + at(1, 0, 0) * fx
    c10 = at(0, 1, 0) * (1 - fx) + at(1, 1, 0) * fx
    c01 = at(0, 0, 1) * (1 - fx) + at(1, 0, 1) * fx
    c11 = at(0, 1, 1) * (1 - fx) + at(1, 1, 1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz
