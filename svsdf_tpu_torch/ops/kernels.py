"""Yaw-binned shape stencils and map feasibility correlations
(svsdf_tpu/ops/kernels.py).

  rasterize_shape_kernels: all yaw stencils of the shape in one batched
    SDF evaluation (initShape, Shape.hpp:386-430);
  feasibility_maps: one correlation of the z=0 occupancy slice with all
    stencils -> feasible[yaw_bin, x, y] (kernelConv,
    sw_manager.hpp:1033-1098);
  transition_stencils / transition_feasibility: the sub-swept-volume
    transition check (checkSubSWCollision, sw_manager.hpp:1171-1213) as
    per-(father bin, delta bin, direction) swept stencils correlated with
    the map once.

The JAX package runs the correlation as an XLA convolution outside any
Pallas kernel; here it is ``torch.nn.functional.conv2d`` in float32 with
TF32 off (the package switches it off at import). Overlap counts are
small integers, exact in float32, and the ``< 0.5`` threshold absorbs
the rounding of any cuDNN algorithm. Stencils are computed in ``dtype``:
the tests pass float64, as the JAX tests run it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from svsdf_tpu_torch import resolve_device
from svsdf_tpu_torch.ops.svsdf import linspace_1d

PI = math.pi

#: 8-connected neighbor directions in (di, dj) A* order (i=-1..1, j=-1..1)
DIRS8 = [(i, j) for i in (-1, 0, 1) for j in (-1, 0, 1) if (i, j) != (0, 0)]

#: yaw-bin BFS visit offsets, mirroring visit_kernels_by_distance
#: (sw_manager.hpp:1102-1156): start bin, then +-1, +-2, ... depth 5.
YAW_BFS_DELTAS = [0, -1, 1, -2, 2, -3, 3, -4, 4, -5, 5]


def bin_yaw(yaw_num: int, ind) -> float:
    """Bin index -> yaw value (sw_manager.hpp:1166: 2*pi*i/K - pi)."""
    return 2.0 * PI * ind / yaw_num - PI


def yaw_bin(yaw_num: int, yaw: float) -> int:
    """Yaw -> bin index (sw_manager.hpp:1160)."""
    return int(yaw_num * ((yaw + PI) / (2.0 * PI))) % yaw_num


def _offsets(n: int, resolution: float, dtype, device):
    """(n, n, 2) cell offsets res * (a - side, b - side)."""
    side = (n - 1) // 2
    offs = (torch.arange(n, device=device) - side).to(dtype) * resolution
    ox, oy = torch.meshgrid(offs, offs, indexing="ij")
    return ox, oy


def rasterize_shape_kernels(shape, kernel_size: int, yaw_num: int,
                            resolution: float, safemargin: float,
                            yaw_substeps: int = 1, device=None,
                            dtype=torch.float32):
    """(yaw_num, ks, ks) bool stencils: cell (a, b) at world offset
    res*(a-side, b-side) is inside the rotated shape within safemargin.

    yaw_substeps > 1 makes each bin's stencil conservative: the union of
    the footprint over yaws sub-sampled across the bin (an odd count, so
    the bin-centre yaw is always in the union). The body frame is
    p_rel = R(yaw)^T p, the convention of the SVSDF query."""
    dev = resolve_device(device)
    ox, oy = _offsets(kernel_size, resolution, dtype, dev)
    yaws = bin_yaw(yaw_num, torch.arange(yaw_num, dtype=dtype, device=dev))
    half_bin = PI / yaw_num
    k = max(int(yaw_substeps), 1)
    if k > 1 and k % 2 == 0:
        k += 1
    deltas = (linspace_1d(-half_bin, half_bin, k, dtype, dev) if k > 1
              else torch.zeros((1,), dtype=dtype, device=dev))
    yy = (yaws[:, None] + deltas[None, :])[..., None, None]  # (K, k, 1, 1)
    c, s = torch.cos(yy), torch.sin(yy)
    prx = c * ox + s * oy
    pry = -s * ox + c * oy
    return torch.any(shape.sdf_xy(prx, pry) <= safemargin, dim=1)


def _conv_occ(occ2d, filters):
    """Correlate (X, Y) occupancy with (O, ks, ks) filters, SAME zero
    padding (out-of-map is free, as the zero-margin inflated bitmap of
    generateMapKernel2D, PCSmap_manager.h:81-107). Returns (O, X, Y)
    float32 overlap counts."""
    side = (filters.shape[-1] - 1) // 2
    x = occ2d.to(torch.float32)[None, None]                 # (1, 1, X, Y)
    f = filters.to(torch.float32)[:, None]                  # (O, 1, ks, ks)
    return F.conv2d(x, f, padding=side)[0]


def feasibility_maps(occ2d, kernels, device=None):
    """(yaw_num, X, Y) bool: placing the shape at cell (x, y) with yaw
    bin k overlaps no occupied cell (kernelConv semantics,
    sw_manager.hpp:1069-1098). ``device=None`` runs on CUDA."""
    dev = resolve_device(device)
    occ = torch.as_tensor(occ2d, device=dev)
    return _conv_occ(occ, torch.as_tensor(kernels, device=dev)) < 0.5


def transition_stencils(shape, yaw_num: int, resolution: float,
                        guard_half_world: float, n_t: int = 51,
                        n_deltas: int | None = None, device=None,
                        dtype=torch.float32):
    """Swept stencils for the sub-swept-volume transition check.

    Returns (yaw_num, n_delta, 8, s, s) bool where entry [f, d, m, a, b]
    means: moving from father pose (cell - dir_m, yaw bin f) to child
    pose (cell, yaw bin f + delta_d), the linearly interpolated shape
    covers the cell centre at offset (a, b) from the child cell at one of
    ``n_t`` interpolation samples (0.02 t-steps => 51). Yaw is
    interpolated along the short arc. ``n_deltas`` keeps the first n
    entries of YAW_BFS_DELTAS. The father-bin axis runs as a loop, which
    bounds the peak memory at (n_delta, 8, n_t, s, s) SDF values."""
    dev = resolve_device(device)
    half_cells = int(math.floor(guard_half_world / resolution))
    ox, oy = _offsets(2 * half_cells + 1, resolution, dtype, dev)
    t = linspace_1d(0.0, 1.0, n_t, dtype, dev)               # (T,)
    deltas = torch.as_tensor(YAW_BFS_DELTAS[:n_deltas] if n_deltas
                             else YAW_BFS_DELTAS, device=dev)  # (D,)
    dirs = torch.as_tensor(DIRS8, dtype=dtype, device=dev) * resolution
    # shape centre at time t relative to the child cell, per direction
    cx = -(1.0 - t)[None, :, None] * dirs[:, None, :]        # (8, T, 2)
    dx = ox - cx[..., 0, None, None]                         # (8, T, s, s)
    dy = oy - cx[..., 1, None, None]
    out = []
    for fbin in range(yaw_num):
        father_yaw = bin_yaw(yaw_num, torch.tensor(fbin, dtype=dtype,
                                                   device=dev))
        child_yaw = father_yaw + deltas.to(dtype) * (2.0 * PI / yaw_num)
        yaw_t = (1.0 - t) * father_yaw + t[None] * child_yaw[:, None]
        c = torch.cos(yaw_t)[:, None, :, None, None]         # (D, 1, T, 1, 1)
        sn = torch.sin(yaw_t)[:, None, :, None, None]
        prx = c * dx + sn * dy
        pry = -sn * dx + c * dy
        out.append(torch.any(shape.sdf_xy(prx, pry) < 0.0, dim=2))
    return torch.stack(out)                                  # (K, D, 8, s, s)


def transition_feasibility(occ2d, stencils, device=None):
    """(yaw_num, n_delta, 8, X, Y) bool: the transition INTO cell (x, y)
    from direction dir with yaw change delta is collision-free."""
    dev = resolve_device(device)
    occ = torch.as_tensor(occ2d, device=dev)
    stencils = torch.as_tensor(stencils, device=dev)
    k, d, m, s, _ = stencils.shape
    out = _conv_occ(occ, stencils.reshape(k * d * m, s, s)) < 0.5
    return out.reshape(k, d, m, *occ.shape)
