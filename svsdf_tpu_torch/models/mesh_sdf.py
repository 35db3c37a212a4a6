"""Mesh robots: .obj -> precomputed SDF grid -> interpolation in torch
(own copy of svsdf_tpu/models/mesh_sdf.py).

The host precompute is numpy and the JAX package's arithmetic, line for
line, so the two give the same float32 grid values: exact
point-triangle distances and generalised winding numbers (the
quantities libigl's AABB and fast winding number give the reference's
BasicShape, Shape.hpp:311-340), the exact planar SDF of the mesh's z = 0
cross-section, and the grids built from them.

``GridSDF2D.sdf_xy`` and ``GridSDF3D.sdf_xyz`` sample those grids as
the JAX package does, in torch, on planes of any shape and device:
  * the clip at n - 1.001 with the constant rounded in the coordinate
    dtype (JAX's weak typing, models/shapes.py ``_k``), and the gather
    indices clamped to [0, n - 1], as JAX's gather clamps them: in
    bfloat16 the clip can reach n - 1 itself, and index n - 1 + 1 then
    reads cell n - 1;
  * coordinates, interpolation weights and the outside-the-grid term in
    the coordinate dtype, products with the field and their sum in the
    field's: float32 for float32 and bfloat16 coordinates (a bfloat16
    scan's mesh body returns float32, as JAX promotes bf16 against the
    f32 field), float64 for float64 coordinates, the float32 values
    widened exactly (JAX's field under x64);
  * every square root under ``_safe_sqrt`` and the clips through
    ``_clip``, so autograd's gradient is ``jax.grad``'s.

A grid keeps its field on the host as numpy and one copy per device and
dtype (``table``), and a planar grid its corner records per device for
the coarse-scan kernel (``GridSDF2D.corner_records``), so a shape stays
device-free, as a Polygon is, and hashes by identity.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from svsdf_tpu_torch.models.shapes import (MESH_PREFIX, Shape2D, _clip, _k,
                                           _maximum, _safe_sqrt)


def load_obj(path: str):
    """Minimal OBJ reader: returns (V (n,3) float64, F (m,3) int)."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif line.startswith("f "):
                idx = [int(p.split("/")[0]) - 1 for p in line.split()[1:]]
                for k in range(1, len(idx) - 1):   # fan-triangulate
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, float), np.asarray(faces, int)


def _point_tri_dist_sq(p, v0, v1, v2):
    """Squared distance from points p (P,3) to triangles (T,3):
    vectorized Ericson point-triangle distance. Returns (P, T)."""
    ab = v1 - v0
    ac = v2 - v0
    ap = p[:, None, :] - v0[None]
    d1 = np.einsum("tk,ptk->pt", ab, ap)
    d2 = np.einsum("tk,ptk->pt", ac, ap)
    bp = p[:, None, :] - v1[None]
    d3 = np.einsum("tk,ptk->pt", ab, bp)
    d4 = np.einsum("tk,ptk->pt", ac, bp)
    cp = p[:, None, :] - v2[None]
    d5 = np.einsum("tk,ptk->pt", ab, cp)
    d6 = np.einsum("tk,ptk->pt", ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = np.maximum(va + vb + vc, 1e-30)
    v = np.clip(vb / denom, 0.0, 1.0)
    w = np.clip(vc / denom, 0.0, 1.0)
    # interior projection
    closest = (v0[None] + v[..., None] * ab[None]
               + w[..., None] * ac[None])

    # region tests (vertex / edge closest points)
    closest = np.where(((d1 <= 0) & (d2 <= 0))[..., None], v0[None],
                       closest)
    closest = np.where(((d3 >= 0) & (d4 <= d3))[..., None], v1[None],
                       closest)
    closest = np.where(((d6 >= 0) & (d5 <= d6))[..., None], v2[None],
                       closest)
    # edge AB
    vab = np.where(np.abs(d1 - d3) > 1e-30, d1 / np.maximum(d1 - d3,
                                                            1e-30), 0.0)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    closest = np.where(on_ab[..., None],
                       v0[None] + np.clip(vab, 0, 1)[..., None] * ab[None],
                       closest)
    # edge AC
    vac = np.where(np.abs(d2 - d6) > 1e-30, d2 / np.maximum(d2 - d6,
                                                            1e-30), 0.0)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    closest = np.where(on_ac[..., None],
                       v0[None] + np.clip(vac, 0, 1)[..., None] * ac[None],
                       closest)
    # edge BC
    num = d4 - d3
    den = (d4 - d3) + (d5 - d6)
    vbc = np.where(np.abs(den) > 1e-30, num / np.maximum(den, 1e-30), 0.0)
    on_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)
    closest = np.where(on_bc[..., None],
                       v1[None] + np.clip(vbc, 0, 1)[..., None]
                       * (v2 - v1)[None], closest)

    diff = p[:, None, :] - closest
    return np.einsum("ptk,ptk->pt", diff, diff)


def _winding_number(p, V, F):
    """Generalized winding number of points p (P,3) with respect to the
    mesh (V, F) by the exact per-triangle solid angle (what
    igl::fast_winding_number approximates, Shape.hpp:332-340)."""
    a = V[F[:, 0]][None] - p[:, None, :]
    b = V[F[:, 1]][None] - p[:, None, :]
    c = V[F[:, 2]][None] - p[:, None, :]
    la = np.linalg.norm(a, axis=-1)
    lb = np.linalg.norm(b, axis=-1)
    lc = np.linalg.norm(c, axis=-1)
    det = np.einsum("ptk,ptk->pt", a, np.cross(b, c))
    denom = (la * lb * lc + np.einsum("ptk,ptk->pt", a, b) * lc
             + np.einsum("ptk,ptk->pt", b, c) * la
             + np.einsum("ptk,ptk->pt", a, c) * lb)
    omega = 2.0 * np.arctan2(det, denom)
    return omega.sum(axis=1) / (4.0 * np.pi)


def mesh_sdf_points(points3, V, F, chunk=2048):
    """Signed distance of 3-D points to the mesh: sign(1 - 2w) * dist
    (getonlySDF_igl, Shape.hpp:332-340)."""
    out = np.zeros(len(points3))
    v0, v1, v2 = V[F[:, 0]], V[F[:, 1]], V[F[:, 2]]
    for s in range(0, len(points3), chunk):
        p = points3[s:s + chunk]
        d = np.sqrt(_point_tri_dist_sq(p, v0, v1, v2).min(axis=1))
        w = _winding_number(p, V, F)
        out[s:s + chunk] = np.sign(1.0 - 2.0 * w) * d
    return out


def slice_z0(V, F):
    """Intersect the mesh with the z = 0 plane -> 2-D boundary segments
    (S, 2, 2). The robots are thin extrusions about z = 0 (the reference
    queries its 3-D mesh SDF at z = 0 points, sw_manager.hpp:760-775);
    the slice contour is the exact planar cross-section boundary."""
    tri = V[F]                                   # (T, 3, 3)
    z = tri[..., 2]
    segs = []
    edges = [(0, 1), (1, 2), (2, 0)]
    for t in range(len(tri)):
        pts = []
        for a, b in edges:
            za, zb = z[t, a], z[t, b]
            if (za > 0) != (zb > 0):
                s = za / (za - zb)
                p = tri[t, a] + s * (tri[t, b] - tri[t, a])
                pts.append(p[:2])
        if len(pts) == 2:
            segs.append(pts)
    return np.asarray(segs) if segs else np.zeros((0, 2, 2))


def planar_sdf_points(points2, segs):
    """Exact 2-D signed distance of points (P,2) to the sliced contour:
    unsigned min point-segment distance, sign by even-odd ray crossing
    (the planar analogue of sign(1-2w)*dist, Shape.hpp:332-340)."""
    a = segs[:, 0]                                # (S, 2)
    b = segs[:, 1]
    ab = b - a                                    # (S, 2)
    ab2 = np.maximum(np.einsum("sk,sk->s", ab, ab), 1e-30)
    ap = points2[:, None, :] - a[None]            # (P, S, 2)
    h = np.clip(np.einsum("psk,sk->ps", ap, ab) / ab2, 0.0, 1.0)
    d = ap - h[..., None] * ab[None]
    dist = np.sqrt(np.einsum("psk,psk->ps", d, d).min(axis=1))
    # even-odd crossing count of a +x ray
    ya, yb = a[:, 1], b[:, 1]
    py = points2[:, 1][:, None]
    crosses = (ya[None] > py) != (yb[None] > py)
    with np.errstate(divide="ignore", invalid="ignore"):
        tcr = (py - ya[None]) / np.where(np.abs(yb - ya)[None] > 1e-30,
                                         (yb - ya)[None], 1.0)
    xhit = a[:, 0][None] + tcr * (b[:, 0] - a[:, 0])[None]
    inside = (np.sum(crosses & (xhit > points2[:, 0][:, None]),
                     axis=1) % 2) == 1
    return np.where(inside, -dist, dist)


class _Grid:
    """A float32 SDF grid on the host and its copies on the devices."""

    def __init__(self, values, shape):
        self.field = np.ascontiguousarray(
            np.asarray(values, np.float32).reshape(shape))
        self.field.setflags(write=False)
        self._tables: dict = {}

    @property
    def values(self) -> np.ndarray:
        """The grid's float32 values, flat (the JAX package's ``values``
        as an array)."""
        return self.field.reshape(-1)

    def table(self, device, dtype=torch.float32) -> torch.Tensor:
        """The field on ``device`` in ``dtype`` (float32, or float64: the
        float32 values widened exactly), made once and kept."""
        key = (torch.device(device), dtype)
        if key not in self._tables:
            self._tables[key] = torch.tensor(self.field, dtype=dtype,
                                             device=key[0])
        return self._tables[key]

    def _field_for(self, ref):
        """The field as it meets coordinates like ``ref``: float64 for
        float64 coordinates, float32 otherwise."""
        return self.table(ref.device, torch.float64
                          if ref.dtype == torch.float64 else torch.float32)


def _grid_coord(p, origin, step, n):
    """(g, g clipped, floor index int64, fraction) of one axis, in the
    coordinate dtype: g = (p - origin) / step, clipped to [0, n - 1.001]
    (each constant rounded as JAX's weak typing rounds it)."""
    g = (p - _k(origin, p)) / _k(step, p)
    gc = _clip(g, 0.0, _k(n - 1.001, g))
    i = torch.floor(gc).to(torch.int64)
    return g, gc, i, gc - i.to(gc.dtype)


def _outside(step, *terms):
    """step * sqrt(sum of the squared overshoots), 0 inside the grid."""
    d2 = None
    for g in terms:
        m = _maximum(g, 0.0)
        d2 = m * m if d2 is None else d2 + m * m
    return _k(step, d2) * _safe_sqrt(d2)


class GridSDF2D(_Grid):
    """Planar SDF grid (nx, ny), row-major: cell [ix, iy] is value
    ix * ny + iy, at (x0 + ix * step, y0 + iy * step); bilinear
    interpolation inside, the distance to the grid outside."""

    def __init__(self, values, x0: float, y0: float, step: float, nx: int,
                 ny: int):
        super().__init__(values, (nx, ny))
        self.x0, self.y0, self.step = float(x0), float(y0), float(step)
        self.nx, self.ny = int(nx), int(ny)
        self._constants: dict = {}

    def scan_constants(self, dtype) -> tuple:
        """(x0, y0, step, nx - 1.001, ny - 1.001) as coordinates of
        ``dtype`` (float32 or bfloat16) meet them in ``sdf_xy``, rounded to
        it: the coarse-scan kernel's grid constants, made once a dtype."""
        if dtype not in self._constants:
            self._constants[dtype] = tuple(
                float(torch.tensor(v, dtype=dtype)) for v in (
                    self.x0, self.y0, self.step, self.nx - 1.001,
                    self.ny - 1.001))
        return self._constants[dtype]

    def record_cells(self) -> tuple[int, int]:
        """(rx, ry): the cells a clipped coordinate's floor index reaches
        in float32 or bfloat16, past n - 1 where the bfloat16 clip bound
        n - 1.001 rounds up beyond it (a 604-cell axis's to 604.0)."""
        if self.nx < 2 or self.ny < 2:
            raise ValueError("a grid needs two cells on each axis")
        return tuple(
            max([n] + [int(math.floor(self.scan_constants(dt)[3 + a])) + 1
                       for dt in (torch.float32, torch.bfloat16)])
            for a, n in enumerate((self.nx, self.ny)))

    def corner_records(self, device) -> torch.Tensor:
        """The coarse-scan kernel's corner records: a contiguous (rx, ry,
        4) float32 table whose cell (ix, iy) holds the field's values at
        (x0, y0), (x1, y0), (x0, y1), (x1, y1), x0 = min(ix, nx - 1), x1 =
        min(ix + 1, nx - 1) and the same in y: the four corners
        ``sdf_xy`` gathers at that floor index, copied bit for bit, so the
        kernel reads them in one 16-byte load and clamps nothing. Made
        once a device and kept beside the field's copies."""
        key = (torch.device(device), "corner_records")
        if key not in self._tables:
            f = torch.tensor(self.field)
            rx, ry = self.record_cells()
            ax = lambda r, n, d: torch.clamp(torch.arange(r) + d, max=n - 1)
            x0, x1 = ax(rx, self.nx, 0)[:, None], ax(rx, self.nx, 1)[:, None]
            y0, y1 = ax(ry, self.ny, 0), ax(ry, self.ny, 1)
            rec = torch.stack([f[x0, y0], f[x1, y0], f[x0, y1], f[x1, y1]],
                              -1)
            self._tables[key] = rec.contiguous().to(key[0])
        return self._tables[key]

    def sdf_xy(self, px, py):
        gx, gx_c, ix, fx = _grid_coord(px, self.x0, self.step, self.nx)
        gy, gy_c, iy, fy = _grid_coord(py, self.y0, self.step, self.ny)
        f = self._field_for(px)
        # JAX's gather clamps an index past the grid to its last cell
        ix1 = torch.clamp(ix + 1, 0, self.nx - 1)
        iy1 = torch.clamp(iy + 1, 0, self.ny - 1)
        ix = torch.clamp(ix, 0, self.nx - 1)
        iy = torch.clamp(iy, 0, self.ny - 1)
        v = ((1 - fx) * (1 - fy) * f[ix, iy] + fx * (1 - fy) * f[ix1, iy]
             + (1 - fx) * fy * f[ix, iy1] + fx * fy * f[ix1, iy1])
        # outside the grid: the border value plus the distance to the grid
        return v + _outside(self.step, gx - gx_c, gy - gy_c, -gx, -gy)

    def sdf(self, p):
        return self.sdf_xy(p[..., 0], p[..., 1])


class GridSDF3D(_Grid):
    """Volumetric SDF grid (nx, ny, nz) with trilinear interpolation: the
    3-D analogue of GridSDF2D, used by the 3-D swept-volume surface
    (viz/swept_surface.py)."""

    def __init__(self, values, x0: float, y0: float, z0: float, step: float,
                 nx: int, ny: int, nz: int):
        super().__init__(values, (nx, ny, nz))
        self.x0, self.y0, self.z0 = float(x0), float(y0), float(z0)
        self.step = float(step)
        self.nx, self.ny, self.nz = int(nx), int(ny), int(nz)

    def sdf_xyz(self, px, py, pz):
        gx, gx_c, ix, fx = _grid_coord(px, self.x0, self.step, self.nx)
        gy, gy_c, iy, fy = _grid_coord(py, self.y0, self.step, self.ny)
        gz, gz_c, iz, fz = _grid_coord(pz, self.z0, self.step, self.nz)
        f = self._field_for(px)
        at = lambda i, d, n: torch.clamp(i + d, 0, n - 1)
        v = 0.0
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    w = ((fx if dx else 1 - fx) * (fy if dy else 1 - fy)
                         * (fz if dz else 1 - fz))
                    v = v + w * f[at(ix, dx, self.nx), at(iy, dy, self.ny),
                                  at(iz, dz, self.nz)]
        return v + _outside(self.step, gx - gx_c, -gx, gy - gy_c, -gy,
                            gz - gz_c, -gz)


def grid_sdf_3d(V, F, resolution: float = 0.1,
                margin: float = 1.0) -> GridSDF3D:
    """One-time host precompute of a mesh's volumetric SDF grid (exact
    point-triangle distance and generalized winding-number sign)."""
    lo = V.min(axis=0) - margin
    hi = V.max(axis=0) + margin
    ns = [int(np.ceil((hi[k] - lo[k]) / resolution)) + 1
          for k in range(3)]
    axes = [lo[k] + np.arange(ns[k]) * resolution for k in range(3)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=-1)
    vals = mesh_sdf_points(pts, V, F).astype(np.float32)
    return GridSDF3D(vals, x0=float(lo[0]), y0=float(lo[1]),
                     z0=float(lo[2]), step=float(resolution),
                     nx=ns[0], ny=ns[1], nz=ns[2])


def mesh_shape(name: str, grid: GridSDF2D,
               poly_params=(0.0, 0.0, 0.0)) -> Shape2D:
    """The robot ``mesh:<name>`` whose body SDF is ``grid``, under the
    config's (x, y, yaw in degrees) pre-transform."""
    tx, ty, yaw_deg = (list(poly_params) + [0.0] * 3)[:3]
    return Shape2D(name=f"{MESH_PREFIX}{name}", body_sdf=grid.sdf_xy,
                   tx=tx, ty=ty, yaw0=yaw_deg * np.pi / 180.0, grid=grid)


def shape_from_mesh(objpath: str, resolution: float = 0.05,
                    margin: float = 2.0,
                    poly_params=(0.0, 0.0, 0.0)) -> Shape2D:
    """A Shape2D whose body SDF is the mesh's z = 0 planar SDF sampled on
    a grid over its xy box grown by ``margin``, at ``resolution`` (the
    config's selfmapresu, config.hpp:42), named ``mesh:<obj stem>``."""
    V, F = load_obj(objpath)
    lo = V.min(axis=0)[:2] - margin
    hi = V.max(axis=0)[:2] + margin
    nx = int(np.ceil((hi[0] - lo[0]) / resolution)) + 1
    ny = int(np.ceil((hi[1] - lo[1]) / resolution)) + 1
    xs = lo[0] + np.arange(nx) * resolution
    ys = lo[1] + np.arange(ny) * resolution
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    pts2 = np.stack([gx.ravel(), gy.ravel()], axis=-1)
    segs = slice_z0(V, F)
    if len(segs):
        vals = np.empty(len(pts2), np.float32)
        for s in range(0, len(pts2), 4096):
            vals[s:s + 4096] = planar_sdf_points(pts2[s:s + 4096], segs)
    else:
        # degenerate (flat) mesh: the 3-D mesh SDF at z = 0
        pts = np.concatenate([pts2, np.zeros((len(pts2), 1))], axis=-1)
        vals = mesh_sdf_points(pts, V, F).astype(np.float32)
    grid = GridSDF2D(vals, x0=float(lo[0]), y0=float(lo[1]),
                     step=float(resolution), nx=nx, ny=ny)
    name = os.path.basename(objpath).removesuffix(".obj")
    return mesh_shape(name, grid, poly_params)
