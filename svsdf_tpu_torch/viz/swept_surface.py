"""Swept-volume surface extraction for visualization and export (own copy
of svsdf_tpu/viz/swept_surface.py).

The 2-D swept boundary: a dense SVSDF field over a regular grid (one
batched ``svsdf_grid`` query on the trajectory's device), then marching
squares on the host, optionally extruded to a 3-D OBJ (writeSVtoObj,
sw_manager.hpp:176-185). Marching squares runs in the C++ host runtime
(native/) on a field with one uniform step when the runtime is
available, as in the JAX package, else in the Python loop.

The 3-D swept volume of a mesh robot: the running minimum over n_t
trajectory poses of the robot's volumetric SDF (models/mesh_sdf.py
``GridSDF3D.sdf_xyz``), taken on the trajectory's device a chunk of poses
at a time, then marching tetrahedra on the host (a consistent
Freudenthal 6-tetrahedron split of every cube keeps the mesh watertight
across cube faces). The reference extracts this surface with
continuation voxel marching and igl::marching_cubes
(sw_calculate.cpp:5-222, sw_calculate.hpp:107-128).

The trajectory is the port's batched ``Trajectory`` of one plan (B = 1).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from svsdf_tpu_torch import native
from svsdf_tpu_torch.ops.svsdf import DEFAULT_CONFIG, linspace, svsdf_grid
from svsdf_tpu_torch.utils import trajectory as trj

#: marching-squares segment table: for each 4-bit cell case, pairs of
#: edges (0: bottom, 1: right, 2: top, 3: left) crossed by the contour.
_MS_TABLE = {
    0: [], 15: [],
    1: [(3, 0)], 2: [(0, 1)], 3: [(3, 1)], 4: [(1, 2)],
    5: [(3, 2), (1, 0)],     # saddle
    6: [(0, 2)], 7: [(3, 2)], 8: [(2, 3)], 9: [(2, 0)],
    10: [(0, 3), (2, 1)],    # saddle
    11: [(2, 1)], 12: [(1, 3)], 13: [(1, 0)], 14: [(0, 3)],
}


def _axis(lo: float, hi: float, eps: float) -> np.ndarray:
    return np.arange(lo, hi + eps, eps)


def svsdf_field(shape, traj, bounds, eps: float, cfg=DEFAULT_CONFIG,
                level_inside: bool = False):
    """Dense SVSDF field of a one-plan trajectory: bounds = (xmin, xmax,
    ymin, ymax), eps = grid step (the config's swept-mesh resolution,
    config.hpp ``eps``). Returns (xs, ys, field (X, Y)) as numpy."""
    xmin, xmax, ymin, ymax = bounds
    xs = _axis(xmin, xmax, eps)
    ys = _axis(ymin, ymax, eps)
    as_t = lambda a: torch.as_tensor(a, dtype=traj.coeffs.dtype,
                                     device=traj.coeffs.device)
    field = svsdf_grid(shape, traj, as_t(xs), as_t(ys), cfg,
                       with_inside=level_inside)
    return xs, ys, field[0].cpu().numpy()


def marching_squares(xs, ys, field, level: float = 0.0,
                     use_native: bool | None = None
                     ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Iso-contour segments of ``field`` (X, Y) at ``level``: a list of
    ((x0, y0), (x1, y1)) with linear interpolation along cell edges (the
    2-D analogue of the igl::marching_cubes call, sw_calculate.hpp:125).
    The native route (``use_native`` None or True, where the runtime is
    available and the step uniform) emits the same segments in another
    order and orientation, from the field rounded to float32; False runs
    the Python loop on the field as given."""
    xs = np.asarray(xs)
    ys = np.asarray(ys)
    # the native kernel assumes one shared uniform step for both axes
    uniform = (len(xs) > 1 and len(ys) > 1
               and np.allclose(np.diff(xs), xs[1] - xs[0])
               and np.allclose(np.diff(ys), ys[1] - ys[0])
               and np.isclose(ys[1] - ys[0], xs[1] - xs[0]))
    if uniform and use_native is not False and native.available():
        segs_arr = native.marching_squares(
            np.asarray(field) - level, float(xs[0]), float(ys[0]),
            float(xs[1] - xs[0]), 0.0)
        return [(s[0], s[1]) for s in segs_arr]
    f = np.asarray(field) - level
    segs = []
    nx, ny = f.shape

    def interp(p0, p1, v0, v1):
        t = v0 / (v0 - v1) if v0 != v1 else 0.5
        return (p0[0] + t * (p1[0] - p0[0]), p0[1] + t * (p1[1] - p0[1]))

    for i in range(nx - 1):
        for j in range(ny - 1):
            v = [f[i, j], f[i + 1, j], f[i + 1, j + 1], f[i, j + 1]]
            case = sum(1 << k for k in range(4) if v[k] < 0.0)
            if case in (0, 15):
                continue
            corners = [(xs[i], ys[j]), (xs[i + 1], ys[j]),
                       (xs[i + 1], ys[j + 1]), (xs[i], ys[j + 1])]
            edges = {}
            edge_pairs = [(0, 1), (1, 2), (2, 3), (3, 0)]
            for e, (a, b) in enumerate(edge_pairs):
                if (v[a] < 0.0) != (v[b] < 0.0):
                    edges[e] = interp(corners[a], corners[b], v[a], v[b])
            for e0, e1 in _MS_TABLE[case]:
                if e0 in edges and e1 in edges:
                    segs.append((np.asarray(edges[e0]),
                                 np.asarray(edges[e1])))
    return segs


def extract_swept_boundary(shape, traj, bounds, eps: float,
                           cfg=DEFAULT_CONFIG):
    """Dense field and marching squares in one call (the calculateSwept
    pipeline, sw_manager.hpp:321-337)."""
    xs, ys, field = svsdf_field(shape, traj, bounds, eps, cfg)
    return marching_squares(xs, ys, field, level=0.0)


def write_swept_obj(segments, path: str, z0: float = 0.0,
                    z1: float = 1.0):
    """Extrude 2-D boundary segments into 3-D side quads and write an OBJ
    (writeSVtoObj, sw_manager.hpp:176-185). Returns (vertices, faces)."""
    verts = []
    faces = []
    for (a, b) in segments:
        base = len(verts)
        verts.extend([(a[0], a[1], z0), (b[0], b[1], z0),
                      (b[0], b[1], z1), (a[0], a[1], z1)])
        faces.append((base + 1, base + 2, base + 3))
        faces.append((base + 1, base + 3, base + 4))
    with open(path, "w") as fh:
        for v in verts:
            fh.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for f in faces:
            fh.write(f"f {f[0]} {f[1]} {f[2]}\n")
    return len(verts), len(faces)


#: Freudenthal decomposition: 6 tetrahedra per cube, all sharing the main
#: diagonal v0-v7 (corner k has offset bits (k>>2, k>>1&1, k&1)).
_TETS = np.asarray([
    (0, 4, 6, 7), (0, 4, 5, 7), (0, 2, 6, 7),
    (0, 2, 3, 7), (0, 1, 5, 7), (0, 1, 3, 7)], np.int64)


def _tet_triangles() -> dict:
    """mask (4-bit inside pattern) -> triangles as local-vertex edge
    pairs; orientation is fixed afterwards toward the outside."""
    table = {}
    for m in range(1, 15):
        ins = [i for i in range(4) if m >> i & 1]
        out = [i for i in range(4) if not m >> i & 1]
        if len(ins) == 1:
            a = ins[0]
            table[m] = [((a, out[0]), (a, out[1]), (a, out[2]))]
        elif len(ins) == 3:
            o = out[0]
            table[m] = [((o, ins[0]), (o, ins[1]), (o, ins[2]))]
        else:
            a, b = ins
            c, d = out
            table[m] = [((a, c), (a, d), (b, d)), ((a, c), (b, d), (b, c))]
    return table


_TET_TRIS = _tet_triangles()


def swept_field_3d(sdf_xyz, traj, bounds, eps: float, n_t: int = 128,
                   chunk: int = 16):
    """Volumetric swept SDF field: the minimum over n_t trajectory times
    of the robot's 3-D SDF. bounds = (xmin, xmax, ymin, ymax, zmin, zmax);
    sdf_xyz(px, py, pz) is the body-frame SDF (models/mesh_sdf.py
    GridSDF3D.sdf_xyz); the SE(2) pose leaves z unchanged. The points are
    float32 on the trajectory's device; ``chunk`` poses at a time take
    their minimum, so the (points, n_t) matrix never exists. Returns (xs,
    ys, zs, field) as numpy."""
    xmin, xmax, ymin, ymax, zmin, zmax = bounds
    xs, ys, zs = (_axis(lo, hi, eps) for lo, hi in (
        (xmin, xmax), (ymin, ymax), (zmin, zmax)))
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    dev = traj.coeffs.device
    px, py, pz = (torch.as_tensor(g.ravel(), dtype=torch.float32,
                                  device=dev) for g in (gx, gy, gz))
    ts = linspace(traj.total_duration, n_t)               # (1, n_t)
    xy, yaw, _ = trj.state_se2(traj, ts)
    cx, cy = xy[0, :, 0, None], xy[0, :, 1, None]         # (n_t, 1)
    ck, sk = torch.cos(yaw)[0, :, None], torch.sin(yaw)[0, :, None]
    best = torch.full(px.shape, float("inf"), dtype=px.dtype, device=dev)
    for s in range(0, n_t, chunk):
        e = s + chunk
        dx, dy = px - cx[s:e], py - cy[s:e]               # (chunk, P)
        prx = ck[s:e] * dx + sk[s:e] * dy
        pry = -sk[s:e] * dx + ck[s:e] * dy
        sd = sdf_xyz(prx, pry, pz.expand_as(prx)).to(best.dtype)
        best = torch.minimum(best, sd.amin(dim=0))
    field = best.reshape(len(xs), len(ys), len(zs)).cpu().numpy()
    return xs, ys, zs, field


def marching_tetrahedra(xs, ys, zs, field, level: float = 0.0):
    """The iso-surface at ``level`` as a watertight triangle mesh: (V
    (n, 3) float, F (m, 3) int) with outward orientation (normals toward
    field > level). Vertices on shared tetrahedron edges are deduplicated
    by their global grid edge, so the surface is closed wherever the
    level set does not cross the grid's boundary."""
    nx, ny, nz = field.shape
    f = np.asarray(field, float).ravel()
    pts = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"),
                   axis=-1).reshape(-1, 3)

    # global flat ids of every cube's 8 corners: (C, 8)
    ci, cj, ck = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1),
                             np.arange(nz - 1), indexing="ij")
    base = (ci * ny + cj) * nz + ck
    off = np.asarray([((k >> 2) * ny + ((k >> 1) & 1)) * nz + (k & 1)
                      for k in range(8)])
    corners = base.ravel()[:, None] + off[None]          # (C, 8)
    tets = corners[:, _TETS.reshape(-1)].reshape(-1, 4)  # (6C, 4)

    fv = f[tets]                                          # (T, 4)
    inside = fv < level
    mask = (inside * (1 << np.arange(4))[None]).sum(axis=1)

    tri_edges = []     # (K, 3, 2) global vertex-id pairs per triangle
    tri_tet = []       # generating tet row ids (for orientation)
    for m, rows in _TET_TRIS.items():
        sel = np.nonzero(mask == m)[0]
        if not len(sel):
            continue
        t = tets[sel]
        for tri in rows:
            e = np.stack([np.stack([t[:, a], t[:, b]], axis=-1)
                          for (a, b) in tri], axis=1)    # (S, 3, 2)
            tri_edges.append(e)
            tri_tet.append(sel)
    if not tri_edges:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    tri_edges = np.concatenate(tri_edges)                 # (K, 3, 2)
    tri_tet = np.concatenate(tri_tet)

    # dedup crossing points by undirected global edge identity
    e_flat = np.sort(tri_edges.reshape(-1, 2), axis=1)
    uniq, inv = np.unique(e_flat, axis=0, return_inverse=True)
    u, v = uniq[:, 0], uniq[:, 1]
    t_lin = (level - f[u]) / np.where(np.abs(f[v] - f[u]) > 1e-300,
                                      f[v] - f[u], 1.0)
    t_lin = np.clip(t_lin, 0.0, 1.0)
    V = pts[u] + t_lin[:, None] * (pts[v] - pts[u])
    F = inv.reshape(-1, 3)

    # orient outward: normal toward the generating tet's outside side
    tv = tets[tri_tet]                                    # (K, 4)
    ins = f[tv] < level
    w_in = ins / np.maximum(ins.sum(axis=1, keepdims=True), 1)
    w_out = (~ins) / np.maximum((~ins).sum(axis=1, keepdims=True), 1)
    cen_in = np.einsum("kc,kcd->kd", w_in, pts[tv])
    cen_out = np.einsum("kc,kcd->kd", w_out, pts[tv])
    n = np.cross(V[F[:, 1]] - V[F[:, 0]], V[F[:, 2]] - V[F[:, 0]])
    flip = np.einsum("kd,kd->k", n, cen_out - cen_in) < 0.0
    F[flip] = F[flip][:, [0, 2, 1]]
    return V, F


def extract_swept_volume_3d(sdf_xyz, traj, bounds, eps: float,
                            n_t: int = 128):
    """The 3-D pipeline (calculateSwept for mesh robots): volumetric swept
    field, then marching tetrahedra."""
    xs, ys, zs, field = swept_field_3d(sdf_xyz, traj, bounds, eps, n_t)
    return marching_tetrahedra(xs, ys, zs, field)


def write_trimesh_obj(V, F, path: str):
    """Write a triangle mesh to OBJ (writeSVtoObj, sw_manager:176-185).
    Returns (vertices, faces)."""
    with open(path, "w") as fh:
        for v in V:
            fh.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for f in np.asarray(F) + 1:
            fh.write(f"f {f[0]} {f[1]} {f[2]}\n")
    return len(V), len(F)


def is_watertight(F) -> bool:
    """Every undirected edge of the triangles F is shared by exactly two."""
    F = np.asarray(F)
    edges = np.sort(np.concatenate([F[:, [0, 1]], F[:, [1, 2]],
                                    F[:, [2, 0]]]), axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    return bool(len(F)) and bool((counts == 2).all())
