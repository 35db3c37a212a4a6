"""Occupancy grid map built from point clouds, host-side numpy (own copy
of svsdf_tpu/utils/gridmap.py).

Re-design of GridMap3D + PCSmapManager
(`src/map_manager/src/Gridmap3D.cpp:25-260`,
`src/map_manager/src/PCSmap_manager.cpp:88-210`): bounds measured from
the cloud, count-threshold voxelization, voxel-center queries, and the
AABB obstacle-point harvest, and the ESDF conveniences of GridMap3D
(``generate_esdf``, ``sdf_value``, ``sdf_value_with_grad``). Voxelizing
runs in the C++ host runtime (native/) when its library built, else in
numpy; both give the same grid.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from svsdf_tpu_torch import native, resolve_device


@dataclasses.dataclass
class GridMap:
    resolution: float
    xyz_min: np.ndarray          # (3,)
    occ: np.ndarray              # (X, Y, Z) uint8, 1 = occupied

    @property
    def size(self) -> Tuple[int, int, int]:
        return self.occ.shape

    @classmethod
    def from_points(cls, points: np.ndarray, resolution: float,
                    sta_threshold: int = 1) -> "GridMap":
        """Measure bounds from the cloud and voxelize with a count
        threshold (rcvGlobalMapHandler, PCSmap_manager.cpp:104-193)."""
        points = np.asarray(points, dtype=np.float64)
        if points.ndim != 2 or points.shape[-1] != 3 or not len(points):
            raise ValueError(
                "GridMap.from_points needs a non-empty (N, 3) cloud, "
                f"got shape {points.shape}")
        xyz_min = points.min(axis=0)
        xyz_max = points.max(axis=0)
        shape = np.maximum(
            np.ceil((xyz_max - xyz_min) / resolution).astype(int), 1)
        if native.available():
            occ = native.voxelize(points, xyz_min, resolution,
                                  tuple(shape), sta_threshold)
            return cls(resolution=float(resolution), xyz_min=xyz_min,
                       occ=occ.astype(np.uint8))
        idx = np.floor((points - xyz_min) / resolution).astype(int)
        idx = np.clip(idx, 0, shape - 1)
        counts = np.zeros(shape, dtype=np.int32)
        np.add.at(counts, (idx[:, 0], idx[:, 1], idx[:, 2]), 1)
        return cls(resolution=float(resolution), xyz_min=xyz_min,
                   occ=(counts >= sta_threshold).astype(np.uint8))

    # -- index math (Gridmap3D.cpp:137-200) --------------------------------

    def grid_index(self, pos) -> np.ndarray:
        i = np.floor((np.asarray(pos) - self.xyz_min) /
                     self.resolution).astype(int)
        return np.clip(i, 0, np.asarray(self.size) - 1)

    def cube_center(self, idx) -> np.ndarray:
        return self.xyz_min + (np.asarray(idx) + 0.5) * self.resolution

    def in_map(self, pos) -> bool:
        p = np.asarray(pos)
        hi = self.xyz_min + np.asarray(self.size) * self.resolution
        return bool(np.all(p >= self.xyz_min) and np.all(p <= hi))

    def is_occupied_idx(self, i, j, k) -> bool:
        """Out-of-map counts as occupied (Gridmap3D.cpp:239-260)."""
        X, Y, Z = self.size
        if i < 0 or j < 0 or k < 0 or i >= X or j >= Y or k >= Z:
            return True
        return bool(self.occ[i, j, k])

    @property
    def occ2d(self) -> np.ndarray:
        """The z=0 occupancy layer used by the SE(2) front end
        (generateMapKernel2D reads isIndexOccupied(x, y, 0),
        PCSmap_manager.h:81-107)."""
        return self.occ[:, :, 0]

    def occupied_centers_2d(self) -> np.ndarray:
        """(M, 2) float32 world xy of the occupied cells of the z=0 layer,
        in ``np.nonzero`` order: the obstacle candidates of the batched
        end-to-end planner."""
        ii, jj = np.nonzero(self.occ2d)
        return np.stack(
            [self.xyz_min[0] + (ii + 0.5) * self.resolution,
             self.xyz_min[1] + (jj + 0.5) * self.resolution],
            -1).astype(np.float32)

    # -- AABB obstacle-point queries ---------------------------------------

    def points_in_aabb(self, center, half) -> np.ndarray:
        """Occupied voxel centers inside the box (getPointsInAABB,
        PCSmap_manager.h:160-183). Returns (M, 3)."""
        c = np.asarray(center, dtype=np.float64)
        h = np.asarray(half, dtype=np.float64)
        lo = self.grid_index(np.clip(c - h, self.xyz_min, None))
        hi_w = self.xyz_min + np.asarray(self.size) * self.resolution
        hi = self.grid_index(np.minimum(c + h, hi_w))
        sub = self.occ[lo[0]:hi[0] + 1, lo[1]:hi[1] + 1, lo[2]:hi[2] + 1]
        ii, jj, kk = np.nonzero(sub)
        idx = np.stack([ii + lo[0], jj + lo[1], kk + lo[2]], axis=-1)
        return self.cube_center(idx) if len(idx) else np.zeros((0, 3))

    def harvest_along_path(self, centers, half) -> np.ndarray:
        """Deduplicated occupied voxel centers in AABBs around a list of
        waypoint centers (getPointsInAABBOutOfLastOne + unifiedID dedup,
        PCSmap_manager.h:184-219). The reference passes the raw
        (x, y, yaw) waypoint as the 3D box center, so z spans
        [yaw-half, yaw+half]; reproduced. Returns (M, 3)."""
        centers = np.atleast_2d(np.asarray(centers, dtype=np.float64))
        if not len(centers):
            return np.zeros((0, 3))
        hi_w = self.xyz_min + np.asarray(self.size) * self.resolution
        mask = np.zeros(self.size, dtype=bool)
        for c in centers:
            lo = self.grid_index(np.clip(c - half, self.xyz_min, None))
            hi = self.grid_index(np.minimum(c + half, hi_w))
            mask[lo[0]:hi[0] + 1, lo[1]:hi[1] + 1, lo[2]:hi[2] + 1] = True
        idx = np.argwhere(mask & (self.occ != 0))
        if not len(idx):
            return np.zeros((0, 3))
        return self.cube_center(idx)

    # -- ESDF convenience (GridMap3D::generateESDF3d + getSDFValue /
    # getSDFValueWithGrad, Gridmap3D.cpp:366-497, GridMap3D.h:55-128) -------

    def generate_esdf(self, device=None, dtype=torch.float32):
        """The signed Euclidean distance field (X, Y, Z) of the occupancy
        grid in world units (ops/esdf.py), computed once per device and
        dtype and kept. ``device=None`` runs on CUDA and raises without
        it."""
        dev = resolve_device(device)
        cache = self.__dict__.setdefault("_esdf", {})
        key = (str(dev), dtype)
        if key not in cache:
            from svsdf_tpu_torch.ops import esdf as esdf_ops
            cache[key] = esdf_ops.esdf(self.occ, self.resolution, dev, dtype)
        return cache[key]

    def sdf_value(self, points, device=None, dtype=torch.float32):
        """Trilinear map SDF at world points (..., 3) (getSDFValue)."""
        from svsdf_tpu_torch.ops import esdf as esdf_ops
        field = self.generate_esdf(device, dtype)
        pts = torch.as_tensor(points, dtype=dtype, device=field.device)
        return esdf_ops.interp_sdf(field, self.xyz_min, self.resolution, pts)

    def sdf_value_with_grad(self, points, device=None, dtype=torch.float32):
        """(sdf, dsdf/dp) at world points (..., 3): the gradient of the
        trilinear interpolant by autograd, exact where the reference
        derives it by hand (getSDFValueWithGrad, GridMap3D.h:90-128).
        A single point (3,) gives a 0-D value and a (3,) gradient."""
        from svsdf_tpu_torch.ops import esdf as esdf_ops
        field = self.generate_esdf(device, dtype)
        pts = torch.as_tensor(points, dtype=dtype, device=field.device)
        with torch.enable_grad():
            q = pts.detach().requires_grad_(True)
            vals = esdf_ops.interp_sdf(field, self.xyz_min, self.resolution,
                                       q)
            (grads,) = torch.autograd.grad(vals.sum(), q)
        return vals.detach(), grads
