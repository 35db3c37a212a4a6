"""Procedural point-cloud map generators (own copy of
svsdf_tpu/utils/mapgen.py, which is numpy only; the two give the same
arrays for the same seed).

Capability parity with the reference's standalone map node
`globalmap_gene` (`src/map_manager/src/globalmap_gene.cpp:30-433`):
primitive generators (walls, Perlin-filtered walls, triangle prisms,
sine terrain, roads, broken roads, spirals) and ten named scenario
archetypes (corridor blocks, pillar forest, room maze, scatter fields,
noise clutter, terrain, road courses, spiral tower).  Unlike the
reference's per-point rand() loops, everything here is vectorized
numpy with an explicit seeded Generator, so maps are reproducible
fixtures for tests and benchmarks.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np


# ---------------------------------------------------------------------------
# Perlin noise (vectorized; the reference vendors a scalar classic-
# Perlin implementation, include/map_manager/BerlinNoise.hpp)
# ---------------------------------------------------------------------------

class PerlinNoise:
    """Classic 3-D gradient noise over a seeded permutation table."""

    def __init__(self, seed: int = 0):
        rng = np.random.default_rng(seed)
        p = rng.permutation(256)
        self._p = np.concatenate([p, p]).astype(np.int64)

    @staticmethod
    def _fade(t):
        return t * t * t * (t * (t * 6 - 15) + 10)

    @staticmethod
    def _grad(h, x, y, z):
        u = np.where(h < 8, x, y)
        v = np.where(h < 4, y, np.where((h == 12) | (h == 14), x, z))
        return (np.where(h & 1, -u, u) + np.where(h & 2, -v, v))

    def noise(self, x, y, z):
        x, y, z = (np.asarray(a, np.float64) for a in (x, y, z))
        xi = np.floor(x).astype(np.int64) & 255
        yi = np.floor(y).astype(np.int64) & 255
        zi = np.floor(z).astype(np.int64) & 255
        xf, yf, zf = x - np.floor(x), y - np.floor(y), z - np.floor(z)
        u, v, w = self._fade(xf), self._fade(yf), self._fade(zf)
        p = self._p

        def h(i, j, k):
            return p[p[p[xi + i] + yi + j] + zi + k] & 15

        def g(i, j, k):
            return self._grad(h(i, j, k), xf - i, yf - j, zf - k)

        def lerp(a, b, t):
            return a + t * (b - a)

        x00 = lerp(g(0, 0, 0), g(1, 0, 0), u)
        x10 = lerp(g(0, 1, 0), g(1, 1, 0), u)
        x01 = lerp(g(0, 0, 1), g(1, 0, 1), u)
        x11 = lerp(g(0, 1, 1), g(1, 1, 1), u)
        y0 = lerp(x00, x10, v)
        y1 = lerp(x01, x11, v)
        # normalized to ~[0, 1] like the reference's (n + 1) / 2
        return (lerp(y0, y1, w) + 1.0) * 0.5


# ---------------------------------------------------------------------------
# Primitives — each returns an (N, 3) float64 cloud
# ---------------------------------------------------------------------------

def _lattice(ori, extent, res):
    """Dense grid of sample points filling the box [ori, ori+extent)."""
    axes = [np.arange(o, o + e, res) if e > res else np.asarray([o])
            for o, e in zip(ori, extent)]
    g = np.meshgrid(*axes, indexing="ij")
    return np.stack([a.ravel() for a in g], axis=-1)


def _jitter(pts, rng: Optional[np.random.Generator]):
    if rng is None:
        return pts
    # the reference dithers x/y by <=0.036 and z by <=0.011 per point
    # (globalmap_gene.cpp:40-42) to avoid aliasing artifacts
    j = rng.uniform(0, 1, pts.shape) * np.asarray([0.036, 0.036, 0.011])
    return pts + j


def wall(ori_x, ori_y, length, width, height, res=0.1, ori_z=0.0,
         rng=None):
    """Solid axis-aligned block (geneWall, globalmap_gene.cpp:30,72)."""
    pts = _lattice((ori_x, ori_y, ori_z), (length, width, height), res)
    return _jitter(pts, rng)


def noisy_wall(ori_x, ori_y, length, width, height, res=0.1,
               noise_scale=0.8, noise_threshold=0.2, seed=0, rng=None):
    """Block with Perlin-noise holes (geneWallWithBerlinNoise,
    globalmap_gene.cpp:50-70): keep points whose noise > threshold."""
    pts = _lattice((ori_x, ori_y, 0.0), (length, width, height), res)
    n = PerlinNoise(seed).noise(pts[:, 0] * noise_scale,
                                pts[:, 1] * noise_scale,
                                pts[:, 2] * noise_scale)
    return _jitter(pts[n > noise_threshold], rng)


def triangle_prism(ori_x, ori_y, height, depth, length, res=0.1,
                   rng=None):
    """Triangular prism: width shrinks linearly with z (geneTrangle,
    globalmap_gene.cpp:92-112)."""
    out = []
    for z in np.arange(0.0, height, res):
        half = depth * (1.0 - z / height) * 0.5
        if half <= 0:
            continue
        sub = _lattice((ori_x - half, ori_y, z),
                       (2 * half, length, res), res)
        out.append(sub)
    pts = np.concatenate(out) if out else np.zeros((0, 3))
    return _jitter(pts, rng)


def sine_plane(ori_x, ori_y, c_z, end_x, end_y, period, amp, res=0.1,
               rng=None):
    """Terrain sheet z = c_z + amp*sin(t*x)*cos(t*y) (geneSinPlane,
    globalmap_gene.cpp:134-152)."""
    xs = np.arange(ori_x, end_x, res)
    ys = np.arange(ori_y, end_y, res)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    gz = c_z + amp * np.sin(period * gx) * np.cos(period * gy)
    pts = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=-1)
    return _jitter(pts, rng)


def road(start, end, width, res=0.1, rng=None):
    """Flat ribbon from start to end (geneRoad,
    globalmap_gene.cpp:154-178)."""
    start = np.asarray(start, np.float64)
    end = np.asarray(end, np.float64)
    d = end - start
    L = float(np.linalg.norm(d[:2]))
    if L < res:
        return np.zeros((0, 3))
    t_hat = d / L
    n_hat = np.asarray([-t_hat[1], t_hat[0], 0.0])
    ts = np.arange(0.0, L, res)
    ws = np.arange(-width / 2, width / 2, res)
    gt, gw = np.meshgrid(ts, ws, indexing="ij")
    pts = (start[None, None] + gt[..., None] * t_hat[None, None]
           + gw[..., None] * n_hat[None, None]).reshape(-1, 3)
    return _jitter(pts, rng)


def broken_road(start, end, width, broken_position, broken_width,
                res=0.1, rng=None):
    """Road with a gap at arclength broken_position (geneBrokenRoad,
    globalmap_gene.cpp:180-192)."""
    start = np.asarray(start, np.float64)
    end = np.asarray(end, np.float64)
    d = end - start
    L = float(np.linalg.norm(d[:2]))
    pts = road(start, end, width, res, rng=None)
    if not len(pts):
        return pts
    t = (pts - start[None]) @ (d / max(L, 1e-9))
    keep = ~((t > broken_position) & (t < broken_position + broken_width))
    return _jitter(pts[keep], rng)


def spiral3d(center_x, center_y, ori_z, end_z, radius, width, pitch,
             res=0.1, rng=None):
    """Helical ramp (geneSpiral3D, globalmap_gene.cpp:194-209)."""
    zs = np.arange(ori_z, end_z, res / 4)
    theta = pitch * zs
    rs = np.arange(max(radius - width / 2, res), radius + width / 2, res)
    gz, gr = np.meshgrid(zs, rs, indexing="ij")
    gth = pitch * gz
    pts = np.stack([center_x + gr * np.cos(gth),
                    center_y + gr * np.sin(gth), gz], axis=-1)
    return _jitter(pts.reshape(-1, 3), rng)


# ---------------------------------------------------------------------------
# Named scenario archetypes (map1..map10, globalmap_gene.cpp:211-433)
# ---------------------------------------------------------------------------

def _markers(*poses, res):
    """Corner marker posts bounding the map (every reference map drops
    thin posts to pin the measured bounds)."""
    return [wall(x, y, 0.2, 0.2, h, res) for x, y, h in poses]


def map_gate(res=0.1, seed=0, **kw):
    """A wall with one gate — the minimal planning scenario (map1)."""
    parts = _markers((0, 0, 3.0), (50, 20, 3.0), res=res)
    parts.append(wall(25.0, 0.0, 2.0, 10.0, 5.0, res))
    parts.append(wall(25.0, 17.0, 2.0, 10.0, 5.0, res))
    return np.concatenate(parts)


def map_forest(res=0.1, seed=0, n_trees=20, extent=60.0, keepout=2.0,
               **kw):
    """Random square pillars — the classic forest (map2)."""
    rng = np.random.default_rng(seed)
    parts = _markers((0, 0, 3.0), (extent, extent, 3.0), res=res)
    placed = 0
    while placed < n_trees:
        x, y = rng.uniform(0, extent, 2)
        if math.hypot(x - 1.0, y - 1.0) < keepout:
            continue
        parts.append(wall(x, y, 5.0, 5.0, 20.0, res))
        placed += 1
    return np.concatenate(parts)


def map_rooms(res=0.1, seed=0, **kw):
    """Two walls of door-connected rooms (map3)."""
    parts = _markers((0, 0, 3.0), (50, 50, 3.0), res=res)
    for x0 in (10.0, 20.0):
        parts.append(wall(x0, 0.0, 2.0, 2.0, 14.0, res))
        parts.append(wall(x0, 10.0, 2.0, 2.0, 14.0, res))
        parts.append(wall(x0, 2.0, 2.0, 8.0, 3.0, res))
        parts.append(wall(x0, 5.0, 2.0, 5.0, 5.5, res, ori_z=3.0))
        parts.append(wall(x0, 10.0, 2.0, 40.0, 15.0, res))
    return np.concatenate(parts)


def map_scatter_corridor(res=0.1, seed=0, n=200, **kw):
    """Long fenced corridor full of random voxel blocks (map4)."""
    rng = np.random.default_rng(seed)
    parts = _markers((-10, 0, 3.0), (250, 65, 3.0), res=res)
    parts.append(wall(0, 0, 200, 0.2, 3.0, res))
    parts.append(wall(0, 45, 200, 0.2, 3.0, res))
    xy = rng.uniform([0, 5], [200, 45], size=(n, 2))
    for x, y in xy:
        parts.append(wall(x, y, res, res, res, res))
    return np.concatenate(parts)


def map_noise_clutter(res=0.1, seed=0, **kw):
    """Scatter + Perlin-filtered patches (map5)."""
    rng = np.random.default_rng(seed)
    parts = _markers((0, 0, 3.0), (30, 75, 3.0), res=res)
    for x, y in rng.uniform([0, 10], [30, 50], size=(60, 2)):
        parts.append(wall(x, y, res, res, res, res))
    for i, (x, y) in enumerate(rng.uniform([0, 5], [30, 60],
                                           size=(10, 2))):
        parts.append(noisy_wall(x, y, 5 * res, 5 * res, res, res,
                                seed=seed + i))
    return np.concatenate(parts)


def map_terrain(res=0.1, seed=0, **kw):
    """Sine-plane terrain sheet (map6 archetype)."""
    parts = _markers((0, 0, 3.0), (40, 40, 3.0), res=res)
    parts.append(sine_plane(0, 0, 1.0, 40, 40, 0.5, 0.8, res))
    return np.concatenate(parts)


def map_road(res=0.1, seed=0, **kw):
    """Zig-zag road course (map7/map8 archetype)."""
    parts = _markers((0, 0, 1.0), (40, 40, 1.0), res=res)
    way = [(0, 0, 0), (15, 5, 0), (20, 20, 0), (35, 25, 0), (40, 40, 0)]
    for a, b in zip(way[:-1], way[1:]):
        parts.append(road(a, b, 4.0, res))
    return np.concatenate(parts)


def map_broken_road(res=0.1, seed=0, **kw):
    """Road with gaps the planner must bridge (map9 archetype)."""
    parts = _markers((0, 0, 1.0), (40, 10, 1.0), res=res)
    parts.append(broken_road((0, 5, 0), (40, 5, 0), 4.0, 15.0, 5.0,
                             res))
    return np.concatenate(parts)


def map_spiral(res=0.1, seed=0, **kw):
    """Spiral ramp tower (map10 archetype)."""
    parts = _markers((0, 0, 1.0), (30, 30, 1.0), res=res)
    parts.append(spiral3d(15.0, 15.0, 0.0, 6.0, 8.0, 4.0, 1.2, res))
    return np.concatenate(parts)


def map_maze_noise(res=0.1, seed=0, extent=40.0, scale=0.25,
                   threshold=0.62, height=2.0, **kw):
    """Dense Perlin-threshold maze — blob obstacles everywhere."""
    pts = _lattice((0, 0, 0), (extent, extent, height), res * 2)
    n = PerlinNoise(seed).noise(pts[:, 0] * scale, pts[:, 1] * scale,
                                np.zeros(len(pts)))
    body = pts[n > threshold]
    parts = _markers((0, 0, 3.0), (extent, extent, 3.0), res=res)
    parts.append(body)
    return np.concatenate(parts)


def map_perlin3d(res=0.1, seed=0, extent=30.0, height=5.0,
                 scale=0.35, threshold=0.58, **kw):
    """Volumetric Perlin clutter — mockamap's perlin3D map type
    (`src/uav_simulator/mockamap/src/maps.cpp` Maps::pcl2ros
    perlin3D): threshold a 3-D noise field into floating blobs."""
    pts = _lattice((0, 0, 0), (extent, extent, height), res * 2.5)
    n = PerlinNoise(seed).noise(pts[:, 0] * scale, pts[:, 1] * scale,
                                pts[:, 2] * scale)
    body = pts[n > threshold]
    parts = _markers((0, 0, 2.0), (extent, extent, 2.0), res=res)
    parts.append(body)
    return np.concatenate(parts)


def map_maze2d(res=0.1, seed=0, extent=30.0, cell=5.0, height=2.5,
               wall_w=0.3, **kw):
    """Recursive-division 2-D maze walls — mockamap's maze type
    (`mockamap/src/maps.cpp` recursiveDivisionMaze)."""
    rng = np.random.default_rng(seed)
    walls = []   # (x0, y0, x1, y1) segments

    def divide(x0, y0, x1, y1, depth=0):
        if x1 - x0 < 2 * cell or y1 - y0 < 2 * cell or depth > 6:
            return
        if (x1 - x0) >= (y1 - y0):
            # vertical wall with a gap
            wx = rng.uniform(x0 + cell, x1 - cell)
            gap = rng.uniform(y0, y1 - cell)
            walls.append((wx, y0, wx, gap))
            walls.append((wx, gap + cell, wx, y1))
            divide(x0, y0, wx, y1, depth + 1)
            divide(wx, y0, x1, y1, depth + 1)
        else:
            wy = rng.uniform(y0 + cell, y1 - cell)
            gap = rng.uniform(x0, x1 - cell)
            walls.append((x0, wy, gap, wy))
            walls.append((gap + cell, wy, x1, wy))
            divide(x0, y0, x1, wy, depth + 1)
            divide(x0, wy, x1, y1, depth + 1)

    divide(0.0, 0.0, extent, extent)
    parts = _markers((0, 0, 3.0), (extent, extent, 3.0), res=res)
    for (x0, y0, x1, y1) in walls:
        length = max(abs(x1 - x0), abs(y1 - y0))
        if length < res:
            continue
        if abs(x1 - x0) >= abs(y1 - y0):
            parts.append(wall(min(x0, x1), y0 - wall_w / 2,
                              length, wall_w, height, res))
        else:
            parts.append(wall(x0 - wall_w / 2, min(y0, y1),
                              wall_w, length, height, res))
    return np.concatenate(parts)


GENERATORS: Dict[str, Callable[..., np.ndarray]] = {
    "gate": map_gate,
    "forest": map_forest,
    "rooms": map_rooms,
    "scatter_corridor": map_scatter_corridor,
    "noise_clutter": map_noise_clutter,
    "terrain": map_terrain,
    "road": map_road,
    "broken_road": map_broken_road,
    "spiral": map_spiral,
    "maze_noise": map_maze_noise,
    "perlin3d": map_perlin3d,
    "maze2d": map_maze2d,
}


def generate(name: str, res: float = 0.1, seed: int = 0,
             **kw) -> np.ndarray:
    """Build the named procedural map -> (N, 3) point cloud
    (mapGene dispatch, globalmap_gene.cpp:435-460)."""
    return GENERATORS[name](res=res, seed=seed, **kw)
