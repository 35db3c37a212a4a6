"""Port parity: the coarse-scan kernel's grid body as the host can hold it.

The kernel (svsdf_tpu_torch/csrc/coarse_scan.cu, ``Grid``) reads a mesh
robot's grid as corner records (models/mesh_sdf.py
``GridSDF2D.corner_records``: cell (ix, iy) holds its four bilinear
corners, the index clamps applied) and runs its bfloat16 form packed, two
poses a ``__nv_bfloat162``. Here, on the CPU:

  * the record table against the field's clamped corners, bit for bit,
    and its extent against every floor index the clip bounds reach (in
    bfloat16 the bound n - 1.001 of a 604-cell axis rounds to 604.0);
  * the plain model of the kernel's grid body
    (ops/cuda_svsdf.py ``grid_body_reference``: one record read at the
    unclamped floor index, the kernel's order and roundings) against the
    port's ``GridSDF2D.sdf_xy`` and JAX's, in float32 and bfloat16, on
    both mesh robots of chip_smoke.py (``MESH_ROBOTS``) and on a grid
    whose origin is 0, at points past the grid on every side, on the
    clip, in the last cell, at -0.0 and NaN. bfloat16: bit for bit with
    both. float32: bit for bit with the port; with JAX bit for bit inside
    the grid and within one ulp past it, where the square root runs and
    PyTorch's CPU root is not always correctly rounded
    (tests/test_torch_mesh_sdf.py ``test_cpu_sqrt_ulp_is_pytorchs``);
  * the claim the packed form rests on: a bfloat16 value's float product
    with the float reciprocal of the step, rounded once (what the kernel
    and PyTorch on the card compute), is the bfloat16 quotient the CPU
    computes, for every finite bfloat16 value;
  * the model as the body of the kernel's algorithm
    (``coarse_scan_split_reference``) against the plain scan, bit for bit
    at every lane count.

JAX runs on the CPU outside its x64 mode, where its field is float32 as
the port's is.
"""

import dataclasses
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import MESH_ROBOTS
from svsdf_tpu.models import mesh_sdf as jmesh
from svsdf_tpu_torch.bench import write_prism_obj
from svsdf_tpu_torch.models import mesh_sdf
from svsdf_tpu_torch.ops import cuda_svsdf as cs

torch.set_num_threads(1)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    """(port grid, JAX grid) of each robot of MESH_ROBOTS (the prism .obj
    read by both packages), and of a 604 x 131 grid of seeded values at
    origin (0, 0): an odd axis, a bfloat16 clip bound past n - 1, and a
    -0.0 coordinate that reaches the clip as -0.0."""
    d = tmp_path_factory.mktemp("mesh")
    out = {}
    for key, (body, extent) in MESH_ROBOTS.items():
        path = write_prism_obj(body, os.path.join(d, f"{key}.obj"),
                               extent=extent)
        out[key] = (mesh_sdf.shape_from_mesh(path).grid,
                    jmesh.shape_from_mesh(path).body_sdf.__self__)
    vals = np.random.default_rng(5).uniform(-2, 2, 604 * 131).astype(
        np.float32)
    out["origin"] = (
        mesh_sdf.GridSDF2D(vals, 0.0, 0.0, 0.02, 604, 131),
        jmesh.GridSDF2D(tuple(vals.tolist()), 0.0, 0.0, 0.02, 604, 131))
    return out


def _points(grid, seed):
    """Body-frame points: across the grid and 3 m past it, past each of
    its four sides, on each axis's clip (n - 1.001 in float32 and
    bfloat16) and just either side of it, in each axis's last and first
    cells, and at -0.0 and NaN, float64."""
    rng = np.random.default_rng(seed)
    lo = np.asarray([grid.x0, grid.y0])
    n = np.asarray([grid.nx, grid.ny])
    hi = lo + grid.step * (n - 1)
    parts = [rng.uniform(lo - 3.0, hi + 3.0, (1500, 2))]
    for a in range(2):
        for side in (lo[a] - rng.uniform(0, 3, 60),
                     hi[a] + rng.uniform(0, 3, 60)):
            p = rng.uniform(lo, hi, (60, 2))
            p[:, a] = side
            parts.append(p)
        clip = [lo[a] + grid.step * grid.scan_constants(dt)[3 + a]
                for dt in (torch.float32, torch.bfloat16)]
        for at in (clip[0], clip[1], hi[a] - grid.step * 1e-3):
            p = rng.uniform(lo, hi, (12, 2))
            p[:, a] = at + grid.step * np.linspace(-1e-4, 1e-4, 12)
            parts.append(p)
        for cell in (hi[a] - rng.uniform(0, grid.step, 60),
                     lo[a] + rng.uniform(0, grid.step, 60)):
            p = rng.uniform(lo, hi, (60, 2))
            p[:, a] = cell
            parts.append(p)
    parts.append([[-0.0, -0.0], [-0.0, 0.0], [0.0, -0.0], [-0.0, hi[1]],
                  [hi[0], -0.0], [np.nan, 0.0], [0.0, np.nan],
                  [np.nan, np.nan], [np.nan, hi[1] + 1.0]])
    return np.concatenate(parts)


def _planes(p, dtype):
    """The points' x and y as torch planes of ``dtype`` (through float32,
    as the scan casts them)."""
    return tuple(torch.as_tensor(p[:, a], dtype=torch.float32).to(dtype)
                 for a in range(2))


def _bits(t):
    """float32 values as their bits, every NaN one pattern."""
    t = torch.where(torch.isnan(t), torch.full_like(t, math.nan), t)
    return t.view(torch.int32)


def _jax_sdf(jgrid, p, jdt):
    with jax.enable_x64(False):
        out = jgrid.sdf_xy(*(jnp.asarray(p[:, a]).astype(jdt)
                             for a in range(2)))
        return torch.tensor(np.asarray(out.astype(jnp.float32)))


@pytest.mark.parametrize("robot", [*MESH_ROBOTS, "origin"])
def test_corner_records_are_the_clamped_corners(grids, robot):
    """Record (ix, iy) is (v[x0, y0], v[x1, y0], v[x0, y1], v[x1, y1]) with
    the indices clamped to n - 1, bit for bit; the table reaches every
    floor index of both scan types' clip bounds; it is made once a device
    and only when asked."""
    g, _ = grids[robot]
    rx, ry = g.record_cells()
    for dt in (torch.float32, torch.bfloat16):
        hix, hiy = g.scan_constants(dt)[3:]
        assert rx > math.floor(hix) and ry > math.floor(hiy)
    assert (rx, ry) >= (g.nx, g.ny)
    assert not any(k[1] == "corner_records" for k in g._tables)
    rec = g.corner_records("cpu")
    assert rec is g.corner_records(torch.device("cpu"))
    assert rec.dtype == torch.float32 and rec.is_contiguous()
    assert tuple(rec.shape) == (rx, ry, 4)
    f = g.field.view(np.uint32)
    cx = lambda i, n: np.minimum(i, n - 1)
    x0 = cx(np.arange(rx), g.nx)[:, None]
    x1 = cx(np.arange(rx) + 1, g.nx)[:, None]
    y0, y1 = cx(np.arange(ry), g.ny), cx(np.arange(ry) + 1, g.ny)
    want = np.stack([f[x0, y0], f[x1, y0], f[x0, y1], f[x1, y1]], -1)
    np.testing.assert_array_equal(rec.numpy().view(np.uint32), want)


def test_record_cells_past_the_last_cell(grids):
    """A 604-cell axis: bfloat16 rounds the clip bound 602.999 to 604.0,
    so the floor index reaches 604 and the table has 605 rows, the last
    two the clamped corners of cell 603; the 131-cell axis's bound rounds
    to 130 = n - 1. A grid of fewer than two cells a side is refused."""
    g, _ = grids["origin"]
    assert g.scan_constants(torch.bfloat16)[3:] == (604.0, 130.0)
    assert g.record_cells() == (605, 131)
    rec = g.corner_records("cpu")
    assert torch.equal(rec[604], rec[603])
    assert torch.equal(rec[603][:, 0], rec[603][:, 1])
    with pytest.raises(ValueError, match="two cells"):
        mesh_sdf.GridSDF2D(np.zeros(5, np.float32), 0.0, 0.0, 0.1, 1,
                           5).record_cells()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("robot", [*MESH_ROBOTS, "origin"])
def test_grid_body_model_matches_sdf_xy(grids, robot, dtype):
    """The kernel's grid body (one record at the unclamped floor index)
    against the port's four clamped gathers: bit for bit, signed zeros
    and NaN included, float32 values in both scan types."""
    g, _ = grids[robot]
    px, py = _planes(_points(g, seed=len(robot)), DTYPES[dtype][0])
    got = cs.grid_body_reference(g, px, py)
    want = g.sdf_xy(px, py)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(_bits(got), _bits(want))
    assert bool(torch.isnan(got).any()) and bool(torch.isfinite(got).any())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("robot", [*MESH_ROBOTS, "origin"])
def test_grid_body_model_matches_jax(grids, robot, dtype):
    """Against JAX's GridSDF2D.sdf_xy: bfloat16 bit for bit; float32 bit
    for bit inside the grid (no square root) and within one float32 ulp
    past it (PyTorch's CPU square root)."""
    g, jg = grids[robot]
    tdt, jdt = DTYPES[dtype]
    p = _points(g, seed=7 + len(robot))
    got = cs.grid_body_reference(g, *_planes(p, tdt))
    want = _jax_sdf(jg, p, jdt)
    if dtype == "bfloat16":
        assert torch.equal(_bits(got), _bits(want))
        return
    lo = np.asarray([g.x0, g.y0], np.float32)
    hi = lo + np.float32(g.step) * (np.asarray([g.nx, g.ny]) - 1)
    p32 = p.astype(np.float32)
    inside = torch.as_tensor(np.all((p32 >= lo) & (p32 <= hi), axis=1))
    assert bool(inside.any()) and not bool(inside.all())
    assert torch.equal(_bits(got[inside]), _bits(want[inside]))
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    ulp = torch.as_tensor(np.spacing(np.abs(want[ok].numpy())))
    assert bool(((got[ok] - want[ok]).abs() <= ulp).all())


def test_bfloat16_step_product_is_the_division(grids):
    """For every finite bfloat16 d and each grid's step (and a few more),
    the float product of d with the float reciprocal of the step, rounded
    to bfloat16 once, equals the CPU's bfloat16 d / step: a quotient of
    two bfloat16 values never lies on a bfloat16 rounding midpoint, so
    the product's error under a float ulp cannot move it. So the kernel's
    packed coordinate (and PyTorch's on the card) is the CPU's."""
    d = torch.arange(-(2 ** 15), 2 ** 15, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16)
    d = d[torch.isfinite(d)]
    steps = {g.step for g, _ in grids.values()} | {0.01, 0.15, 0.75, 3.0}
    for step in steps:
        s = float(torch.tensor(step, dtype=torch.bfloat16))
        inv = float(np.float32(1.0) / np.float32(s))
        prod = (d.float() * inv).to(torch.bfloat16)
        quot = d / s
        assert torch.equal(prod.view(torch.int16), quot.view(torch.int16)), \
            step


@pytest.mark.parametrize("scan_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("s", [1, 2, 4, 8, 16, 32])
def test_split_scan_with_the_model_body(grids, s, scan_dtype):
    """The kernel's algorithm (K split across S lanes, the butterfly, the
    neighbours evaluated again) with the model as the body, for the prism
    under a pre-transform, against the plain scan of the port's robot:
    bit for bit, at points past the grid and in its last cells."""
    g, _ = grids["heart_prism"]
    shape = mesh_sdf.mesh_shape("heart_prism", g, (0.3, -0.2, 25.0))
    model = dataclasses.replace(
        shape, body_sdf=lambda px, py: cs.grid_body_reference(g, px, py))
    rng = np.random.default_rng(s)
    p = _points(g, seed=s)
    p = p[np.isfinite(p).all(1)][rng.permutation(len(p) - 4)[:300]]
    t = np.linspace(0.0, 1.0, 37)
    xy = np.stack([8 * t - 4, 2 * np.sin(5 * t)], -1)
    yaw = 2.0 * np.sin(3 * t)
    xy[:3], yaw[:3] = 0.0, 0.0
    inp = tuple(torch.as_tensor(a, dtype=torch.float32)[None]
                for a in (p, xy, np.cos(yaw), np.sin(yaw)))
    got = cs.coarse_scan_split_reference(model, *inp, s, scan_dtype)
    want = cs.coarse_scan_reference(shape, *inp, scan_dtype)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
