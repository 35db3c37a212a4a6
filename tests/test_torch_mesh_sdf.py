"""Port parity: mesh robots (svsdf_tpu_torch/models/mesh_sdf.py) against the
JAX package's svsdf_tpu/models/mesh_sdf.py, on the cylinder .obj of
tests/test_mesh_sdf.py, the sdHeart prism of svsdf_tpu_torch/bench.py and
the unit cube of tests/test_swept3d.py.

  * the host precompute (``load_obj``, ``mesh_sdf_points``, ``slice_z0``,
    ``planar_sdf_points``, the grids of ``shape_from_mesh`` and
    ``grid_sdf_3d``) is the same numpy on both sides: equal to the bit;
  * ``GridSDF2D.sdf_xy`` and ``GridSDF3D.sdf_xyz`` against JAX's on points
    inside, outside and on the edge of the grid. bfloat16: to the bit,
    including the clamp case (in bfloat16 the clip n - 1.001 rounds to
    n - 1, so the corner past it is read clamped: x = 3.49 on the r = 1.5
    cylinder gives 2.0). float32 and float64: within one ulp, because
    PyTorch's CPU square root is not correctly rounded at every input:
    sqrt(66.54899f) is one float32 ulp below float64's root rounded to
    float32, which JAX's matches (``test_cpu_sqrt_ulp_is_pytorchs``); the
    card's is correctly rounded. float32 and bfloat16 are held against JAX outside its x64
    mode, where its field is float32 as the port's is (under x64 JAX keeps
    the field in float64, which the port does for float64 coordinates);
  * ``sdf_grad`` (autograd) against ``jax.grad`` in float64 at 1e-12;
  * the routing of ``shape_from_objpath`` and ``mesh_shape_from_fields``;
  * the coarse scan of a mesh robot (``coarse_scan_reference``) against
    JAX's table scan (``_sdf_from_table``) min and argmin in both scan
    types, to the bit, and the kernel's algorithm
    (``coarse_scan_split_reference``) bit for bit against the plain scan
    at every lane count, on points past the grid and in the bfloat16
    clamp zone.
"""

import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svsdf_tpu.models import mesh_sdf as jmesh
from svsdf_tpu.models import shapes as jshapes
from svsdf_tpu.ops import svsdf as jsv
from svsdf_tpu_torch import convert
from svsdf_tpu_torch.bench import write_prism_obj
from svsdf_tpu_torch.models import mesh_sdf, shapes
from svsdf_tpu_torch.ops import cuda_svsdf as cs
from tests.test_mesh_sdf import _write_cylinder_obj
from tests.test_swept3d import _unit_cube_mesh

torch.set_num_threads(1)

DTYPES = {"float32": (torch.float32, jnp.float32, False),
          "float64": (torch.float64, jnp.float64, True),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, False)}


@pytest.fixture(scope="module")
def objs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    cyl = str(d / "roundRobot.obj")
    _write_cylinder_obj(cyl)
    heart = write_prism_obj("sdHeart", str(d / "heart_prism.obj"))
    return {"cylinder": cyl, "heart": heart}


@pytest.fixture(scope="module")
def robots(objs):
    """(port shape, JAX shape) of each .obj, under the same pre-transform."""
    pre = (0.3, -0.2, 25.0)
    return {k: (mesh_sdf.shape_from_mesh(p, poly_params=pre),
                jmesh.shape_from_mesh(p, poly_params=pre))
            for k, p in objs.items()}


def _jgrid(jshape):
    return jshape.body_sdf.__self__


def _points(grid, n, seed):
    """Points across the grid and 3 m past it, the four clamp-zone edges
    (the last cell of each axis) and the bfloat16 clamp case."""
    rng = np.random.default_rng(seed)
    lo = np.asarray([grid.x0, grid.y0])
    hi = lo + grid.step * (np.asarray([grid.nx, grid.ny]) - 1)
    p = rng.uniform(lo - 3.0, hi + 3.0, (n, 2))
    edge = rng.uniform(lo, hi, (64, 2))
    edge[:16, 0] = hi[0] - rng.uniform(0, 2 * grid.step, 16)
    edge[16:32, 1] = hi[1] - rng.uniform(0, 2 * grid.step, 16)
    edge[32:48, 0] = lo[0] + rng.uniform(0, 2 * grid.step, 16)
    edge[48:, 1] = lo[1] + rng.uniform(0, 2 * grid.step, 16)
    return np.concatenate([p, edge, [[3.49, 0.0], [0.0, 3.49]]])


def _within_ulp(got, want, dtype):
    """|got - want| at most one ulp of want in ``dtype``."""
    want = np.asarray(want, dtype)
    ulp = np.spacing(np.abs(want)).astype(np.float64)
    err = np.abs(np.asarray(got, np.float64) - want.astype(np.float64))
    assert np.all(err <= ulp), float((err / ulp).max())


def _jax_eval(fn, args, jdt, x64):
    with jax.enable_x64(x64):
        out = fn(*(jnp.asarray(a).astype(jdt) for a in args))
        return np.asarray(out.astype(jnp.float64 if x64 else jnp.float32)), \
            out.dtype


def test_host_precompute_matches_jax(objs):
    for path in objs.values():
        V, F = mesh_sdf.load_obj(path)
        Vj, Fj = jmesh.load_obj(path)
        np.testing.assert_array_equal(V, Vj)
        np.testing.assert_array_equal(F, Fj)
        np.testing.assert_array_equal(mesh_sdf.slice_z0(V, F),
                                      jmesh.slice_z0(V, F))
        rng = np.random.default_rng(3)
        p3 = rng.uniform(V.min(0) - 1, V.max(0) + 1, (300, 3))
        np.testing.assert_array_equal(mesh_sdf.mesh_sdf_points(p3, V, F),
                                      jmesh.mesh_sdf_points(p3, V, F))
        segs = mesh_sdf.slice_z0(V, F)
        np.testing.assert_array_equal(
            mesh_sdf.planar_sdf_points(p3[:, :2], segs),
            jmesh.planar_sdf_points(p3[:, :2], segs))


def test_cylinder_mesh_sdf_is_the_solid():
    """tests/test_mesh_sdf.py's check on the port: the mesh SDF of the
    r = 1.5 cylinder is the solid's exact SDF up to its facets."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "roundRobot.obj")
        _write_cylinder_obj(p)
        V, F = mesh_sdf.load_obj(p)
    assert V.shape == (130, 3) and F.shape == (256, 3)
    pts = np.random.default_rng(3).uniform([-3, -3, -0.3], [3, 3, 0.3],
                                           (200, 3))
    radial = np.linalg.norm(pts[:, :2], axis=1) - 1.5
    axial = np.abs(pts[:, 2]) - 0.5
    exact = np.where((radial < 0) & (axial < 0), np.maximum(radial, axial),
                     np.hypot(np.maximum(radial, 0), np.maximum(axial, 0)))
    assert np.max(np.abs(mesh_sdf.mesh_sdf_points(pts, V, F) - exact)) < 0.01


def test_grids_match_jax(robots):
    for shape, jshape in robots.values():
        g, jg = shape.grid, _jgrid(jshape)
        assert (g.nx, g.ny, g.x0, g.y0, g.step) == (jg.nx, jg.ny, jg.x0,
                                                     jg.y0, jg.step)
        np.testing.assert_array_equal(g.values,
                                      np.asarray(jg.values, np.float32))
        assert shape.name == jshape.name and shape.name.startswith("mesh:")
        assert (shape.tx, shape.ty, shape.yaw0) == (jshape.tx, jshape.ty,
                                                    jshape.yaw0)
    V, F = _unit_cube_mesh()
    g3, jg3 = (mod.grid_sdf_3d(V, F, resolution=0.1, margin=0.8)
               for mod in (mesh_sdf, jmesh))
    assert (g3.nx, g3.ny, g3.nz, g3.z0) == (jg3.nx, jg3.ny, jg3.nz, jg3.z0)
    np.testing.assert_array_equal(g3.values,
                                  np.asarray(jg3.values, np.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("robot", ["cylinder", "heart"])
def test_grid_sdf2d_matches_jax(robots, robot, dtype):
    shape, jshape = robots[robot]
    tdt, jdt, x64 = DTYPES[dtype]
    p = _points(shape.grid, 3000, seed=len(robot))
    want, wdt = _jax_eval(_jgrid(jshape).sdf_xy, (p[:, 0], p[:, 1]), jdt,
                          x64)
    got = shape.grid.sdf_xy(*(torch.as_tensor(p[:, k]).to(tdt)
                              for k in range(2)))
    # a bfloat16 body returns float32, as JAX promotes it
    assert got.dtype == (torch.float32 if dtype == "bfloat16" else tdt)
    assert str(got.dtype).endswith(str(wdt))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        _within_ulp(got.numpy(), want, np.float64 if x64 else np.float32)
    # the whole robot: pre-transform, then the body
    want, _ = _jax_eval(jshape.sdf_xy, (p[:, 0], p[:, 1]), jdt, x64)
    got = shape.sdf_xy(*(torch.as_tensor(p[:, k]).to(tdt) for k in range(2)))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        _within_ulp(got.numpy(), want, np.float64 if x64 else np.float32)


def test_cpu_sqrt_ulp_is_pytorchs():
    """The one ulp the float bodies are held at comes from PyTorch's CPU
    square root: at 66.54899f JAX's root (eager and jitted) is float64's
    root rounded to float32, the correctly rounded one, and PyTorch's lies
    within one ulp of it (PyTorch 2.13's AVX512 CPU kernel gives one below)."""
    x = np.float32(66.54899)
    want = np.float32(np.sqrt(np.float64(x)))
    with jax.enable_x64(False):
        for got in (jnp.sqrt(jnp.float32(x)),
                    jax.jit(jnp.sqrt)(jnp.full((64,), x, jnp.float32))[0]):
            assert np.asarray(got).view(np.uint32) == want.view(np.uint32)
    _within_ulp(torch.sqrt(torch.tensor([x])).numpy(), [want], np.float32)


def test_bfloat16_clamp_case(objs):
    """The r = 1.5 cylinder's 141 x 141 grid: in bfloat16 nx - 1.001
    rounds to 140 = nx - 1, so x = 3.49 clips to the last cell and its
    corner 141 reads cell 140 (2.0 in bfloat16, 1.99 in float32), as
    JAX's clamped gather does; scan_constants gives the kernel that bound."""
    shape = mesh_sdf.shape_from_mesh(objs["cylinder"])
    g = shape.grid
    assert (g.nx, g.ny) == (141, 141)
    assert g.scan_constants(torch.bfloat16)[3] == g.nx - 1
    assert g.scan_constants(torch.float32)[3] == np.float32(g.nx - 1.001)
    x = torch.tensor([3.49]), torch.tensor([0.0])
    bf = float(shape.sdf_xy(*(v.to(torch.bfloat16) for v in x)))
    f32 = float(shape.sdf_xy(*x))
    assert bf == 2.0 and abs(f32 - 1.99) < 1e-5
    want, _ = _jax_eval(_jgrid(jmesh.shape_from_mesh(objs["cylinder"])).sdf_xy,
                        (np.asarray([3.49]), np.asarray([0.0])),
                        jnp.bfloat16, False)
    assert want[0] == bf


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_grid_sdf3d_matches_jax(dtype):
    V, F = _unit_cube_mesh()
    jg = jmesh.grid_sdf_3d(V, F, resolution=0.1, margin=0.8)
    g = mesh_sdf.grid_sdf_3d(V, F, resolution=0.1, margin=0.8)
    tdt, jdt, x64 = DTYPES[dtype]
    rng = np.random.default_rng(5)
    p = np.concatenate([rng.uniform(-2.5, 2.5, (600, 3)),
                        rng.uniform(1.29, 1.3, (40, 3))])
    want, wdt = _jax_eval(jg.sdf_xyz, (p[:, 0], p[:, 1], p[:, 2]), jdt, x64)
    got = g.sdf_xyz(*(torch.as_tensor(p[:, k]).to(tdt) for k in range(3)))
    assert str(got.dtype).endswith(str(wdt))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        _within_ulp(got.numpy(), want, np.float64 if x64 else np.float32)


def test_sdf_grad_matches_jax(robots):
    """Autograd through the bilinear body, the clips and the outside term
    against jax.grad, float64."""
    for shape, jshape in robots.values():
        p = _points(shape.grid, 400, seed=9)
        val, grad = shape.sdf_grad(torch.as_tensor(p))
        with jax.enable_x64(True):
            jv = np.asarray(jshape.sdf(jnp.asarray(p)))
            jgr = np.asarray(jax.vmap(jax.grad(jshape.sdf))(jnp.asarray(p)))
        _within_ulp(val.numpy(), jv, np.float64)
        np.testing.assert_allclose(grad.numpy(), jgr, rtol=0, atol=1e-12)


def test_shape_from_objpath_routes_meshes(objs, tmp_path):
    shape = shapes.shape_from_objpath(objs["cylinder"])
    assert shape.name == "mesh:roundRobot" and shape.grid is not None
    assert abs(float(shape.sdf(torch.zeros((1, 2)))[0]) + 1.5) < 0.05
    # a known analytic stem still wins, a missing file is the fallback
    p = tmp_path / "sdHeart.obj"
    p.write_text("v 0 0 0\n")
    assert shapes.shape_from_objpath(str(p)).name == "sdHeart"
    assert shapes.shape_from_objpath(str(tmp_path / "nope.obj")).name == \
        "Polygon"
    # the JAX package routes the same way
    assert jshapes.shape_from_objpath(objs["cylinder"]).name == shape.name


def test_mesh_shape_from_fields_matches_obj(robots):
    shape, jshape = robots["heart"]
    jg = _jgrid(jshape)
    got = convert.mesh_shape_from_fields(
        jg.values, jg.x0, jg.y0, jg.step, jg.nx, jg.ny, jshape.tx, jshape.ty,
        jshape.yaw0, jshape.name)
    assert (got.name, got.tx, got.ty, got.yaw0) == (shape.name, shape.tx,
                                                    shape.ty, shape.yaw0)
    np.testing.assert_array_equal(got.grid.values, shape.grid.values)
    p = torch.as_tensor(_points(shape.grid, 500, seed=2))
    assert torch.equal(got.sdf(p), shape.sdf(p))
    assert cs.body_id(got) == cs.GRID_BODY_ID


def _scan_case(grid, m, k, seed):
    """Points across the grid, past it and in the bfloat16 clamp zone (the
    grid's last cells, reached with the identity poses at the path's
    start), and a wiggly pose path, float32."""
    p = _points(grid, m, seed).astype(np.float32)
    t = np.linspace(0.0, 1.0, k)
    xy = np.stack([8 * t - 4, 2 * np.sin(5 * t)], -1).astype(np.float32)
    yaw = (2.0 * np.sin(3 * t)).astype(np.float32)
    xy[:3] = 0.0
    yaw[:3] = 0.0
    return p, xy, np.cos(yaw), np.sin(yaw), t.astype(np.float32)


@pytest.mark.parametrize("scan_dtype", [None, "bfloat16"])
def test_scan_matches_jax_table_scan(robots, scan_dtype):
    shape, jshape = robots["heart"]
    pts, xy, c, s, t = _scan_case(shape.grid, 700, 37, seed=4)
    with jax.enable_x64(False):
        table = jsv.PoseTable(*(jnp.asarray(a) for a in (t, xy, c, s)))
        f = np.asarray(jsv._sdf_from_table(jshape, table, jnp.asarray(pts),
                                           dtype=scan_dtype))
    assert f.dtype == np.float32
    T = lambda a: torch.as_tensor(a)[None]
    mn, ar, fm, fp = cs.coarse_scan_reference(shape, T(pts), T(xy), T(c),
                                              T(s), scan_dtype=scan_dtype)
    k = f.shape[1]
    at = lambda i: f[np.arange(len(f)), np.clip(i, 0, k - 1)]
    if scan_dtype is None:
        _within_ulp(mn[0].numpy(), f.min(1), np.float32)
        return
    np.testing.assert_array_equal(mn[0].numpy(), f.min(1))
    np.testing.assert_array_equal(ar[0].numpy(), f.argmin(1))
    np.testing.assert_array_equal(fm[0].numpy(), at(ar[0].numpy() - 1))
    np.testing.assert_array_equal(fp[0].numpy(), at(ar[0].numpy() + 1))


@pytest.mark.parametrize("scan_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("s", [1, 2, 4, 8, 16, 32])
def test_split_model_matches_plain_scan(robots, s, scan_dtype):
    """The kernel's algorithm (K split across S lanes, the butterfly, the
    neighbours recomputed by evaluating the body again) bit for bit
    against the plain scan, for a mesh robot, K < S included."""
    shape, _ = robots["heart"]
    for k in (3, 37, 64):
        pts, xy, c, sn, _t = _scan_case(shape.grid, 300, k, seed=k)
        inp = tuple(torch.as_tensor(a)[None].repeat(2, *([1] * a.ndim))
                    for a in (pts, xy, c, sn))
        got = cs.coarse_scan_split_reference(shape, *inp, s, scan_dtype)
        want = cs.coarse_scan_reference(shape, *inp, scan_dtype)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_mesh_tables_are_cached_and_device_free(robots):
    shape, _ = robots["cylinder"]
    g = shape.grid
    a = g.table("cpu")
    assert a is g.table(torch.device("cpu"))
    assert a.dtype == torch.float32 and a.shape == (g.nx, g.ny)
    assert g.table("cpu", torch.float64).dtype == torch.float64
    assert not g.field.flags.writeable
    # hashing a mesh robot does not hash its grid's values
    assert hash(shape) == hash(shape)
    assert math.isfinite(float(shape.sdf(torch.zeros(1, 2))[0]))
