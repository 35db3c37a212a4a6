"""Port parity: the C++ host runtime (svsdf_tpu_torch/native/, built from
csrc/runtime.cpp) against the port's Python loops and the JAX package's
native calls, on tests/test_native.py's cases.

  * the library builds under the port's build directory, named by the
    source's digest, and never loads the JAX package's library;
  * voxelization: native, the numpy route and JAX's native call give the
    same occupancy;
  * A* at seeds 1-3, with and without the transition veto: native and the
    Python loop give the same path, yaw bins and expansion count, and so
    does JAX's native search; no path fails the same way on both routes;
  * marching squares: native and the Python loop give the same segments
    as unordered sets (endpoints within 1e-9 m: the native route reads
    the field in float32 and places points as x0 + (i + t) * step), both
    reconstruct the circle; native equal to JAX's native call to the bit;
  * esdf2d against ``ops/esdf.py`` at 1e-4 m (test_native.py's limit) and
    JAX's native call to the bit;
  * the port's ``Planner`` maps of the five synthetic scenarios: native and
    Python A* give the same cells, bins and expansions at every guard of
    the ladder;
  * ``bench.write_prism_obj`` writes the same file with and without the
    runtime (it keeps the float64 Python loop).

The JAX side skips when the JAX package's runtime is unavailable, as
tests/test_native.py does.
"""

import numpy as np
import pytest
import torch

from chip_smoke import same_segments
from svsdf_tpu import native as jnative
from svsdf_tpu_torch import native
from svsdf_tpu_torch.models import shapes
from svsdf_tpu_torch.ops import esdf as esdf_ops
from svsdf_tpu_torch.ops import kernels as kops
from svsdf_tpu_torch.ops.cuda_svsdf import BUILD_DIR
from svsdf_tpu_torch.planner import astar
from svsdf_tpu_torch.planner.pipeline import Planner
from svsdf_tpu_torch.utils import fixtures
from svsdf_tpu_torch.utils.gridmap import GridMap
from svsdf_tpu_torch.viz import swept_surface as sw

torch.set_num_threads(1)

jax_native = pytest.mark.skipif(not jnative.available(),
                                reason="the JAX package's runtime is not "
                                "built")


@pytest.fixture(autouse=True)
def _built():
    assert native.available(), native.build_log()


def _random_world(seed, n=400):
    """tests/test_native.py::_random_world."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([0, 0, 0], [30, 20, 2], size=(n, 3))
    keep = ~(((pts[:, 0] < 6) & (pts[:, 1] < 6))
             | ((pts[:, 0] > 24) & (pts[:, 1] > 14)))
    return np.vstack([pts[keep], [[0.0, 0.0, 0.0], [30.0, 20.0, 2.0]]])


def test_library_lives_in_the_port_build_dir():
    path = native.library_path()
    assert path.parent == BUILD_DIR and path.exists()
    assert path.name.startswith("libsvsdfrt_") and path.suffix == ".so"
    loaded = native._load()._name
    assert loaded == str(path)
    assert "svsdf_tpu/native" not in loaded
    # the digest names the source: other source, another library
    assert native.library_path() == path


def test_voxelize_matches_numpy_and_jax(monkeypatch):
    pts = _random_world(0)
    g_native = GridMap.from_points(pts, 1.0, 1)
    xyz_min = pts.min(axis=0)
    shape = np.maximum(np.ceil((pts.max(0) - xyz_min) / 1.0).astype(int), 1)
    idx = np.clip(np.floor((pts - xyz_min) / 1.0).astype(int), 0, shape - 1)
    counts = np.zeros(shape, np.int32)
    np.add.at(counts, (idx[:, 0], idx[:, 1], idx[:, 2]), 1)
    np.testing.assert_array_equal(g_native.occ, counts >= 1)
    assert g_native.occ.dtype == np.uint8
    for thr in (1, 2):
        v = native.voxelize(pts, xyz_min, 0.5, tuple(shape * 2), thr)
        monkeypatch.setattr(native, "available", lambda: False)
        g_py = GridMap.from_points(pts, 0.5, thr)
        monkeypatch.undo()
        np.testing.assert_array_equal(v, g_py.occ.astype(bool))
        if jnative.available():
            np.testing.assert_array_equal(
                v, jnative.voxelize(pts, xyz_min, 0.5, tuple(shape * 2),
                                    thr))


def _astar_maps(seed, with_trans):
    pts = _random_world(seed)
    grid = GridMap.from_points(pts, 1.0, 1)
    shape = shapes.make_shape("Circle")
    K = 4
    kern = kops.rasterize_shape_kernels(shape, 5, K, 1.0, 0.3, device="cpu")
    feas = kops.feasibility_maps(grid.occ2d, kern, device="cpu").numpy()
    trans = None
    if with_trans:
        st = kops.transition_stencils(shape, K, 1.0, 2.0, device="cpu")
        trans = kops.transition_feasibility(grid.occ2d, st,
                                            device="cpu").numpy()
    return grid, feas, trans, K


def _same(a, b):
    assert a.success == b.success
    assert a.expansions == b.expansions
    np.testing.assert_array_equal(a.path, b.path)
    np.testing.assert_array_equal(a.yaw_bins, b.yaw_bins)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("with_trans", [False, True])
def test_astar_native_matches_python(seed, with_trans):
    grid, feas, trans, K = _astar_maps(seed, with_trans)
    start = np.array([1.0, 1.0, 0.0])
    goal = np.array([28.5, 18.5, 0.0])
    r_py = astar.search(grid, feas, trans, start, goal, K, use_native=False)
    r_cc = astar.search(grid, feas, trans, start, goal, K, use_native=True)
    assert r_py.expansions > 0
    _same(r_cc, r_py)
    # the default is the native route
    _same(astar.search(grid, feas, trans, start, goal, K), r_cc)


@jax_native
@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("with_trans", [False, True])
def test_astar_native_matches_jax_native(seed, with_trans):
    from svsdf_tpu.ops.kernels import YAW_BFS_DELTAS
    grid, feas, trans, K = _astar_maps(seed, with_trans)
    si = grid.grid_index(np.array([1.0, 1.0, 0.0]))[:2]
    gi = grid.grid_index(np.array([28.5, 18.5, 0.0]))[:2]
    deltas = np.asarray(YAW_BFS_DELTAS, np.int32)
    cells, exp = native.astar(feas, trans, grid.occ2d, si, gi, 0, deltas)
    jcells, jexp = jnative.astar(feas, trans, grid.occ2d, si, gi, 0, deltas)
    assert exp == jexp
    if jcells is None:
        assert cells is None
    else:
        np.testing.assert_array_equal(cells, jcells)


def test_astar_native_no_path():
    occ = np.zeros((12, 12, 1), np.uint8)
    occ[6, :, 0] = 1                     # a full wall
    grid = GridMap(resolution=1.0, xyz_min=np.zeros(3), occ=occ)
    feas = (~occ[:, :, 0].astype(bool))[None].repeat(4, axis=0)
    args = (grid, feas, None, np.array([1.0, 1.0, 0.0]),
            np.array([10.0, 10.0, 0.0]), 4)
    r_cc = astar.search(*args, use_native=True)
    r_py = astar.search(*args, use_native=False)
    assert not r_cc.success and r_cc.path.shape == (0, 3)
    _same(r_cc, r_py)


def _circle_field():
    xs = np.arange(-2.0, 2.01, 0.1)
    ys = np.arange(-2.0, 2.01, 0.1)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    return xs, ys, (np.sqrt(gx ** 2 + gy ** 2) - 1.3).astype(np.float32)


def test_marching_squares_matches_python(monkeypatch):
    xs, ys, field = _circle_field()
    segs_cc = sw.marching_squares(xs, ys, field)            # native route
    monkeypatch.setattr(native, "available", lambda: False)
    segs_py = sw.marching_squares(xs, ys, field)
    monkeypatch.undo()
    assert len(segs_cc) == len(segs_py) > 40
    same, worst = same_segments(segs_cc, segs_py, 1e-6)
    assert same, worst
    tot_cc = sum(np.linalg.norm(b - a) for a, b in segs_cc)
    tot_py = sum(np.linalg.norm(b - a) for a, b in segs_py)
    assert abs(tot_cc - tot_py) < 1e-6
    assert abs(tot_cc - 2 * np.pi * 1.3) < 0.05
    for a, b in segs_cc:
        for p in (a, b):
            assert abs(np.hypot(*p) - 1.3) < 0.01


@jax_native
def test_marching_squares_matches_jax_native():
    xs, ys, field = _circle_field()
    got = native.marching_squares(field, xs[0], ys[0], 0.1, 0.05)
    want = jnative.marching_squares(field, xs[0], ys[0], 0.1, 0.05)
    assert got.shape == want.shape and len(got) > 40
    np.testing.assert_array_equal(got, want)


def test_esdf2d_matches_device_op_and_jax():
    rng = np.random.default_rng(5)
    occ = rng.random((40, 30)) < 0.1
    occ[0, 0] = True                       # at least one obstacle
    d_cc = native.esdf2d(occ, 0.5)
    d_dev = esdf_ops.esdf(occ[..., None], 0.5, device="cpu").numpy()[:, :, 0]
    np.testing.assert_allclose(d_cc, d_dev, atol=1e-4)
    if jnative.available():
        np.testing.assert_array_equal(d_cc, jnative.esdf2d(occ, 0.5))


@pytest.fixture(scope="module")
def planners():
    out = {}
    for name in fixtures.list_synthetic_scenarios():
        sc = fixtures.synthetic_scenario(name)
        out[name] = (Planner(sc.config, sc.map_points, device="cpu"), sc)
    return out


@pytest.mark.parametrize("name", fixtures.list_synthetic_scenarios())
def test_planner_astar_native_matches_python(planners, name):
    pl, sc = planners[name]
    K = sc.config.kernel_yaw_num
    for guard in pl.guard_ladder:
        trans = pl._trans_feas(guard)
        r_cc = astar.search(pl.grid, pl.feas, trans, np.asarray(sc.start),
                            np.asarray(sc.goal), K, use_native=True)
        r_py = astar.search(pl.grid, pl.feas, trans, np.asarray(sc.start),
                            np.asarray(sc.goal), K, use_native=False)
        _same(r_cc, r_py)
    # the Planner's own front end runs the native route
    res = pl.generate_path(sc.start, sc.goal)
    assert res.success
    _same(res, astar.search(pl.grid, pl.feas, pl._trans_feas(
        pl.guard_ladder[0]), np.asarray(sc.start), np.asarray(sc.goal), K,
        use_native=False))


def test_prism_writer_keeps_the_float64_loop(monkeypatch, tmp_path):
    """bench.write_prism_obj traces its contour with the Python loop on the
    float64 field whether or not the runtime is built: the mesh robots'
    vertices do not move with the host's toolchain."""
    from svsdf_tpu_torch.bench import write_prism_obj
    a = write_prism_obj("Circle", str(tmp_path / "a.obj"), extent=2.0)
    monkeypatch.setattr(native, "available", lambda: False)
    b = write_prism_obj("Circle", str(tmp_path / "b.obj"), extent=2.0)
    assert open(a).read() == open(b).read()
