"""Port parity: deformable robots (models/shapes.py ScaledShape) and the
deformable scenarios (utils/fixtures.py) in the Planner.

  * tests/test_deformable.py's cases on the port, float64: the scaled SDF
    is exact, ``dot_scale`` (autograd) matches finite differences and
    ``jax.grad``, the SVSDF query matches brute force and the closed form
    of a growing circle, its world gradient matches finite differences,
    GSIP finds the inside of the breathing tube, and the time-free SDF
    evaluates at ``kernel_scale``; each query also against the JAX
    package's at atol 1e-9;
  * ``convert.scaled_shape_from_fields`` carries a JAX ScaledShape across:
    the same values in float64 (1e-12) and, at ``scan_dtype="bfloat16"``,
    bit for bit against ``_sdf_from_table`` (which casts the pose times
    to bfloat16 before the scale schedule sees them);
  * the three deformable scenarios equal the JAX package's, and
    ``load_any`` dispatches by name;
  * one whole ``Planner.plan`` on deformable_rhombus (its back end runs)
    against the JAX ``Planner``, float64, at tests/test_torch_pipeline.py's
    1e-5 cost and 1e-4 m certificate. The back-end stages stop at a
    relative stall of 0.05: at the scenario's own 1e-6 the solve
    amplifies rounding past that gate (a 1e-14 perturbation of the warm
    start moves the final cost by 4.1e-5; ROADMAP C).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svsdf_tpu.models import shapes as jshapes
from svsdf_tpu.ops import svsdf as jsv
from svsdf_tpu.ops.svsdf import SVSDFConfig as JSVSDFConfig
from svsdf_tpu.planner.pipeline import Planner as JPlanner
from svsdf_tpu.utils import fixtures as jfixtures
from svsdf_tpu.utils import trajectory as jtrj
from svsdf_tpu_torch import convert
from svsdf_tpu_torch.models import shapes
from svsdf_tpu_torch.ops import cuda_svsdf as cs
from svsdf_tpu_torch.ops import minco
from svsdf_tpu_torch.ops import svsdf as sv
from svsdf_tpu_torch.ops.svsdf import SVSDFConfig
from svsdf_tpu_torch.planner.pipeline import Planner
from svsdf_tpu_torch.utils import fixtures
from svsdf_tpu_torch.utils import trajectory as trj

torch.set_num_threads(1)

F64 = torch.float64


def _t(a):
    return torch.as_tensor(a, dtype=F64)


def _straight_traj(n=4, t_piece=2.0):
    """tests/test_deformable.py::_straight_traj, one plan, and its JAX
    form."""
    head = np.zeros((1, 3, 3))
    tail = np.zeros((1, 3, 3))
    tail[0, 0] = [10.0, 0.0, 0.0]
    frac = np.linspace(0, 1, n + 1)[1:-1]
    wps = np.stack([frac * 10.0, 0 * frac, 0 * frac], -1)[None]
    traj = minco.solve(_t(np.full((1, n), t_piece)), _t(head), _t(tail),
                       _t(wps))
    jtraj = jtrj.Trajectory(jnp.asarray(traj.coeffs[0].numpy()),
                            jnp.asarray(traj.durations[0].numpy()))
    return traj, jtraj


def _breathing_circle(amp=0.5):
    return (shapes.make_scaled_shape("Circle",
                                     lambda t: 1.0 + amp * torch.sin(t)),
            jshapes.make_scaled_shape("Circle",
                                      lambda t: 1.0 + amp * jnp.sin(t)))


def _query(pair, traj, jtraj, pts, with_inside):
    """The port's and the JAX package's svsdf_query on one plan: both
    results as numpy (sdf, t*, grad)."""
    shape, jshape = pair
    res = sv.svsdf_query(shape, traj, _t(pts)[None], with_inside=with_inside)
    jres = jsv.svsdf_query(jshape, jtraj, jnp.asarray(pts),
                           with_inside=with_inside)
    port = tuple(v[0].numpy() for v in res)
    for a, b in zip(port, jres):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-9)
    return port


def test_scaled_shape_sdf_exactness():
    shape, _ = _breathing_circle()
    for t in [0.0, 0.7, 2.0]:
        v = float(shape.sdf_xy_t(_t(3.0), _t(4.0), _t(t)))
        np.testing.assert_allclose(v, 5.0 - (1.0 + 0.5 * np.sin(t)),
                                   rtol=1e-12)


def test_dot_scale_matches_fd_and_jax():
    shape, jshape = _breathing_circle()
    ts = np.asarray([0.1, 1.3, 4.0])
    ds = shape.dot_scale(_t(ts)).numpy()
    fd = (shape.scale(_t(ts + 1e-6)) - shape.scale(_t(ts - 1e-6))).numpy() \
        / 2e-6
    np.testing.assert_allclose(ds, fd, rtol=1e-4)
    np.testing.assert_allclose(ds, np.asarray(jshape.dot_scale(ts)),
                               rtol=1e-14)
    assert shape.dot_scale(1.3).dtype == torch.get_default_dtype()


def test_svsdf_matches_bruteforce_deformable():
    pair = _breathing_circle()
    traj, jtraj = _straight_traj()
    pts = np.random.default_rng(1).uniform([-2, -4], [12, 4], size=(24, 2))
    sdf, _, _ = _query(pair, traj, jtraj, pts, with_inside=False)
    ts = torch.linspace(0.0, float(traj.total_duration[0]), 60001,
                        dtype=F64)[None]
    xy, _, R = trj.state_se2(traj, ts)
    p_rel = trj.world_to_body(xy[:, None], R[:, None], _t(pts)[None, :, None])
    brute = pair[0].sdf_t(p_rel, ts[:, None]).min(-1).values[0]
    np.testing.assert_allclose(sdf, brute.numpy(), atol=3e-4)


def test_deformable_closed_form_straight_line():
    """A growing circle above a straight path: min_t |p - x(t)| - s(t),
    which differs from the rigid answer."""
    pair = _breathing_circle(amp=0.8)
    traj, jtraj = _straight_traj()
    p = np.asarray([[5.0, 3.5]])
    sdf_def = _query(pair, traj, jtraj, p, with_inside=False)[0]
    rigid = (shapes.make_shape("Circle"), jshapes.make_shape("Circle"))
    sdf_rig = _query(rigid, traj, jtraj, p, with_inside=False)[0]
    ts = torch.linspace(0.0, float(traj.total_duration[0]), 100001,
                        dtype=F64)
    xy = trj.pos(traj, ts[None])[0, :, :2]
    dist = torch.linalg.norm(_t(p[0])[None] - xy, dim=-1)
    want_def = float((dist - (1.0 + 0.8 * torch.sin(ts))).min())
    want_rig = float((dist - 1.0).min())
    np.testing.assert_allclose(sdf_def[0], want_def, atol=3e-4)
    np.testing.assert_allclose(sdf_rig[0], want_rig, atol=3e-4)
    assert abs(want_def - want_rig) > 0.05


def test_deformable_grad_world_matches_fd():
    pair = _breathing_circle()
    traj, jtraj = _straight_traj()
    pts = np.asarray([[5.0, 2.5], [1.0, -3.0]])
    _, _, grad = _query(pair, traj, jtraj, pts, with_inside=False)
    eps = 1e-4
    for i in range(len(pts)):
        g_fd = np.zeros(2)
        for k in range(2):
            dp = np.zeros(2)
            dp[k] = eps
            at = lambda q: float(sv.svsdf_query(
                pair[0], traj, _t(q)[None], with_inside=False).sdf[0, 0])
            g_fd[k] = (at(pts[i:i + 1] + dp) - at(pts[i:i + 1] - dp)) / (
                2 * eps)
        np.testing.assert_allclose(grad[i], g_fd, atol=5e-3)


def test_deformable_gsip_inside():
    """A point inside the breathing tube (half-width 0.7..1.3 at x = 5):
    the GSIP distance is negative and no deeper than the largest radius."""
    pair = _breathing_circle(amp=0.3)
    traj, jtraj = _straight_traj()
    sdf, _, _ = _query(pair, traj, jtraj, np.asarray([[5.0, 0.0]]),
                       with_inside=True)
    assert -1.35 < float(sdf[0]) < 0.0


def test_kernel_rasterization_uses_kernel_scale():
    shape = shapes.make_scaled_shape(
        "Circle", lambda t: 1.0 + 0.5 * torch.sin(t), kernel_scale=1.5)
    np.testing.assert_allclose(float(shape.sdf_xy(_t(3.0), _t(0.0))),
                               3.0 - 1.5, rtol=1e-12)
    assert shape.time_varying and not shapes.make_shape("Circle").time_varying


#: body -> (amplitude, rate, kernel scale) of a breathing schedule
SCHEDULES = {"sdHeart": (0.25, 0.8, 1.25), "sdRhombus": (0.2, 0.8, 1.2),
             "star": (0.35, 0.9, 1.35), "Polygon": (0.3, 0.7, 1.3)}


def _carried(name, pre=(0.3, -0.2, 25.0)):
    """A JAX ScaledShape and the port's, carried across by its fields."""
    amp, w, ks = SCHEDULES[name]
    jshape = jshapes.make_scaled_shape(
        name, lambda t: 1.0 + amp * jnp.sin(w * t), poly_params=pre,
        kernel_scale=ks)
    verts = shapes.make_shape(name).vertices
    shape = convert.scaled_shape_from_fields(
        jshape.name, shapes.breathing_scale(amp, w), jshape.tx,
        jshape.ty, jshape.yaw0, jshape.kernel_scale, vertices=verts)
    assert (shape.tx, shape.ty, shape.yaw0, shape.kernel_scale) == (
        jshape.tx, jshape.ty, jshape.yaw0, jshape.kernel_scale)
    return shape, jshape


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_carried_shape_matches_jax(name):
    shape, jshape = _carried(name)
    rng = np.random.default_rng(3)
    px, py = rng.uniform(-6, 6, (2, 400))
    t = rng.uniform(0, 12, 400)
    np.testing.assert_allclose(
        shape.sdf_xy_t(_t(px), _t(py), _t(t)).numpy(),
        np.asarray(jshape.sdf_xy_t(jnp.asarray(px), jnp.asarray(py),
                                   jnp.asarray(t))), rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        shape.sdf_xy(_t(px), _t(py)).numpy(),
        np.asarray(jshape.sdf_xy(jnp.asarray(px), jnp.asarray(py))),
        rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["sdHeart", "sdRhombus", "star"])
def test_scaled_bf16_matrix_matches_jax_table_scan(name):
    """The time-varying bfloat16 scan: the plain version's (B, M, K)
    matrix bit for bit against _sdf_from_table(dtype="bfloat16"), and
    the scan's min and first argmin against JAX's on that matrix."""
    shape, jshape = _carried(name)
    rng = np.random.default_rng(len(name))
    m, k = 300, 64
    pts = rng.uniform(-6, 6, (m, 2)).astype(np.float32)
    u = np.linspace(0.0, 1.0, k)
    ts = (12.0 * u).astype(np.float32)
    xy = np.stack([8 * u - 4, 2 * np.sin(5 * u)], -1).astype(np.float32)
    yaw = (2.0 * np.sin(3 * u)).astype(np.float32)
    c, s = np.cos(yaw), np.sin(yaw)
    table = jsv.PoseTable(*(jnp.asarray(a) for a in (ts, xy, c, s)))
    want = np.asarray(jsv._sdf_from_table(
        jshape, table, jnp.asarray(pts), dtype="bfloat16")).astype(np.float32)
    f = lambda a: torch.as_tensor(a)[None]
    got = cs.scan_matrix(shape, *(f(a).to(torch.bfloat16)
                                  for a in (pts, xy, c, s, ts)))[0]
    np.testing.assert_array_equal(got.float().numpy(), want)
    mn, ar, _, _ = cs.coarse_scan_reference(shape, f(pts), f(xy), f(c), f(s),
                                            scan_dtype="bfloat16", ts=f(ts))
    np.testing.assert_array_equal(ar[0].numpy(), want.argmin(1))
    np.testing.assert_array_equal(mn[0].numpy(), want.min(1))


def test_deformable_fixtures_match_jax(tmp_path):
    assert (fixtures.list_deformable_scenarios()
            == jfixtures.list_deformable_scenarios())
    t = np.linspace(0.0, 20.0, 41)
    for name in fixtures.list_deformable_scenarios():
        sc, jsc = fixtures.load_any(name), jfixtures.load_any(name)
        assert sc.name == jsc.name == name
        assert dataclasses.asdict(sc.config) == dataclasses.asdict(
            jsc.config)
        for a in ("map_points", "start", "goal"):
            np.testing.assert_array_equal(getattr(sc, a), getattr(jsc, a))
        assert sc.shape.name == jsc.shape.name
        assert sc.shape.kernel_scale == jsc.shape.kernel_scale
        np.testing.assert_allclose(sc.shape.scale(_t(t)).numpy(),
                                   np.asarray(jsc.shape.scale(t)),
                                   rtol=1e-15)
    syn = fixtures.load_any("synthetic_Circle")
    assert syn.name == "synthetic_Circle" and syn.shape is None
    # the reference's scenarios and mesh robots come from its checkout,
    # which this directory is not: both packages' loaders find no file
    for name in ("sdHeart", "mesh_sdHeart"):
        for loader in (fixtures.load_any, jfixtures.load_any):
            with pytest.raises(FileNotFoundError):
                loader(name, str(tmp_path))
    with pytest.raises(KeyError):
        fixtures.deformable_scenario("deformable_square")


SVS = dict(coarse_n=128, refine_rounds=2, gsip_iters=4, gsip_coarse_n=48,
           gsip_refine_rounds=1)
ITERS = dict(mid_iters=60, back_iters=120)
STALL = 0.05


@pytest.fixture(scope="module")
def jax_rhombus_plan():
    jax.config.update("jax_enable_x64", True)
    jsc = jfixtures.deformable_scenario("deformable_rhombus")
    jpl = JPlanner(dataclasses.replace(jsc.config, back_rel_stall=STALL),
                   jsc.map_points, svs_cfg=JSVSDFConfig(**SVS),
                   shape=jsc.shape)
    return jpl, jpl.plan(jsc.start, jsc.goal, **ITERS)


def test_planner_deformable_rhombus_matches_jax(jax_rhombus_plan):
    jpl, jres = jax_rhombus_plan
    sc = fixtures.deformable_scenario("deformable_rhombus")
    pl = Planner(dataclasses.replace(sc.config, back_rel_stall=STALL),
                 sc.map_points, svs_cfg=SVSDFConfig(**SVS), shape=sc.shape,
                 device="cpu", dtype=F64)
    assert pl.shape is sc.shape
    # the front end's kernels rasterize the max-scale footprint
    np.testing.assert_array_equal(pl.feas, jpl.feas)
    np.testing.assert_array_equal(pl._conservative_feas(),
                                  jpl._conservative_feas())
    res = pl.plan(sc.start, sc.goal, **ITERS)
    assert res.success and jres.success
    assert res.certified and jres.certified
    np.testing.assert_array_equal(res.astar_path, jres.astar_path)
    np.testing.assert_allclose(res.mid_cost, jres.mid_cost, rtol=1e-6)
    for key in ("attempts", "refine_rounds", "n_obstacles"):
        assert res.timings[key] == jres.timings[key], key
    np.testing.assert_array_equal(res.obstacles, jres.obstacles)
    np.testing.assert_allclose(res.final_cost, jres.final_cost, rtol=1e-5)
    np.testing.assert_allclose(res.min_cert_sdf, jres.min_cert_sdf, rtol=0,
                               atol=1e-4)
    # the certificate sees the time-varying sweep: re-computed, it agrees
    pts, sdf = pl.certify(res.traj)
    assert len(pts) > 0 and float(sdf.min()) == res.min_cert_sdf
    end = trj.pos(res.traj, res.traj.total_duration[:, None])[0, 0, :2]
    np.testing.assert_allclose(end.numpy(), sc.goal[:2], atol=1e-6)
