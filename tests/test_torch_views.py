"""Port parity: the views and their helpers — ``viz/dashboard.py`` (with
the live optimizer monitor on the port's debug bus), ``utils/geo.py``
and ``viz/scene.py``.

Every case of tests/test_viz.py, test_geo.py and
test_live_observability.py runs on the port. Held besides:

  * ``render_dashboard`` writes JAX's HTML bytes from the same
    ``dump_jsonl`` file, and ``load_bus_jsonl`` reads JAX's bus back
    whole;
  * a live back-end solve logs one ``opti_cost`` entry an iteration it
    runs, at its counter (which skips the rest of a stage that converges
    early);
  * geo's hulls, Seidel LP and vertex enumeration equal JAX's outputs to
    the bit (the same host numpy);
  * ``shape_outline`` equals JAX's polyline within 1e-9 m (the same
    contour engine on SDF grids equal to ~1e-15);
  * ``viz/scene.py`` imports no matplotlib until it draws.
"""

import subprocess
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svsdf_tpu.models import shapes as jshapes
from svsdf_tpu.ops import minco as jminco
from svsdf_tpu.utils import geo as jgeo
from svsdf_tpu.utils.debugbus import DebugBus as JDebugBus
from svsdf_tpu.viz import dashboard as jdashboard
from svsdf_tpu.viz import scene as jscene
from svsdf_tpu_torch.models import shapes
from svsdf_tpu_torch.ops.svsdf import SVSDFConfig
from svsdf_tpu_torch.planner import back_end
from svsdf_tpu_torch.utils import geo
from svsdf_tpu_torch.utils import trajectory as trj
from svsdf_tpu_torch.utils.debugbus import BUS, DebugBus
from svsdf_tpu_torch.utils.transforms import backward_t
from svsdf_tpu_torch.viz import dashboard, scene

torch.set_num_threads(1)


# -- dashboard ---------------------------------------------------------------

def _bus(cls):
    bus = cls()
    bus.send("back_end", "optimization started", iters=50)
    for i in range(20):
        bus.log_scalar("cost", 100.0 / (i + 1), step=i)
    bus.log_scalar("lonely", 3.14)
    with bus.section("plan"):
        pass
    return bus


def test_dashboard_roundtrip(tmp_path):
    jl = str(tmp_path / "bus.jsonl")
    _bus(DebugBus).dump_jsonl(jl)
    bus2 = dashboard.load_bus_jsonl(jl)
    assert isinstance(bus2, DebugBus)
    assert len(bus2.events) == 1
    assert len(bus2.series["cost"]) == 20
    out = dashboard.render_dashboard(bus2, str(tmp_path / "dash.html"))
    txt = open(out).read()
    assert "polyline" in txt and "optimization started" in txt
    assert "plan" in txt


def test_dashboard_html_is_jaxs(tmp_path):
    """The same dump_jsonl file renders to the same HTML bytes; each
    package reads the other's dump."""
    jl = str(tmp_path / "jax_bus.jsonl")
    _bus(JDebugBus).dump_jsonl(jl)
    ours = dashboard.render_dashboard(dashboard.load_bus_jsonl(jl),
                                      str(tmp_path / "port.html"), "run")
    theirs = jdashboard.render_dashboard(jdashboard.load_bus_jsonl(jl),
                                         str(tmp_path / "jax.html"), "run")
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    pl = str(tmp_path / "port_bus.jsonl")
    _bus(DebugBus).dump_jsonl(pl)
    jb = jdashboard.load_bus_jsonl(pl)
    assert len(jb.series["cost"]) == 20 and len(jb.events) == 1


# -- the live monitor (test_live_observability.py) ----------------------------

SVS = SVSDFConfig(coarse_n=32, refine_rounds=1, refine_n=8,
                  use_inside=False)


def _problem(n=4):
    rng = np.random.default_rng(0)
    head = np.zeros((3, 3), np.float32)
    tail = np.zeros((3, 3), np.float32)
    tail[0] = [6.0, 0.5, 0.3]
    wps = np.stack([np.linspace(1.5, 4.5, n - 1),
                    rng.normal(0, 0.2, n - 1),
                    np.zeros(n - 1)], -1).astype(np.float32)
    obs = rng.uniform([0, -2.5], [6, 2.5], (12, 2)).astype(np.float32)
    x0 = np.concatenate([backward_t(torch.full((n,), 1.4)).numpy(),
                         wps.ravel()]).astype(np.float32)
    return head[None], tail[None], obs[None], x0[None]


def _reset_bus():
    BUS.series.clear()
    BUS.events.clear()
    BUS.clear_stop()
    BUS.resume()


def _optimize(live=True, max_iters=40):
    head, tail, obs, x0 = _problem()
    return back_end.optimize(shapes.make_shape("Circle"), head, tail, obs,
                             x0, svs_cfg=SVS, max_iters=max_iters,
                             live=live, device="cpu")


def test_live_stream_renders_dashboard_during_solve(tmp_path):
    _reset_bus()
    out = str(tmp_path / "live.html")
    with dashboard.LiveDashboard(BUS, out, interval_s=0.05) as live:
        res = _optimize(live=True)
    assert np.isfinite(float(res.cost[0]))
    steps = [st for (_, st, _) in BUS.series.get("opti_cost", [])]
    assert len(steps) >= 5
    # one entry an iteration run: the counter skips the rest of a stage
    # that converges early, and ends one past the last iteration
    assert all(a < b for a, b in zip(steps, steps[1:]))
    assert steps[-1] + 1 == int(res.n_iters[0])
    assert live.renders >= 1
    with open(out) as f:
        assert "opti_cost" in f.read()
    _reset_bus()


def test_stop_request_aborts_mid_solve():
    _reset_bus()
    BUS.request_stop()
    try:
        res = _optimize(live=True, max_iters=200)
        assert int(res.n_iters[0]) <= 2
    finally:
        _reset_bus()


def test_pause_and_single_step():
    _reset_bus()
    BUS.pause()
    done = {}

    def run():
        done["res"] = _optimize(live=True, max_iters=30)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        deadline = time.time() + 120
        while not BUS.series.get("opti_cost") and time.time() < deadline:
            time.sleep(0.02)
        n0 = len(BUS.series.get("opti_cost", []))
        assert n0 >= 1
        time.sleep(0.5)
        assert len(BUS.series["opti_cost"]) <= n0 + 1   # stalled
        BUS.step()                       # release exactly one iteration
        time.sleep(1.0)
        n1 = len(BUS.series["opti_cost"])
        assert n1 <= n0 + 2
    finally:
        BUS.resume()                     # release the gate; solve finishes
        t.join(timeout=120)
    assert not t.is_alive()
    assert "res" in done and np.isfinite(float(done["res"].cost[0]))
    assert len(BUS.series["opti_cost"]) > n1
    _reset_bus()


# -- geo (test_geo.py) ---------------------------------------------------------

def test_hull_square_with_interior_points():
    rng = np.random.default_rng(0)
    corners = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], float)
    pts = np.vstack([corners, rng.uniform(0.1, 0.9, (50, 2))])
    h = geo.convex_hull_2d(pts)
    assert len(h) == 4
    assert abs(geo.polygon_area(h) - 1.0) < 1e-12
    assert geo.polygon_area(h) > 0
    np.testing.assert_array_equal(h, jgeo.convex_hull_2d(pts))


def test_hull_collinear():
    pts = np.asarray([[0, 0], [1, 1], [2, 2], [3, 3]], float)
    assert len(geo.convex_hull_2d(pts)) == 2


def test_point_in_convex():
    h = geo.convex_hull_2d(
        np.asarray([[0, 0], [2, 0], [2, 2], [0, 2]], float))
    assert geo.point_in_convex_2d(h, [1, 1])
    assert not geo.point_in_convex_2d(h, [3, 1])


def test_seidel_lp_2d_matches_vertex():
    args = (np.asarray([-1.0, -1.0]),
            np.asarray([[1.0, 1.0], [-1.0, 0.0], [0.0, -1.0]]),
            np.asarray([1.0, 0.0, 0.0]))
    x = geo.seidel_lp(*args)
    assert abs(x.sum() - 1.0) < 1e-8
    assert (x >= -1e-9).all()
    np.testing.assert_array_equal(x, jgeo.seidel_lp(*args))


def test_seidel_lp_3d_random_vs_bruteforce():
    from itertools import combinations
    rng = np.random.default_rng(3)
    for trial in range(10):
        A = rng.normal(0, 1, (12, 3))
        b = rng.uniform(0.5, 2.0, 12)
        c = rng.normal(0, 1, 3)
        x = geo.seidel_lp(c, A, b, seed=trial)
        np.testing.assert_array_equal(x, jgeo.seidel_lp(c, A, b, seed=trial))
        assert (A @ x <= b + 1e-6).all()
        best = np.inf
        for ijk in combinations(range(len(A)), 3):
            M = A[list(ijk)]
            if abs(np.linalg.det(M)) < 1e-9:
                continue
            v = np.linalg.solve(M, b[list(ijk)])
            if (A @ v <= b + 1e-7).all() and np.abs(v).max() < 1e6:
                best = min(best, c @ v)
        if np.isfinite(best):
            assert c @ x <= best + 1e-5


def test_seidel_lp_infeasible_raises():
    with pytest.raises(ValueError):
        geo.seidel_lp(np.asarray([1.0, 0.0]),
                      np.asarray([[1.0, 0.0], [-1.0, 0.0]]),
                      np.asarray([-1.0, -1.0]))


def test_halfspace_vertices_unit_box():
    A = np.asarray([[1.0, 0], [-1, 0], [0, 1], [0, -1]])
    v = geo.halfspace_polytope_vertices_2d(A, np.ones(4))
    assert len(v) == 4
    assert abs(geo.polygon_area(v) - 4.0) < 1e-9
    np.testing.assert_array_equal(
        v, jgeo.halfspace_polytope_vertices_2d(A, np.ones(4)))


def test_convex_hull_3d_cube_with_interior_points():
    rng = np.random.default_rng(0)
    corners = np.asarray([[x, y, z] for x in (-1.0, 1.0)
                          for y in (-1.0, 1.0) for z in (-1.0, 1.0)])
    pts = np.concatenate([corners, rng.uniform(-0.9, 0.9, (200, 3))])
    V, F = geo.convex_hull_3d(pts)
    assert len(V) == 8
    assert {tuple(v) for v in V} == {tuple(c) for c in corners}
    edges = {frozenset((f[i], f[(i + 1) % 3])) for f in F for i in range(3)}
    assert len(V) - len(edges) + len(F) == 2
    assert abs(geo.polytope_volume_3d(V, F) - 8.0) < 1e-9
    for f in F:
        n = np.cross(V[f[1]] - V[f[0]], V[f[2]] - V[f[0]])
        assert ((V - V[f[0]]) @ n <= 1e-9).all()
    jV, jF = jgeo.convex_hull_3d(pts)
    np.testing.assert_array_equal(V, jV)
    np.testing.assert_array_equal(F, jF)


def test_convex_hull_3d_random_cloud_contains_all_points():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(300, 3))
    V, F = geo.convex_hull_3d(pts)
    for f in F:
        n = np.cross(V[f[1]] - V[f[0]], V[f[2]] - V[f[0]])
        n /= np.linalg.norm(n)
        assert ((pts - V[f[0]]) @ n <= 1e-7).all()
    inp = {tuple(np.round(p, 12)) for p in pts}
    assert all(tuple(np.round(v, 12)) in inp for v in V)
    vol = geo.polytope_volume_3d(V, F)
    assert 0.0 < vol < np.prod(pts.max(0) - pts.min(0))
    assert vol == jgeo.polytope_volume_3d(*jgeo.convex_hull_3d(pts))


def test_convex_hull_3d_degenerate_raises():
    with pytest.raises(ValueError):
        geo.convex_hull_3d(np.zeros((10, 3)))
    line = np.linspace(0, 1, 9)[:, None] * np.ones((1, 3))
    with pytest.raises(ValueError):
        geo.convex_hull_3d(line)
    rng = np.random.default_rng(1)
    planar = np.concatenate([rng.normal(size=(20, 2)), np.zeros((20, 1))],
                            axis=1)
    with pytest.raises(ValueError):
        geo.convex_hull_3d(planar)


# -- scene (test_viz.py) ---------------------------------------------------------

def _traj(n=4):
    head = np.zeros((3, 3), np.float32)
    tail = np.zeros((3, 3), np.float32)
    tail[0] = [6.0, 1.0, 0.5]
    wps = np.stack([np.linspace(1.5, 4.5, n - 1),
                    np.sin(np.linspace(0, 2, n - 1)),
                    np.linspace(0, 0.4, n - 1)], -1).astype(np.float32)
    jt = jminco.solve(jnp.full((n,), 1.2, jnp.float32), jnp.asarray(head),
                      jnp.asarray(tail), jnp.asarray(wps))
    return trj.Trajectory(torch.tensor(np.asarray(jt.coeffs))[None],
                          torch.tensor(np.asarray(jt.durations))[None])


def test_render_scene_all_layers(tmp_path):
    occ = np.zeros((40, 30), bool)
    occ[10:14, 5:25] = True
    out = scene.render_scene(
        str(tmp_path / "scene.png"), occupancy=occ, origin=(-2, -3),
        resolution=0.25,
        obstacles=np.random.default_rng(0).uniform(-2, 6, (30, 2)),
        astar_path=np.asarray([[0, 0], [2, 1], [4, 1], [6, 1]]),
        traj=_traj(), shape=shapes.make_shape("Circle"), n_poses=3,
        swept_contours=[np.asarray([[0, -1], [3, -1], [6, 0]])],
        title="test scene")
    import os
    assert os.path.getsize(out) > 10_000


@pytest.mark.parametrize("name,yaw", [("Circle", 0.3), ("sdHeart", -1.1)])
def test_shape_outline_matches_jax(name, yaw):
    o = scene.shape_outline(shapes.make_shape(name), yaw=yaw)
    jo = jscene.shape_outline(jshapes.make_shape(name), yaw=yaw)
    assert o.shape == jo.shape and len(o) > 20
    np.testing.assert_allclose(o, jo, rtol=0, atol=1e-9)
    if name == "Circle":
        np.testing.assert_allclose(np.linalg.norm(o, axis=1), 1.0,
                                   atol=0.12)


def test_write_obj_roundtrip(tmp_path):
    v = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], float)
    f = np.asarray([[0, 1, 2]])
    p = scene.write_obj(str(tmp_path / "m.obj"), v, f)
    txt = open(p).read()
    assert txt.count("v ") == 3 and "f 1 2 3" in txt
    jp = jscene.write_obj(str(tmp_path / "j.obj"), v, f)
    assert open(jp).read() == txt


def test_scene_imports_without_matplotlib():
    code = ("import sys; import svsdf_tpu_torch.viz.scene; "
            "print('matplotlib' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "False"
