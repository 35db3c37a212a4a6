"""Port parity: profiling, checkpoint/resume and the disk memo
(``utils/profiling.py``, ``utils/checkpoint.py``, ``utils/cache.py``).

The cases of tests/test_aux.py run on the port (its run_scenarios.py
merge case belongs to a JAX script, not a module of the package). Held
besides:

  * checkpoints interchangeable both ways: a ``.npz`` either package
    writes, the other loads, every array member's bytes equal to the
    other side's for the same plan;
  * ``shape_cache_key`` equal to JAX's string for the analytic shapes
    and the sdHeart prism (a mesh robot), with a Polygon's vertices
    added;
  * the ``Planner``'s disk memo (its root in ``tmp_path``): a warm build
    reads back the cold build's kernels and stencils to the bit, a float64
    planner never reads a float32 entry, a deformable robot (no stable
    key) writes no file, an entry written by other precompute code is
    never read, and two grid robots of one field at different origins or
    steps share no key.
"""

import glob
import hashlib
import json
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svsdf_tpu.models import shapes as jshapes
from svsdf_tpu.ops import minco as jminco
from svsdf_tpu.utils import cache as jcache
from svsdf_tpu.utils import checkpoint as jcheckpoint
from svsdf_tpu_torch.models import shapes
from svsdf_tpu_torch.utils import cache, checkpoint, profiling
from svsdf_tpu_torch.utils import trajectory as trj
from svsdf_tpu_torch.utils.fixtures import load_start_end

torch.set_num_threads(1)


def test_profile_stage_and_report():
    prof = profiling.Profile()
    with profiling.stage("work", profile=prof) as s:
        x = torch.ones((64, 64)) @ torch.ones((64, 64))
        s.block(x)
    with profiling.stage("work", profile=prof):
        pass
    assert prof.counts["work"] == 2
    assert prof.totals["work"] > 0
    assert "work" in prof.report()


def test_bench_fn_returns_stats():
    out = profiling.bench_fn(lambda x: (x @ x).sum(), torch.ones((32, 32)),
                             reps=3)
    assert out["median_s"] > 0 and out["min_s"] <= out["median_s"]


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiling.device_trace(str(tmp_path)) as prof:
        with profiling.stage("traced_stage", profile=profiling.Profile()):
            (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
    names = {e.key for e in prof.key_averages()}
    assert "traced_stage" in names
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        assert any(ev.get("name") == "traced_stage"
                   for ev in json.load(f)["traceEvents"])


def _jtraj():
    head = jnp.zeros((3, 3), jnp.float32)
    tail = jnp.zeros((3, 3), jnp.float32).at[0, 0].set(5.0)
    wps = jnp.asarray([[1.5, 0.1, 0.0], [3.5, -0.1, 0.1]], jnp.float32)
    return jminco.solve(jnp.full((3,), 1.5, jnp.float32), head, tail, wps)


def _traj():
    jt = _jtraj()
    return trj.Trajectory(torch.tensor(np.asarray(jt.coeffs))[None],
                          torch.tensor(np.asarray(jt.durations))[None])


def test_plan_checkpoint_roundtrip(tmp_path):
    traj = _traj()
    x = torch.arange(9, dtype=torch.float32)[None]
    p = checkpoint.save_plan(str(tmp_path / "plan.npz"), x, traj,
                             scenario="sdHeart", final_cost=42.0)
    ck = checkpoint.load_plan(p, device="cpu")
    assert torch.equal(ck.opt_x, x)
    assert torch.equal(ck.traj.coeffs, traj.coeffs)
    assert torch.equal(ck.traj.durations, traj.durations)
    assert ck.meta["scenario"] == "sdHeart"
    ts = torch.linspace(0, float(traj.total_duration[0]), 20)[None]
    assert torch.equal(trj.eval_at(ck.traj, ts), trj.eval_at(traj, ts))
    with pytest.raises(ValueError):
        checkpoint.save_plan(str(tmp_path / "two.npz"), x.repeat(2, 1))


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_plan_checkpoint_is_jaxs_both_ways(tmp_path):
    jt, traj = _jtraj(), _traj()
    x = np.linspace(-1, 1, 9).astype(np.float32)
    meta = dict(scenario="Circle", final_cost=47.62, certified=True)
    ours = checkpoint.save_plan(str(tmp_path / "port.npz"),
                                torch.as_tensor(x)[None], traj, **meta)
    theirs = jcheckpoint.save_plan(str(tmp_path / "jax.npz"), x, jt, **meta)
    assert _members(ours) == _members(theirs)
    jck = jcheckpoint.load_plan(ours)
    np.testing.assert_array_equal(jck.opt_x, x)
    np.testing.assert_array_equal(jck.traj.coeffs, np.asarray(jt.coeffs))
    assert jck.meta == meta
    ck = checkpoint.load_plan(theirs, device="cpu")
    assert torch.equal(ck.traj.coeffs, traj.coeffs) and ck.meta == meta


def test_batch_checkpoint_resume_mask(tmp_path):
    x = np.random.default_rng(0).normal(0, 1, (6, 10)).astype(np.float32)
    cost = np.arange(6.0)
    conv = np.asarray([True, False, True, False, False, True])
    p = checkpoint.save_batch(str(tmp_path / "b.npz"), torch.as_tensor(x),
                              torch.as_tensor(cost), torch.as_tensor(conv),
                              it=17, stage="mu=0.1")
    ck = checkpoint.load_batch(p, device="cpu")
    assert ck.it == 17
    assert ck.meta["stage"] == "mu=0.1"
    assert torch.equal(ck.x, torch.as_tensor(x))
    np.testing.assert_array_equal(ck.resume_mask.numpy(),
                                  [False, True, False, True, True, False])
    jp = jcheckpoint.save_batch(str(tmp_path / "j.npz"), x, cost, conv,
                                it=17, stage="mu=0.1")
    assert _members(p) == _members(jp)
    jck = jcheckpoint.load_batch(p)
    np.testing.assert_array_equal(jck.resume_mask, ck.resume_mask.numpy())


def test_start_end_fixture_roundtrip(tmp_path):
    p = checkpoint.save_start_end(str(tmp_path / "se.txt"),
                                  [1.0, 2.0, 0.5], [8.0, -1.0, 0.1])
    start, goal = load_start_end(p)
    np.testing.assert_allclose(start, [1.0, 2.0, 0.5])
    np.testing.assert_allclose(goal, [8.0, -1.0, 0.1])
    jp = jcheckpoint.save_start_end(str(tmp_path / "j.txt"),
                                    [1.0, 2.0, 0.5], [8.0, -1.0, 0.1])
    with open(p) as a, open(jp) as b:
        assert a.read() == b.read()


def test_memoize_npz_own_root(tmp_path, monkeypatch):
    """A miss computes and writes under the port's root; a hit reads it
    back; a corrupt entry recomputes; an entry of the JAX package's
    directory under the same key is never read."""
    monkeypatch.setenv("SVSDF_TORCH_CACHE_DIR", str(tmp_path / "port"))
    monkeypatch.setenv("SVSDF_CACHE_DIR", str(tmp_path / "jax"))
    assert cache.cache_dir() == str(tmp_path / "port")
    key = "unit-test-key"
    fname = hashlib.md5(key.encode()).hexdigest() + ".npz"
    (tmp_path / "jax").mkdir()
    np.savez_compressed(tmp_path / "jax" / fname, arr=np.asarray([9, 9]))
    calls = []

    def fn():
        calls.append(1)
        return np.arange(3)

    np.testing.assert_array_equal(cache.memoize_npz(key, fn), [0, 1, 2])
    np.testing.assert_array_equal(cache.memoize_npz(key, fn), [0, 1, 2])
    assert len(calls) == 1
    assert [f.name for f in (tmp_path / "port").glob("*.npz")] == [fname]
    (tmp_path / "port" / fname).write_bytes(b"not a zip")
    np.testing.assert_array_equal(cache.memoize_npz(key, fn), [0, 1, 2])
    assert len(calls) == 2


@pytest.mark.parametrize("name", ["sdHeart", "Circle", "sdRhombus", "bigX",
                                  "star"])
@pytest.mark.parametrize("pp", [(0.0, 0.0, 0.0), (0.3, -0.2, 25.0)])
def test_shape_cache_key_is_jaxs(name, pp):
    assert cache.shape_cache_key(shapes.make_shape(name, pp)) == \
        jcache.shape_cache_key(jshapes.make_shape(name, pp))


def test_shape_cache_key_mesh_and_polygon(tmp_path):
    from svsdf_tpu.models import mesh_sdf as jmesh
    from svsdf_tpu_torch.bench import write_prism_obj
    from svsdf_tpu_torch.models import mesh_sdf
    obj = write_prism_obj("sdHeart", str(tmp_path / "heart.obj"),
                          extent=6.0)
    key = cache.shape_cache_key(mesh_sdf.shape_from_mesh(obj))
    assert key == jcache.shape_cache_key(jmesh.shape_from_mesh(obj))
    assert key.startswith("mesh:heart:")
    rect = shapes.make_shape("Polygon")
    tri = shapes.make_shape("Polygon", vertices=[(1, 0), (0, 1), (-1, -1)])
    jkey = jcache.shape_cache_key(jshapes.make_shape("Polygon"))
    assert cache.shape_cache_key(rect).startswith(jkey + ":v")
    assert cache.shape_cache_key(rect) != cache.shape_cache_key(tri)
    scaled = shapes.make_scaled_shape("sdHeart", shapes.breathing_scale(
        0.25, 0.8), kernel_scale=1.25)
    assert cache.shape_cache_key(scaled) is None


def _planner(dtype=torch.float32, shape=None):
    from svsdf_tpu_torch.planner.pipeline import Planner
    from svsdf_tpu_torch.utils import fixtures
    sc = fixtures.synthetic_scenario("Circle")
    return Planner(sc.config, sc.map_points, device="cpu", dtype=dtype,
                   shape=shape)


def test_planner_warm_build_reads_the_cold_builds_kernels(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("SVSDF_TORCH_CACHE_DIR", str(tmp_path))
    cold = _planner()
    n_cold = len(list(tmp_path.glob("*.npz")))
    assert n_cold == 1                               # the yaw kernels
    cold_st = cold._stencils(cold.guard_ladder[0])
    assert len(list(tmp_path.glob("*.npz"))) == 2    # + the stencils
    from svsdf_tpu_torch.ops import kernels as kops
    with monkeypatch.context() as m:
        def boom(*a, **k):
            raise AssertionError("a warm build must not rasterize")
        m.setattr(kops, "rasterize_shape_kernels", boom)
        m.setattr(kops, "transition_stencils", boom)
        warm = _planner()
        warm_st = warm._stencils(warm.guard_ladder[0])
    assert torch.equal(warm._kernels, cold._kernels)
    assert warm._kernels.dtype == torch.bool
    assert torch.equal(warm_st, cold_st)
    np.testing.assert_array_equal(warm.feas, cold.feas)
    # float64: its own entries, never the float32 ones
    p64 = _planner(torch.float64)
    assert len(list(tmp_path.glob("*.npz"))) == 3
    assert torch.equal(p64._kernels, cold._kernels)


def test_planner_memo_keys_name_dtype_and_device(tmp_path, monkeypatch):
    monkeypatch.setenv("SVSDF_TORCH_CACHE_DIR", str(tmp_path))
    seen = []
    real = cache.memoize_npz
    monkeypatch.setattr(cache, "memoize_npz",
                        lambda key, fn: seen.append(key) or real(key, fn))
    _planner()
    _planner(torch.float64)
    assert seen[0].endswith("|torch.float32|cpu")
    assert seen[1].endswith("|torch.float64|cpu")
    assert seen[0].rsplit("|", 2)[0] == seen[1].rsplit("|", 2)[0]


def test_planner_memo_ignores_entries_of_other_code(tmp_path,
                                                   monkeypatch):
    """Entries planted under another ``code_digest`` (as an older
    ops/kernels.py would have written them) are never read: the build
    computes and writes its own. Under the old digest the planted entries
    are what a build reads, so they sit at the key the digest changes."""
    from svsdf_tpu_torch.ops import kernels as kops
    monkeypatch.setenv("SVSDF_TORCH_CACHE_DIR", str(tmp_path))
    fresh = _planner()
    fresh_st = fresh._stencils(fresh.guard_ladder[0])
    for f in tmp_path.glob("*.npz"):
        f.unlink()
    real_k, real_t = kops.rasterize_shape_kernels, kops.transition_stencils
    with monkeypatch.context() as m:
        m.setattr(cache, "code_digest", lambda: "older-code")
        m.setattr(kops, "rasterize_shape_kernels",
                  lambda *a, **k: ~real_k(*a, **k))
        m.setattr(kops, "transition_stencils",
                  lambda *a, **k: ~real_t(*a, **k))
        stale = _planner()
        stale._stencils(stale.guard_ladder[0])
    planted = set(tmp_path.glob("*.npz"))
    assert len(planted) == 2
    with monkeypatch.context() as m:
        m.setattr(cache, "code_digest", lambda: "older-code")
        again = _planner()
        assert torch.equal(again._kernels, ~fresh._kernels)
    p = _planner()
    assert torch.equal(p._kernels, fresh._kernels)
    assert torch.equal(p._stencils(p.guard_ladder[0]), fresh_st)
    assert len(set(tmp_path.glob("*.npz")) - planted) == 2


def test_memo_prefix_names_grid_geometry():
    """One field at another step or origin is another robot: the JAX
    string (the field's digest) is shared, the memo prefix is not."""
    from svsdf_tpu_torch.models import mesh_sdf
    vals = np.random.default_rng(0).normal(size=(9, 7)).astype(np.float32)
    grids = [mesh_sdf.GridSDF2D(vals, x0, -1.0, step, 9, 7)
             for x0, step in ((-1.0, 0.25), (-1.0, 0.5), (-2.0, 0.25))]
    robots = [mesh_sdf.mesh_shape("g", g) for g in grids]
    assert len({cache.shape_cache_key(r) for r in robots}) == 1
    assert len({cache.memo_prefix(r) for r in robots}) == 3
    assert cache.memo_prefix(shapes.make_shape("sdHeart")) == \
        f"{cache.shape_cache_key(shapes.make_shape('sdHeart'))}|" \
        f"{cache.code_digest()}"


def test_planner_deformable_robot_writes_no_file(tmp_path, monkeypatch):
    monkeypatch.setenv("SVSDF_TORCH_CACHE_DIR", str(tmp_path))
    scaled = shapes.make_scaled_shape("Circle", shapes.breathing_scale(
        0.2, 0.8), kernel_scale=1.2)
    p = _planner(shape=scaled)
    p._stencils(p.guard_ladder[0])
    assert list(tmp_path.iterdir()) == []
