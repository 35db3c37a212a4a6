"""Port parity: multi-process planning (svsdf_tpu_torch/parallel/multihost.py
and the sharded functions of parallel/batch.py) on the host.

  * tests/test_multihost.py's single-process cases: ``initialize`` is a
    no-op without arguments or torchrun's environment, the mesh layout,
    an indivisible mesh raising, ``process_slice``, the block/gather
    round trip and ``barrier`` passing through;
  * spawned gloo worlds (parallel/local_world.py, a free port from the OS,
    the whole job under a time limit after which every rank is killed) of
    2 ranks at (1, 2) and (2, 1) and of 4 ranks at (2, 2), each running
    tests/test_torch_cuda_multihost.py::sharded_job on
    tests/test_parallel.py's problem (float32):
      - ``sharded_value_and_grad`` against JAX's ``sharded_value_and_grad``
        on a mesh of the same shape over the 8 virtual devices, cost at
        rtol 2e-5 and gradient at rtol 1e-3, atol 1e-4
        (test_parallel.py:77-81), and against the port's single-process
        ``make_cost_fn`` at rtol 1e-6 (test_parallel.py:150-157);
      - ``sharded_plan_batch`` (15 iterations) against the port's
        ``plan_batch``: final costs at rtol 2e-3 (test_parallel.py:143-149);
        at (2, 1) every lane to the bit;
      - ``sharded_step`` lowering the mean cost;
      - ``sharded_plan_batch_e2e`` against ``plan_batch_e2e`` on the
        corridor, every field to the bit;
      - no all_reduce at all where the obs axis is 1 (the (2, 1) solve and
        every e2e run), one a cost evaluation, as many on every rank of an
        obs row, where it is 2.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svsdf_tpu.models import shapes as jshapes
from svsdf_tpu.ops.svsdf import SVSDFConfig as JSVSDFConfig
from svsdf_tpu.parallel import batch as jpb
from svsdf_tpu.utils.config import PlannerConfig as JPlannerConfig
from svsdf_tpu_torch.parallel import batch as pb
from svsdf_tpu_torch.parallel import local_world
from svsdf_tpu_torch.parallel import multihost as mh
from tests.test_torch_cuda_multihost import (ITERS, N, problem,
                                             single_process)

torch.set_num_threads(1)

WORLDS = [(1, 2), (2, 1), (2, 2)]
TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK")


def test_initialize_noop_single_process(monkeypatch):
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    assert mh.initialize() is False
    assert mh.initialize(backend="gloo") is False
    assert not torch.distributed.is_initialized()


def test_initialize_needs_the_whole_address(monkeypatch):
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError):
        mh.initialize(device="cpu")


def test_pod_mesh_layout_single_process():
    mesh = mh.pod_mesh(n_obs_shards=1, device="cpu")
    assert mesh.axis_names == ("scn", "obs")
    assert mesh.shape == {"scn": 1, "obs": 1}
    assert mesh.coords == (0, 0) and mesh.ranks.tolist() == [[0]]
    assert mesh.obs_group is None and mesh.device == torch.device("cpu")
    assert pb.make_mesh(1, 1, device="cpu").shape == mesh.shape


def test_pod_mesh_indivisible_raises():
    with pytest.raises(ValueError):
        mh.pod_mesh(n_obs_shards=3, device="cpu")
    with pytest.raises(ValueError):
        pb.make_mesh(2, 1, device="cpu")


def test_process_slice_math():
    slices = [mh.process_slice(32, process_index=i, process_count=4)
              for i in range(4)]
    idx = np.arange(32)
    parts = [idx[s] for s in slices]
    assert np.concatenate(parts).tolist() == idx.tolist()
    assert all(len(p) == 8 for p in parts)
    assert mh.process_slice(6) == slice(0, 6)
    with pytest.raises(ValueError):
        mh.process_slice(6, process_count=4)


def test_global_batch_array_and_fetch_roundtrip():
    mesh = mh.pod_mesh(n_obs_shards=1, device="cpu")
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    arr = mh.global_batch_array(x, mesh, ("scn",))
    assert isinstance(arr, torch.Tensor) and arr.device.type == "cpu"
    np.testing.assert_array_equal(mh.fetch_global(arr), x)
    blk = mh.global_batch_array(np.ones((4, 6, 2)), mesh, ("scn", "obs"))
    assert blk.shape == (4, 6, 2)


def test_barrier_noop():
    mh.barrier("unit")


def test_single_process_sharded_is_unsharded():
    """At mesh (1, 1) in one process the sharded functions are the
    unsharded ones, to the bit."""
    mesh = pb.make_mesh(1, 1, device="cpu")
    ref = single_process(1, 1, "cpu")
    from tests.test_torch_cuda_multihost import CFG, SVS
    from svsdf_tpu_torch.models import shapes
    shape = shapes.make_shape("Circle")
    head, tail, obs, x0 = problem(2, 4)
    f, g = pb.sharded_value_and_grad(shape, mesh, CFG, SVS, N)(
        x0, head, tail, obs)
    assert torch.equal(f, ref["f0"]) and torch.equal(g, ref["g0"])
    x, cost, _, _ = pb.sharded_plan_batch(shape, mesh, CFG, SVS, N, ITERS,
                                          4)(x0, head, tail, obs)
    assert torch.equal(cost, ref["cost"]) and torch.equal(x, ref["x"])


@pytest.fixture(scope="module")
def worlds():
    out = {}
    for mesh in WORLDS:
        ranks = local_world.run(mesh[0] * mesh[1],
                                "tests/test_torch_cuda_multihost.py:sharded_job",
                                dict(n_scn=mesh[0], n_obs=mesh[1]),
                                backend="gloo", device="cpu", timeout=400)
        out[mesh] = (ranks, single_process(*mesh, "cpu"))
    return out


@pytest.mark.parametrize("mesh", WORLDS, ids=lambda m: f"{m[0]}x{m[1]}")
def test_value_and_grad_matches_jax_and_unsharded(worlds, mesh):
    ranks, ref = worlds[mesh]
    n_scn, n_obs = mesh
    head, tail, obs, x0 = problem(2 * n_scn, 4 * n_obs)
    jmesh = jpb.make_mesh(n_scn, n_obs)
    jsvs = JSVSDFConfig(coarse_n=32, refine_rounds=1, refine_n=8,
                        use_inside=False, use_pallas=False)
    vg = jpb.sharded_value_and_grad(jshapes.make_shape("Circle"), jmesh,
                                    JPlannerConfig(), jsvs, N)
    jf, jg = vg(*(jnp.asarray(a) for a in (x0, head, tail, obs)))
    for r in ranks:                       # every rank gathers the batch
        np.testing.assert_allclose(r["f0"], np.asarray(jf), rtol=2e-5)
        np.testing.assert_allclose(r["g0"], np.asarray(jg), rtol=1e-3,
                                   atol=1e-4)
        np.testing.assert_allclose(r["f0"], ref["f0"].numpy(), rtol=1e-6)
        np.testing.assert_allclose(r["g0"], ref["g0"].numpy(), rtol=1e-3,
                                   atol=1e-4)
    if n_obs == 1:
        np.testing.assert_array_equal(ranks[0]["f0"], ref["f0"].numpy())
        np.testing.assert_array_equal(ranks[0]["g0"], ref["g0"].numpy())


@pytest.mark.parametrize("mesh", WORLDS, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_plan_batch_matches_plan_batch(worlds, mesh):
    ranks, ref = worlds[mesh]
    r0 = ranks[0]
    assert r0["cost"].shape == (2 * mesh[0],)
    np.testing.assert_allclose(r0["cost"], ref["cost"].numpy(), rtol=2e-3)
    if mesh[1] == 1:
        # scenarios split only: nothing is reassociated, every lane is the
        # single-process lane to the bit
        np.testing.assert_array_equal(r0["cost"], ref["cost"].numpy())
        np.testing.assert_array_equal(r0["x"], ref["x"].numpy())
        np.testing.assert_array_equal(r0["iters"], ref["iters"].numpy())
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["x"], r0["x"])


@pytest.mark.parametrize("mesh", WORLDS, ids=lambda m: f"{m[0]}x{m[1]}")
def test_all_reduce_calls(worlds, mesh):
    """No collective where the obs axis is 1; where it is 2, one
    all_reduce a cost evaluation, as many on every rank of the row."""
    ranks, _ = worlds[mesh]
    for r in ranks:
        assert r["e2e_all_reduce"] == 0
        if mesh[1] == 1:
            assert r["vg_all_reduce"] == 0 and r["solve_all_reduce"] == 0
        else:
            assert r["vg_all_reduce"] == 1
            assert r["solve_all_reduce"] > ITERS
    rows = {}
    for r in ranks:
        rows.setdefault(r["coords"][0], set()).add(r["solve_all_reduce"])
    assert all(len(v) == 1 for v in rows.values())


@pytest.mark.parametrize("mesh", WORLDS, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_step_lowers_cost(worlds, mesh):
    r0 = worlds[mesh][0][0]
    assert float(r0["step_c1"].mean()) < float(r0["step_c0"].mean())


@pytest.mark.parametrize("mesh", WORLDS, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_e2e_matches_plan_batch_e2e(worlds, mesh):
    ranks, ref = worlds[mesh]
    assert ranks[0]["e2e"]["front_ok"].all()
    for r in ranks:
        for k, v in ref["e2e"].items():
            np.testing.assert_array_equal(r["e2e"][k], v.numpy(), err_msg=k)


def test_job_time_limit_kills_every_rank():
    """A rank that never reaches the collective its peer waits in: the
    job fails at its time limit instead of hanging."""
    with pytest.raises(TimeoutError):
        local_world.run(2, "tests/test_torch_cuda_multihost.py:stalled_job",
                        {}, timeout=20)
