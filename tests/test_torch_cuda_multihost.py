"""Sharded planning over a 2-rank gloo world on one card, against the same
calls in one process on the same card; and the rank job that the host
tests (tests/test_torch_multihost.py) run in their gloo worlds.

Tests marked ``cuda`` need an NVIDIA card and skip without one. This
file imports neither JAX nor the JAX package, so on a card whose
installation has no JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_multihost.py

Held on the card, both ranks on ``cuda:0`` (NCCL refuses two ranks on one
card, so the world is gloo, which all-reduces CUDA tensors):
  * (2, 1), scenarios split: every lane's cost and iterate of
    ``sharded_plan_batch`` equal to the single-process ``plan_batch`` to
    the bit, with no all_reduce called;
  * (1, 2), obstacles split: the first cost evaluation within 1e-6
    relative of ``make_cost_fn``'s and its gradient at rtol 1e-3, atol
    1e-4 (tests/test_parallel.py:77-81); the 15-iteration solve the same
    on both ranks, finite, with the same number of all_reduce calls on
    each rank, more than one an iteration. Its final costs are not held
    against the single process here: on an H100 the reassociated sum
    sent this problem's two-lane solve 5.9% away and moved a 256-lane
    median 8.2e-3 (a chaotic nonsmooth solve: on phase 4's problem one
    ulp of the input moves a median as far); chip_smoke.py phase 16 holds
    the median of phase 4's 512 lanes at tests/test_parallel.py's
    setting;
  * ``sharded_plan_batch_e2e`` at (2, 1): every lane of
    ``plan_batch_e2e`` to the bit (the corridor's paths are short: the
    card's ``torch.cumsum`` sums rows of 300 and more in another order
    at another row count), with no all_reduce called.
"""

import numpy as np
import pytest
import torch

from chip_smoke import CountAllReduce
from svsdf_tpu_torch.models import shapes
from svsdf_tpu_torch.ops.svsdf import SVSDFConfig
from svsdf_tpu_torch.parallel import batch as pb
from svsdf_tpu_torch.parallel import local_world
from svsdf_tpu_torch.parallel import multihost as mh
from svsdf_tpu_torch.planner import back_end
from svsdf_tpu_torch.utils.config import PlannerConfig
from svsdf_tpu_torch.utils.gridmap import GridMap
from svsdf_tpu_torch.utils.transforms import backward_t

torch.set_num_threads(1)

#: tests/test_parallel.py's problem: N pieces, its SVSDF settings
N = 4
SVS = SVSDFConfig(coarse_n=32, refine_rounds=1, refine_n=8,
                  use_inside=False)
CFG = PlannerConfig()
#: the sharded solve's settings (tests/test_parallel.py:143-157)
ITERS, LS = 15, 4
#: the end-to-end run: test_parallel.py's corridor, its SVSDF stage
E2E_SVS = SVSDFConfig(coarse_n=48, refine_rounds=1, refine_n=8,
                      use_inside=False)
E2E_N, E2E_OBS = 6, 16


def problem(batch, n_obs, seed=0):
    """tests/test_parallel.py::_problem, float32 numpy."""
    rng = np.random.default_rng(seed)
    head = np.zeros((batch, 3, 3), np.float32)
    tail = np.zeros((batch, 3, 3), np.float32)
    tail[:, 0, :2] = rng.uniform([4, -1], [6, 1], (batch, 2))
    frac = np.linspace(0, 1, N + 1)[1:-1]
    wps = tail[:, 0][:, None, :2] * frac[None, :, None]
    wps = np.concatenate([wps, np.zeros((batch, N - 1, 1), np.float32)], -1)
    obs = rng.uniform([0, -2], [6, 2], (batch, n_obs, 2)).astype(np.float32)
    tau = np.tile(backward_t(torch.full((N,), 1.4, dtype=torch.float64))
                  .numpy(), (batch, 1))
    x0 = np.concatenate([tau, wps.reshape(batch, -1)], 1).astype(np.float32)
    return head, tail, obs, x0


def corridor(device):
    """test_parallel.py::test_plan_batch_e2e_device_pipeline's map (a wall
    with a gap), its Circle robot and four start/goal cells."""
    from svsdf_tpu_torch.ops import kernels as kops
    pts = [(x + 0.5, 7.2, z + 0.5) for x in range(24) for z in range(2)
           if not 10 <= x <= 13]
    pts += [(0.05, 0.05, 0.05), (23.9, 15.9, 1.9)]
    grid = GridMap.from_points(np.asarray(pts), 1.0, 1)
    shape = shapes.make_shape("Circle")
    kern = kops.rasterize_shape_kernels(shape, 7, 4, 1.0, 0.5, device=device)
    feas = kops.feasibility_maps(grid.occ2d, kern, device=device)
    occ = grid.occupied_centers_2d()
    starts = np.asarray([[3, 3], [2, 5], [4, 2], [3, 4]])
    goals = np.asarray([[20, 12], [21, 11], [19, 13], [20, 13]])
    return shape, grid, feas, occ, starts, goals


def e2e_args(grid):
    return (CFG, ((E2E_SVS, 15, 2),), E2E_N, E2E_OBS, 1.0,
            grid.xyz_min[:2].astype(np.float32))


def sharded_job(n_scn, n_obs, device="cpu", e2e=True):
    """One rank's part of the sharded calls on tests/test_parallel.py's
    problem (2 scenarios a scn rank, 4 obstacles an obs rank):
    the first cost evaluation, the 15-iteration solve, two gradient steps
    and the end-to-end run, each gathered to numpy, with the all_reduce
    calls each made on this rank."""
    mesh = pb.make_mesh(n_scn, n_obs, device=device)
    shape = shapes.make_shape("Circle")
    head, tail, obs, x0 = problem(2 * n_scn, 4 * n_obs)
    out = {"coords": mesh.coords}
    with CountAllReduce() as c:
        f, g = pb.sharded_value_and_grad(shape, mesh, CFG, SVS, N)(
            x0, head, tail, obs)
    out["f0"], out["g0"] = mh.fetch_global(f, mesh), mh.fetch_global(g, mesh)
    out["vg_all_reduce"] = c.calls
    with CountAllReduce() as c:
        run = pb.sharded_plan_batch(shape, mesh, CFG, SVS, N, ITERS, LS)
        x, cost, iters, conv = run(x0, head, tail, obs)
    out["solve_all_reduce"] = c.calls
    for k, v in zip(("x", "cost", "iters", "conv"), (x, cost, iters, conv)):
        out[k] = mh.fetch_global(v, mesh)
    step = pb.sharded_step(shape, mesh, CFG, SVS, N, lr=1e-3)
    hs, ts, os_, xs = problem(2 * n_scn, 4 * n_obs, seed=1)
    x1, c0 = step(xs, hs, ts, os_)
    _, c1 = step(mh.fetch_global(x1, mesh), hs, ts, os_)
    out["step_c0"] = mh.fetch_global(c0, mesh)
    out["step_c1"] = mh.fetch_global(c1, mesh)
    if e2e:
        eshape, grid, feas, occ, starts, goals = corridor(mesh.device)
        with CountAllReduce() as c:
            res = pb.sharded_plan_batch_e2e(
                eshape, mesh, *e2e_args(grid))(feas, occ, starts, goals)
        out["e2e_all_reduce"] = c.calls
        out["e2e"] = {k: mh.fetch_global(v, mesh)
                      for k, v in res._asdict().items()}
    mh.barrier()
    return out


def stalled_job():
    """Rank 1 never reaches the all_reduce that rank 0 waits in."""
    import time
    if torch.distributed.get_rank() == 0:
        torch.distributed.all_reduce(torch.ones(1))
    else:
        time.sleep(120)


def single_process(n_scn, n_obs, device):
    """The same calls in this process: make_cost_fn's first evaluation,
    plan_batch's solve and plan_batch_e2e, on the whole batch."""
    from svsdf_tpu_torch import convert
    from svsdf_tpu_torch.utils import lbfgs
    shape = shapes.make_shape("Circle")
    head, tail, obs, x0 = problem(2 * n_scn, 4 * n_obs)
    prob, x = convert.problem_from_numpy(head, tail, obs, x0, device=device)
    f0, g0 = lbfgs.value_and_grad(
        back_end.make_cost_fn(shape, prob, CFG, SVS, N))(x)
    ref = pb.plan_batch(shape, x, prob, CFG, SVS, N, ITERS, LS,
                        device=device)
    eshape, grid, feas, occ, starts, goals = corridor(device)
    e2e = pb.plan_batch_e2e(eshape, feas, occ, starts, goals,
                            *e2e_args(grid), device=device)
    return {"f0": f0, "g0": g0, "x": ref.opt_x, "cost": ref.cost,
            "iters": ref.n_iters,
            "e2e": {k: v for k, v in e2e._asdict().items()}}


def _np(t):
    return t.detach().cpu().numpy()


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: two gloo ranks on one card")


@pytest.fixture(scope="module")
def card_worlds():
    _card()
    out = {}
    for mesh in ((2, 1), (1, 2)):
        ranks = local_world.run(mesh[0] * mesh[1],
                                "tests/test_torch_cuda_multihost.py:sharded_job",
                                dict(n_scn=mesh[0], n_obs=mesh[1],
                                     device="cuda", e2e=mesh == (2, 1)),
                                backend="gloo", device="cuda", timeout=600)
        out[mesh] = (ranks, single_process(*mesh, "cuda"))
    return out


@pytest.mark.cuda
def test_scenario_split_on_card_is_single_process_bits(card_worlds):
    ranks, ref = card_worlds[(2, 1)]
    r0 = ranks[0]
    assert r0["solve_all_reduce"] == 0 and r0["vg_all_reduce"] == 0
    np.testing.assert_array_equal(r0["cost"], _np(ref["cost"]))
    np.testing.assert_array_equal(r0["x"], _np(ref["x"]))
    np.testing.assert_array_equal(r0["iters"], _np(ref["iters"]))


@pytest.mark.cuda
def test_obstacle_split_on_card_matches_single_process(card_worlds):
    ranks, ref = card_worlds[(1, 2)]
    np.testing.assert_allclose(ranks[0]["f0"], _np(ref["f0"]), rtol=1e-6)
    np.testing.assert_allclose(ranks[0]["g0"], _np(ref["g0"]), rtol=1e-3,
                               atol=1e-4)
    assert np.isfinite(ranks[0]["cost"]).all()
    calls = [r["solve_all_reduce"] for r in ranks]
    assert calls[0] == calls[1] > ITERS
    # both ranks of the obs row hold the same solve
    np.testing.assert_array_equal(ranks[0]["x"], ranks[1]["x"])


@pytest.mark.cuda
def test_e2e_scenario_split_on_card_is_collective_free(card_worlds):
    ranks, ref = card_worlds[(2, 1)]
    assert all(r["e2e_all_reduce"] == 0 for r in ranks)
    for k, v in ref["e2e"].items():
        np.testing.assert_array_equal(ranks[0]["e2e"][k], _np(v), err_msg=k)
