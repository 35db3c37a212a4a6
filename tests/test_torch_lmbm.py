"""Port parity: the limited-memory bundle method (utils/lmbm.py) and the
LMBM back end (planner/back_end.py, ``solver="lmbm"``).

  * tests/test_lmbm.py's nonsmooth objectives (a smooth quadratic, MAXQ,
    MXHILB, chained LQ, the l1 norm, a batch of MAXQ problems, the hinge
    miniature of the back-end cost), float64, against the JAX package's
    ``lmbm.minimize`` from the same start: equal iteration counts and
    iterates within 1e-9 (XLA's CPU compile and PyTorch sum in different
    orders, so not bit for bit; MXHILB over its first 25 iterations,
    after which its solve amplifies that rounding);
  * ``_simplex_qp3`` at its vertex and interior cases and on random
    Gram matrices, against JAX;
  * tests/test_back_end_solvers.py's corridor cases on the LMBM back end:
    the cost falls from the warm start (and matches the JAX package's
    solve, float64, at 1e-6), the two solvers land in one cost regime,
    and a colliding warm start is pushed off its obstacle.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svsdf_tpu.models import shapes as jshapes
from svsdf_tpu.ops.svsdf import SVSDFConfig as JSVSDFConfig
from svsdf_tpu.planner import back_end as jbe
from svsdf_tpu.utils import lmbm as jlmbm
from svsdf_tpu.utils.transforms import backward_t
from svsdf_tpu_torch import convert
from svsdf_tpu_torch.ops import minco
from svsdf_tpu_torch.ops.svsdf import SVSDFConfig, svsdf_query
from svsdf_tpu_torch.planner import back_end
from svsdf_tpu_torch.utils import lbfgs, lmbm
from svsdf_tpu_torch.utils.config import PlannerConfig
from svsdf_tpu_torch.utils.transforms import forward_t

torch.set_num_threads(1)

F64 = torch.float64


def _hilbert(n=10):
    i = np.arange(1, n + 1)
    return 1.0 / (i[:, None] + i[None, :] - 1.0)


_RNG = np.random.default_rng(1)
_A = _RNG.normal(0, 1, (6, 6))
_Q = _A @ _A.T / 6 + np.eye(6)
_C = _RNG.normal(0, 1, (4, 6))
_X0_HINGE = _RNG.normal(0, 2, (6,))

#: name -> (jax f(x), torch f(x (B, n)) -> (B,), x0, LMBMParams fields)
OBJECTIVES = {
    "quadratic": (
        lambda x: 0.5 * x @ jnp.diag(jnp.asarray([1.0, 4.0, 9.0, 16.0])) @ x,
        lambda x: 0.5 * (x * x * torch.tensor([1.0, 4.0, 9.0, 16.0],
                                              dtype=F64)).sum(-1),
        np.asarray([1.0, -2.0, 3.0, -4.0]), dict(max_iterations=200)),
    "maxq": (
        lambda x: jnp.max(x ** 2),
        lambda x: torch.amax(x ** 2, dim=-1),
        np.concatenate([np.arange(1.0, 6.0), -np.arange(6.0, 11.0)]),
        dict(max_iterations=400, eps=1e-8)),
    "mxhilb": (
        lambda x: jnp.max(jnp.abs(jnp.asarray(_hilbert()) @ x)),
        lambda x: torch.amax(torch.abs(x @ torch.as_tensor(_hilbert()).T),
                             dim=-1),
        np.ones(10), dict(max_iterations=400, eps=1e-10)),
    "chained_lq": (
        lambda x: jnp.sum(jnp.maximum(-x[:-1] - x[1:], -x[:-1] - x[1:]
                                      + (x[:-1] ** 2 + x[1:] ** 2 - 1.0))),
        lambda x: torch.sum(torch.maximum(
            -x[:, :-1] - x[:, 1:], -x[:, :-1] - x[:, 1:]
            + (x[:, :-1] ** 2 + x[:, 1:] ** 2 - 1.0)), dim=-1),
        np.full(6, -0.5), dict(max_iterations=500, eps=1e-10)),
    "l1": (
        lambda x: jnp.sum(jnp.abs(x)),
        lambda x: torch.sum(torch.abs(x), dim=-1),
        np.asarray([0.7, -1.3, 0.2]), dict(max_iterations=300, eps=1e-10)),
    "hinge_0.1": (
        lambda x: 0.5 * x @ jnp.asarray(_Q) @ x + 0.1 * jnp.sum(
            jnp.maximum(jnp.asarray(_C) @ x + 0.3, 0.0)),
        lambda x: 0.5 * ((x @ torch.as_tensor(_Q)) * x).sum(-1) + 0.1 * (
            torch.clamp_min(x @ torch.as_tensor(_C).T + 0.3, 0.0)).sum(-1),
        _X0_HINGE, dict(max_iterations=400)),
}


def _port_fun(f):
    return lbfgs.value_and_grad(f)


#: objectives whose whole solve amplifies the two packages' rounding:
#: compared over their first iterations. MXHILB's iterates agree to
#: 2e-15 through iteration 25 and part at 30 (2.8e-4); both solves then
#: reach the bound of tests/test_lmbm.py (5e-3), at different points
CHAOTIC = {"mxhilb": 25}


@pytest.mark.parametrize("name", list(OBJECTIVES))
def test_objective_matches_jax(name):
    jf, tf, x0, kw = OBJECTIVES[name]
    if name in CHAOTIC:
        kw = dict(kw, max_iterations=CHAOTIC[name])
    jres = jlmbm.minimize(jax.value_and_grad(jf), jnp.asarray(x0),
                          jlmbm.LMBMParams(**kw))
    res = lmbm.minimize(_port_fun(tf), torch.as_tensor(x0)[None],
                        lmbm.LMBMParams(**kw))
    assert int(res.n_iters[0]) == int(jres.n_iters)
    assert bool(res.converged[0]) == bool(jres.converged)
    np.testing.assert_allclose(res.x[0].numpy(), np.asarray(jres.x),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(float(res.f[0]), float(jres.f), rtol=1e-9,
                               atol=1e-12)


def test_objectives_reach_their_minima():
    """tests/test_lmbm.py's bounds, on the port's solve."""
    bounds = {"quadratic": 1e-6, "maxq": 1e-3, "mxhilb": 5e-3,
              "chained_lq": -5 * np.sqrt(2.0) + 2e-2, "l1": 5e-3}
    for name, bound in bounds.items():
        _, tf, x0, kw = OBJECTIVES[name]
        res = lmbm.minimize(_port_fun(tf), torch.as_tensor(x0)[None],
                            lmbm.LMBMParams(**kw))
        assert float(res.f[0]) < bound, name


def test_batch_lanes_follow_their_single_lane_iterates():
    """8 MAXQ problems in one batch: each lane equals its JAX vmapped
    lane (iterations and iterate), and stops on its own."""
    x0 = np.random.default_rng(0).normal(0, 2, (8, 5))
    params = dict(max_iterations=300)
    jres = jlmbm.minimize_batched(jax.value_and_grad(lambda x: jnp.max(
        x ** 2)), jnp.asarray(x0), jlmbm.LMBMParams(**params))
    res = lmbm.minimize_batched(_port_fun(lambda x: torch.amax(x ** 2, -1)),
                                torch.as_tensor(x0),
                                lmbm.LMBMParams(**params))
    np.testing.assert_array_equal(res.n_iters.numpy(),
                                  np.asarray(jres.n_iters))
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=1e-9,
                               atol=1e-9)
    assert float(res.f.max()) < 1e-2
    assert len(set(res.n_iters.tolist())) > 1


def test_simplex_qp3_matches_jax():
    lam = lmbm._simplex_qp3(torch.eye(3, dtype=F64)[None],
                            torch.zeros((1, 3), dtype=F64))
    np.testing.assert_allclose(lam[0].numpy(), np.ones(3) / 3, atol=1e-5)
    lam = lmbm._simplex_qp3(torch.eye(3, dtype=F64)[None],
                            torch.tensor([[0.0, 10.0, 10.0]], dtype=F64))
    np.testing.assert_allclose(lam[0].numpy(), [1.0, 0.0, 0.0], atol=1e-5)
    rng = np.random.default_rng(2)
    vs = rng.normal(0, 1, (16, 3, 4))
    G = vs @ vs.transpose(0, 2, 1)
    b = np.abs(rng.normal(0, 1, (16, 3))) * (rng.uniform(size=(16, 1)) < 0.7)
    lam = lmbm._simplex_qp3(torch.as_tensor(G), torch.as_tensor(b))
    want = jax.vmap(jlmbm._simplex_qp3)(jnp.asarray(G), jnp.asarray(b))
    np.testing.assert_allclose(lam.numpy(), np.asarray(want), atol=1e-9)
    np.testing.assert_allclose(lam.sum(1).numpy(), 1.0, atol=1e-12)


# -- the LMBM back end on tests/test_back_end_solvers.py's corridors ------

SVS = dict(coarse_n=48, refine_rounds=1, refine_n=8, use_inside=False)


def _problem(n=4, n_obs=12, seed=0):
    """tests/test_back_end_solvers.py::_problem."""
    rng = np.random.default_rng(seed)
    head = np.zeros((3, 3), np.float32)
    tail = np.zeros((3, 3), np.float32)
    tail[0] = [6.0, 0.5, 0.3]
    wps = np.stack([np.linspace(1.5, 4.5, n - 1),
                    rng.normal(0, 0.2, n - 1),
                    np.linspace(0, 0.2, n - 1)], -1).astype(np.float32)
    obs = rng.uniform([0, -2.5], [6, 2.5], (n_obs, 2)).astype(np.float32)
    x0 = np.concatenate([np.asarray(backward_t(jnp.full((n,), 1.4))),
                         wps.ravel()]).astype(np.float32)
    return head, tail, obs, x0


def _optimize(name, head, tail, obs, x0, svs, **kw):
    return back_end.optimize(convert.shape_from_spec(name), head[None],
                             tail[None], obs[None], x0[None],
                             PlannerConfig(), svs, device="cpu", **kw)


def test_lmbm_back_end_improves_cost_and_matches_jax():
    head, tail, obs, x0 = (a.astype(np.float64) for a in _problem())
    n = 4
    svs = SVSDFConfig(**SVS)
    prob, xt = convert.problem_from_numpy(head[None], tail[None], obs[None],
                                          x0[None], device="cpu", dtype=F64)
    cost0 = back_end.make_cost_fn(convert.shape_from_spec("Circle"), prob,
                                  PlannerConfig(), svs, n)(xt)
    # one stage of 12 iterations: the whole 3-stage ladder (40 + 40 + 20)
    # amplifies the packages' rounding past 1e-6 (95 against 100
    # iterations), as the L-BFGS solve does (ROADMAP C)
    kw = dict(max_iters=12, mu_schedule=(0.1,), solver="lmbm")
    res = _optimize("Circle", head, tail, obs, x0, svs, dtype=F64, **kw)
    assert float(res.cost[0]) < float(cost0[0])
    assert res.traj.coeffs.shape == (1, n, 6, 3)
    jres = jbe.optimize(jshapes.make_shape("Circle"), head, tail, obs, x0,
                        svs_cfg=JSVSDFConfig(**SVS, use_pallas=False), **kw)
    assert int(res.n_iters[0]) == int(jres.n_iters)
    np.testing.assert_allclose(float(res.cost[0]), float(jres.cost),
                               rtol=1e-6)
    np.testing.assert_allclose(res.opt_x[0].numpy(), np.asarray(jres.opt_x),
                               rtol=1e-5, atol=1e-5)


def test_solvers_reach_comparable_cost():
    """L-BFGS and LMBM land in one cost regime on the sdHeart corridor:
    neither barely moves."""
    head, tail, obs, x0 = _problem(n=5, n_obs=24, seed=3)
    svs = SVSDFConfig(**SVS)
    costs = {s: float(_optimize("sdHeart", head, tail, obs, x0, svs,
                                max_iters=80, solver=s).cost[0])
             for s in ("lbfgs", "lmbm")}
    lo = min(costs.values())
    assert lo > 0
    for c in costs.values():
        assert c < 1.6 * lo, costs


def test_lmbm_clears_obstacle_from_colliding_start():
    """A warm start threaded through an obstacle: the bundle method
    pushes the swept volume off it (GSIP inside the obstacle)."""
    n = 4
    head = np.zeros((3, 3), np.float32)
    tail = np.zeros((3, 3), np.float32)
    tail[0] = [6.0, 0.0, 0.0]
    wps = np.stack([np.linspace(1.5, 4.5, n - 1), np.zeros(n - 1),
                    np.zeros(n - 1)], -1).astype(np.float32)
    obs = np.asarray([[3.0, 0.25]], np.float32)
    x0 = np.concatenate([np.asarray(backward_t(jnp.full((n,), 1.4))),
                         wps.ravel()]).astype(np.float32)
    svs = dataclasses.replace(SVSDFConfig(**SVS), use_inside=True,
                              gsip_iters=4, gsip_coarse_n=32)
    shape = convert.shape_from_spec("Circle")
    obs_t = torch.as_tensor(obs)[None]

    def margin(traj):
        return float(svsdf_query(shape, traj, obs_t, SVSDFConfig(**SVS),
                                 with_inside=False).sdf.min())

    times = forward_t(torch.as_tensor(x0[:n])[None])
    traj0 = minco.solve(times, torch.as_tensor(head)[None],
                        torch.as_tensor(tail)[None],
                        torch.as_tensor(wps)[None])
    start = margin(traj0)
    res = _optimize("Circle", head, tail, obs, x0, svs, max_iters=100,
                    solver="lmbm")
    assert start < 0
    assert margin(res.traj) > start + 0.3
