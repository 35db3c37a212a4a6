"""Port parity: the batch-native L-BFGS (utils/lbfgs.py), float64.

One lane of the port's solver follows the JAX package's
``lbfgs.minimize`` iterate for iterate on the objectives of
tests/test_lbfgs.py, smooth and nonsmooth, with the sequential weak-Wolfe
and the parallel line search, the two-loop and the compact inverse-
Hessian apply, and on the ``frozen=`` path: x and f at 1e-8, the
iteration count and the convergence flag equal. A B=3 batch whose lanes
finish at different iterations matches the JAX solver lane by lane.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svsdf_tpu.utils import lbfgs as jlbfgs
from svsdf_tpu.utils.transforms import smoothed_l1 as jsmoothed_l1
from svsdf_tpu_torch.utils import lbfgs
from svsdf_tpu_torch.utils.transforms import smoothed_l1

torch.set_num_threads(1)

TOL = 1e-8

_RNG = np.random.default_rng(7)
_DIM = 17
_A17 = _RNG.normal(size=(_DIM, _DIM))
_A17 = _A17 @ _A17.T / _DIM + np.eye(_DIM)
_B17 = _RNG.normal(size=(_DIM,))
_X17 = _RNG.normal(size=(_DIM,))
_A2 = np.array([[3.0, 1.0], [1.0, 2.0]])
_B2 = np.array([1.0, -2.0])
_TARGETS = np.linspace(-2.0, 2.0, 8)


def _objectives():
    """name -> (jax f(x (n,)), torch f(x (R, n)) -> (R,), x0, params)."""
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    P = jlbfgs.LBFGSParams
    return {
        "quadratic": (
            lambda x: 0.5 * x @ jnp.asarray(_A2) @ x - jnp.asarray(_B2) @ x,
            lambda x: 0.5 * torch.einsum("ri,ij,rj->r", x, t(_A2), x)
            - x @ t(_B2),
            np.zeros(2), P(max_iterations=100)),
        "rosenbrock": (
            lambda x: (1 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2,
            lambda x: (1 - x[:, 0]) ** 2
            + 100.0 * (x[:, 1] - x[:, 0] ** 2) ** 2,
            np.array([-1.2, 1.0]),
            P(max_iterations=300, g_epsilon=1e-10, delta=0.0)),
        "nonsmooth_l1": (
            lambda x: (jnp.abs(x[0] - 3.0) + jnp.abs(x[1] + 1.0)
                       + 0.01 * jnp.sum(x * x)),
            lambda x: (torch.abs(x[:, 0] - 3.0) + torch.abs(x[:, 1] + 1.0)
                       + 0.01 * torch.sum(x * x, -1)),
            # from iteration 48 on the cost sits within rounding of its
            # minimum 0.1 and the two frameworks' last-bit differences
            # in f decide the delta=1e-14 stall test; 45 iterations end
            # before that, at x = (3, -1) to 1e-9
            np.array([10.0, 10.0]),
            P(max_iterations=45, g_epsilon=0.0, delta=1e-14)),
        "smoothed_hinge": (
            lambda x: (jnp.sum(jsmoothed_l1(jnp.asarray(_TARGETS) - x[0],
                                            1e-2)) + 0.05 * x[0] ** 2),
            lambda x: (torch.sum(smoothed_l1(t(_TARGETS) - x[:, :1], 1e-2),
                                 -1) + 0.05 * x[:, 0] ** 2),
            np.array([-5.0]), P(max_iterations=200)),
        "quad17_l1": (
            lambda x: (0.5 * x @ jnp.asarray(_A17) @ x
                       + jnp.asarray(_B17) @ x + jnp.sum(jnp.abs(x))),
            lambda x: (0.5 * torch.einsum("ri,ij,rj->r", x, t(_A17), x)
                       + x @ t(_B17) + torch.sum(torch.abs(x), -1)),
            _X17, P(mem_size=6, max_iterations=25, g_epsilon=0.0, delta=0.0,
                    max_linesearch=8)),
    }


def _port_params(p, **kw):
    fields = dict(mem_size=p.mem_size, max_iterations=p.max_iterations,
                  g_epsilon=p.g_epsilon, past=p.past, delta=p.delta,
                  max_linesearch=p.max_linesearch)
    fields.update(kw)
    return lbfgs.LBFGSParams(**fields)


def _check(res, jres, lane=0):
    np.testing.assert_allclose(res.x[lane].numpy(), np.asarray(jres.x),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(res.f[lane]), float(jres.f),
                               atol=TOL, rtol=TOL)
    assert int(res.n_iters[lane]) == int(jres.n_iters)
    assert bool(res.converged[lane]) == bool(jres.converged)


@pytest.mark.parametrize("compact", [False, True], ids=["two-loop",
                                                        "compact"])
@pytest.mark.parametrize("ls_candidates", [0, 4], ids=["wolfe",
                                                       "parallel"])
@pytest.mark.parametrize("name", list(_objectives()))
def test_single_lane_matches_jax(name, ls_candidates, compact):
    jf, tf, x0, jp = _objectives()[name]
    jp = dataclasses.replace(jp, ls_candidates=ls_candidates,
                             compact=compact)
    jres = jlbfgs.minimize(jax.value_and_grad(jf), jnp.asarray(x0), jp)
    res = lbfgs.minimize(lbfgs.value_and_grad(tf),
                         torch.as_tensor(x0)[None],
                         _port_params(jp, ls_candidates=ls_candidates,
                                      compact=compact))
    _check(res, jres)


_AF = np.array([3.0, 1.0, 0.5, 7.0, 2.0])
_BF = np.array([1.0, -2.0, 0.5, 3.0, -1.0])
_AB = np.array([5.0, 0.2, 1.0])


def _frozen_cases():
    """(jax full, jax frozen, torch full, torch frozen, x0, params):
    a surrogate that is the true model (state = the Hessian diagonal),
    and a mis-scaled surrogate of a nonsmooth cost."""
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    P = jlbfgs.LBFGSParams
    good = (
        lambda x: (jnp.sum(_AF * (x - _BF) ** 2), 2.0 * _AF * (x - _BF),
                   jnp.asarray(_AF)),
        lambda x, st: (jnp.sum(st * (x - _BF) ** 2), 2.0 * st * (x - _BF)),
        lambda x: (torch.sum(t(_AF) * (x - t(_BF)) ** 2, -1),
                   2.0 * t(_AF) * (x - t(_BF)),
                   t(_AF).expand(x.shape[0], -1)),
        lambda x, st: (torch.sum(st * (x - t(_BF)) ** 2, -1),
                       2.0 * st * (x - t(_BF))),
        np.zeros(5), P(max_iterations=60, g_epsilon=1e-8))
    bad = (
        lambda x: (jnp.sum(_AB * x ** 2) + jnp.sum(jnp.abs(x)),
                   2.0 * _AB * x + jnp.sign(x), jnp.zeros(())),
        lambda x, st: (3.0 * jnp.sum(_AB * x ** 2), 6.0 * _AB * x),
        lambda x: (torch.sum(t(_AB) * x ** 2, -1)
                   + torch.sum(torch.abs(x), -1),
                   2.0 * t(_AB) * x + torch.sign(x),
                   x.new_zeros(x.shape[0])),
        lambda x, st: (3.0 * torch.sum(t(_AB) * x ** 2, -1),
                       6.0 * t(_AB) * x),
        np.array([2.0, -3.0, 1.5]),
        P(max_iterations=80, g_epsilon=1e-9, delta=0.0))
    return {"exact-surrogate": good, "mis-scaled-surrogate": bad}


@pytest.mark.parametrize("ls_candidates", [0, 4], ids=["wolfe",
                                                       "parallel"])
@pytest.mark.parametrize("name", list(_frozen_cases()))
def test_frozen_path_matches_jax(name, ls_candidates):
    jfull, jfrozen, tfull, tfrozen, x0, jp = _frozen_cases()[name]
    jp = dataclasses.replace(jp, ls_candidates=ls_candidates)
    jres = jlbfgs.minimize(jfull, jnp.asarray(x0), jp, frozen=jfrozen)
    res = lbfgs.minimize(tfull, torch.as_tensor(x0)[None],
                         _port_params(jp, ls_candidates=ls_candidates),
                         frozen=tfrozen)
    _check(res, jres)


@pytest.mark.parametrize("ls_candidates", [0, 4], ids=["wolfe",
                                                       "parallel"])
def test_batch_lanes_finish_apart_and_match_jax(ls_candidates):
    jf, tf, _, jp = _objectives()["rosenbrock"]
    jp = dataclasses.replace(jp, ls_candidates=ls_candidates,
                             g_epsilon=1e-6, max_iterations=150)
    x0 = np.array([[-1.2, 1.0], [1.0, 1.0 + 1e-3], [0.3, -0.4]])
    res = lbfgs.minimize(lbfgs.value_and_grad(tf), torch.as_tensor(x0),
                         _port_params(jp, ls_candidates=ls_candidates))
    iters = []
    for lane in range(3):
        jres = jlbfgs.minimize(jax.value_and_grad(jf), jnp.asarray(x0[lane]),
                               jp)
        _check(res, jres, lane)
        iters.append(int(jres.n_iters))
    assert len(set(iters)) == 3


def _scheduled_cases():
    """name -> (jax f(x, stage), torch f(x (R, n), stage (R,)), x0,
    params, n_iters, stage_bounds): continuation objectives whose
    smoothing or weight changes at the stage bounds."""
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    P = jlbfgs.LBFGSParams
    mus = np.array([0.5, 0.1, 0.01])
    ws = np.array([0.1, 0.01])
    return {
        "hinge_mu_ladder": (
            lambda x, s: (jnp.sum(jsmoothed_l1(jnp.asarray(_TARGETS) - x[0],
                                               jnp.asarray(mus)[s]))
                          + 0.05 * x[0] ** 2),
            lambda x, s: (torch.sum(smoothed_l1(t(_TARGETS) - x[:, :1],
                                                t(mus)[s][:, None]), -1)
                          + 0.05 * x[:, 0] ** 2),
            np.array([-5.0]), P(max_iterations=200), 150, (40, 80)),
        "nonsmooth_l1_weights": (
            lambda x, s: (jnp.abs(x[0] - 3.0) + jnp.abs(x[1] + 1.0)
                          + jnp.asarray(ws)[s] * jnp.sum(x * x)),
            lambda x, s: (torch.abs(x[:, 0] - 3.0) + torch.abs(x[:, 1] + 1.0)
                          + t(ws)[s] * torch.sum(x * x, -1)),
            np.array([10.0, 10.0]),
            P(max_iterations=60, g_epsilon=0.0, delta=1e-6), 45, (12,)),
        "quad17_l1_scaled": (
            lambda x, s: (0.5 * x @ jnp.asarray(_A17) @ x
                          + jnp.asarray(_B17) @ x
                          + (1.0 + s) * jnp.sum(jnp.abs(x))),
            lambda x, s: (0.5 * torch.einsum("ri,ij,rj->r", x, t(_A17), x)
                          + x @ t(_B17)
                          + (1.0 + s) * torch.sum(torch.abs(x), -1)),
            _X17, P(mem_size=6, max_iterations=40, g_epsilon=0.0,
                    delta=1e-3, max_linesearch=8), 30, (8, 16)),
    }


def _jax_scheduled(jf, bounds):
    b = jnp.asarray(bounds)
    return jax.value_and_grad(lambda x, it: jf(x, jnp.sum(it >= b)))


def _torch_scheduled(tf, bounds):
    b = torch.as_tensor(bounds)

    def fun(x, it):
        stage = torch.sum(it[:, None] >= b[None], dim=1)
        return lbfgs.value_and_grad(lambda xx: tf(xx, stage))(x)
    return fun


@pytest.mark.parametrize("name", list(_scheduled_cases()))
def test_minimize_scheduled_matches_jax(name):
    """Stage bounds (a lane converging early jumps to the next bound),
    the iteration budget and the objective's view of the counter, one
    lane at a time, then three lanes at once."""
    jf, tf, x0, jp, n_iters, bounds = _scheduled_cases()[name]
    jres = jlbfgs.minimize_scheduled(_jax_scheduled(jf, bounds),
                                     jnp.asarray(x0), jp, n_iters=n_iters,
                                     stage_bounds=jnp.asarray(bounds))
    res = lbfgs.minimize_scheduled(_torch_scheduled(tf, bounds),
                                   torch.as_tensor(x0)[None],
                                   _port_params(jp), n_iters=n_iters,
                                   stage_bounds=bounds)
    _check(res, jres)
    assert int(res.n_iters[0]) <= n_iters
    rng = np.random.default_rng(1)
    xb = x0[None] + rng.normal(0, 1.0, (3,) + x0.shape)
    res = lbfgs.minimize_scheduled(_torch_scheduled(tf, bounds),
                                   torch.as_tensor(xb), _port_params(jp),
                                   n_iters=n_iters, stage_bounds=bounds)
    for lane in range(3):
        _check(res, jlbfgs.minimize_scheduled(
            _jax_scheduled(jf, bounds), jnp.asarray(xb[lane]), jp,
            n_iters=n_iters, stage_bounds=jnp.asarray(bounds)), lane)


def test_minimize_scheduled_jumps_stages_and_minimize_is_its_case():
    """A lane that converges inside a stage jumps to the next bound, so
    its counter passes the bound with fewer iterations run; without
    bounds and budget the scheduled solver is ``minimize``."""
    _, tf, x0, jp, n_iters, bounds = _scheduled_cases()["hinge_mu_ladder"]
    seen = []

    def fun(x, it):
        seen.append(int(it[0]))
        return _torch_scheduled(tf, bounds)(x, it)

    res = lbfgs.minimize_scheduled(fun, torch.as_tensor(x0)[None],
                                   _port_params(jp), n_iters=n_iters,
                                   stage_bounds=bounds)
    assert 40 in seen and 80 in seen
    assert len(set(seen)) < int(res.n_iters[0])     # counters skipped
    plain = lambda x: tf(x, torch.zeros(x.shape[0], dtype=torch.long))
    a = lbfgs.minimize(lbfgs.value_and_grad(plain),
                       torch.as_tensor(x0)[None], _port_params(jp))
    b = lbfgs.minimize_scheduled(lambda x, it: lbfgs.value_and_grad(plain)(x),
                                 torch.as_tensor(x0)[None], _port_params(jp))
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_live_solve_reports_to_the_bus_and_stops():
    from svsdf_tpu_torch.utils.debugbus import BUS

    _, tf, x0, jp, _, _ = _scheduled_cases()["quad17_l1_scaled"]
    fun = lambda x, it: lbfgs.value_and_grad(
        lambda xx: tf(xx, torch.zeros_like(it)))(x)
    params = _port_params(jp, live=True)
    BUS.clear()
    res = lbfgs.minimize_scheduled(fun, torch.as_tensor(x0)[None], params)
    steps = [s for (_, s, _) in BUS.series["opti_cost"]]
    assert steps == list(range(int(res.n_iters[0])))
    assert len(BUS.series["opti_gnorm"]) == len(steps)
    BUS.request_stop()
    try:
        res = lbfgs.minimize_scheduled(fun, torch.as_tensor(x0)[None],
                                       params)
    finally:
        BUS.clear_stop()
        BUS.clear()
    assert int(res.n_iters[0]) == 1
    with pytest.raises(ValueError):
        lbfgs.minimize_scheduled(fun, torch.as_tensor(x0)[None].repeat(2, 1),
                                 params)
