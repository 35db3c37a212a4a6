"""Port parity: MINCO solve, CR solve, energy and trajectory evaluation.

B=3 lanes go through the port's batched functions; each lane through
the JAX function (float64 throughout).
  * ``minco.solve`` coefficients at rtol 1e-8 for n in {1, 2, 5, 8};
  * ``banded_solve_cr`` gradients (autograd.Function) against
    ``jax.vjp`` of the JAX ``banded_solve_cr`` at rtol 1e-7;
  * ``energy``, ``eval_at`` and ``state_se2`` values and gradients
    with respect to coefficients and durations at 1e-10.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svsdf_tpu.ops import block_cr as jcr
from svsdf_tpu.ops import minco as jminco
from svsdf_tpu.utils import trajectory as jtrj
from svsdf_tpu_torch import convert
from svsdf_tpu_torch.ops import block_cr, minco
from svsdf_tpu_torch.utils import trajectory as trj

torch.set_num_threads(1)

B = 3


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    times = rng.uniform(0.6, 2.0, (B, n))
    head = np.zeros((B, 3, 3))
    head[:, 0] = rng.uniform(-1, 1, (B, 3))
    head[:, 1] = rng.uniform(-0.5, 0.5, (B, 3))
    tail = np.zeros((B, 3, 3))
    tail[:, 0] = rng.uniform(5, 9, (B, 3))
    wps = rng.uniform(0, 8, (B, n - 1, 3))
    return times, head, tail, wps


def _t(a):
    return torch.as_tensor(a, dtype=torch.float64)


@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_solve_matches_jax(n):
    times, head, tail, wps = _inputs(n, seed=n)
    traj = minco.solve(_t(times), _t(head), _t(tail), _t(wps))
    for b in range(B):
        jt = jminco.solve(jnp.asarray(times[b]), jnp.asarray(head[b]),
                          jnp.asarray(tail[b]), jnp.asarray(wps[b]))
        np.testing.assert_allclose(traj.coeffs[b].numpy(),
                                   np.asarray(jt.coeffs), rtol=1e-8,
                                   atol=1e-10)
    dense = minco.solve_dense(_t(times), _t(head), _t(tail), _t(wps))
    np.testing.assert_allclose(traj.coeffs.numpy(), dense.coeffs.numpy(),
                               rtol=1e-8, atol=1e-8)


def test_banded_solve_cr_vjp_matches_jax():
    n = 5
    times, head, tail, wps = _inputs(n, seed=11)
    bands, rhs = minco.build_bands_norm(_t(times), _t(head), _t(tail),
                                        _t(wps))
    rng = np.random.default_rng(5)
    x_bar = rng.normal(size=rhs.shape)
    bt = bands.clone().requires_grad_(True)
    rt = rhs.clone().requires_grad_(True)
    x = block_cr.banded_solve_cr(bt, rt)
    gb, gr = torch.autograd.grad(x, (bt, rt), _t(x_bar))
    for b in range(B):
        xj, vjp = jax.vjp(jcr.banded_solve_cr, jnp.asarray(bands[b].numpy()),
                          jnp.asarray(rhs[b].numpy()))
        jgb, jgr = vjp(jnp.asarray(x_bar[b]))
        np.testing.assert_allclose(x[b].detach().numpy(), np.asarray(xj),
                                   rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(gb[b].numpy(), np.asarray(jgb),
                                   rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(gr[b].numpy(), np.asarray(jgr),
                                   rtol=1e-7, atol=1e-9)


def _traj_pair(seed, n=4):
    rng = np.random.default_rng(seed)
    coeffs = rng.normal(size=(B, n, 6, 3))
    durs = rng.uniform(0.5, 1.5, (B, n))
    return coeffs, durs


def _jax_fn_grads(f, coeffs, durs):
    return jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(coeffs),
                                                  jnp.asarray(durs))


def _torch_fn_grads(f, coeffs, durs):
    c = _t(coeffs).requires_grad_(True)
    d = _t(durs).requires_grad_(True)
    v = f(trj.Trajectory(c, d))
    gc, gd = torch.autograd.grad(v.sum(), (c, d))
    return v.detach(), gc, gd


def _check(tv, tgc, tgd, jout, b):
    jv, (jgc, jgd) = jout
    np.testing.assert_allclose(tv[b].numpy(), np.asarray(jv), atol=1e-10)
    np.testing.assert_allclose(tgc[b].numpy(), np.asarray(jgc), atol=1e-10)
    np.testing.assert_allclose(tgd[b].numpy(), np.asarray(jgd), atol=1e-10)


def test_energy_value_and_grads_match_jax():
    coeffs, durs = _traj_pair(1)
    tv, tgc, tgd = _torch_fn_grads(minco.energy, coeffs, durs)
    for b in range(B):
        jout = _jax_fn_grads(
            lambda c, d: jminco.energy(jtrj.Trajectory(c, d)),
            coeffs[b], durs[b])
        _check(tv, tgc, tgd, jout, b)


@pytest.mark.parametrize("order", [0, 1, 2])
def test_eval_at_value_and_grads_match_jax(order):
    coeffs, durs = _traj_pair(2 + order)
    rng = np.random.default_rng(7)
    total = durs.sum(1)
    # interior times, exact piece boundaries, both ends, and off-range
    ts = np.concatenate([rng.uniform(0, 1, (B, 9)) * total[:, None],
                         np.cumsum(durs, 1)[:, :2], np.zeros((B, 1)),
                         total[:, None], total[:, None] + 0.3,
                         -0.2 * np.ones((B, 1))], axis=1)
    w = rng.normal(size=(ts.shape[1], 3))
    tsq = _t(ts)
    tv, tgc, tgd = _torch_fn_grads(
        lambda tr: (trj.eval_at(tr, tsq, order) * _t(w)).sum((-1, -2)),
        coeffs, durs)
    tg, _, _ = _torch_fn_grads(
        lambda tr: (trj.eval_at_gather(tr, tsq, order)
                    * _t(w)).sum((-1, -2)), coeffs, durs)
    torch.testing.assert_close(tg, tv, rtol=0, atol=1e-10)
    for b in range(B):
        jout = _jax_fn_grads(
            lambda c, d: jnp.sum(jtrj.eval_at(jtrj.Trajectory(c, d),
                                              jnp.asarray(ts[b]), order)
                                 * jnp.asarray(w)), coeffs[b], durs[b])
        _check(tv, tgc, tgd, jout, b)


def test_state_se2_and_world_to_body_match_jax():
    coeffs, durs = _traj_pair(9)
    rng = np.random.default_rng(3)
    ts = rng.uniform(0, 1, (B, 7)) * durs.sum(1)[:, None]
    pw = rng.uniform(-3, 3, (B, 7, 2))

    def tfn(tr):
        xy, yaw, R = trj.state_se2(tr, _t(ts))
        pr = trj.world_to_body(xy, R, _t(pw))
        return pr.sum((-1, -2)) + (yaw * yaw).sum(-1)

    tv, tgc, tgd = _torch_fn_grads(tfn, coeffs, durs)
    for b in range(B):
        def jfn(c, d):
            xy, yaw, R = jtrj.state_se2(jtrj.Trajectory(c, d),
                                        jnp.asarray(ts[b]))
            pr = jtrj.world_to_body(xy, R, jnp.asarray(pw[b]))
            return jnp.sum(pr) + jnp.sum(yaw * yaw)
        _check(tv, tgc, tgd, _jax_fn_grads(jfn, coeffs[b], durs[b]), b)


def test_trajectory_from_numpy_adds_plan_axis():
    coeffs, durs = _traj_pair(4)
    one = convert.trajectory_from_numpy(coeffs[0], durs[0], device="cpu",
                                        dtype=torch.float64)
    assert one.coeffs.shape == (1,) + coeffs.shape[1:]
    assert one.durations.shape == (1, durs.shape[1])
