"""Port parity: the small leftovers of the MINCO and map modules against the
JAX package, float64 throughout, on seeded numpy inputs.

  * ``ops/banded.py``: ``banded_solve`` (the sequential banded LU, an
    ``autograd.Function`` whose backward is the adjoint solve) against
    ``jnp.linalg.solve`` at 1e-10 and JAX's ``banded_solve`` at 1e-12, its
    gradients against the dense solve's at 1e-8 and JAX's custom VJP at
    1e-10 (tests/test_banded.py's cases, each lane of a batch);
    ``dense_to_bands`` to the bit;
  * ``ops/minco.py``: ``build_bands`` at 1e-14 relative, ``solve_raw``
    (the block-CR route) against JAX's at rtol 1e-8 and against the
    port's own ``banded_solve`` route at rtol 1e-8, ``solve_s`` for
    s in {2, 3, 4} at rtol 1e-8 and ``energy_s`` at rtol 1e-10;
  * ``ops/esdf.py::interp_sdf`` and the ``GridMap`` methods
    ``generate_esdf``, ``sdf_value`` and ``sdf_value_with_grad`` on the
    cases of tests/test_env_frontend.py, values at 1e-12 and gradients at
    1e-10 (the port takes autograd where JAX takes ``jax.grad``);
  * ``ops/svsdf.py::sdf_at_time`` for a rigid and a deformable robot at
    1e-12.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svsdf_tpu.models import shapes as jshapes
from svsdf_tpu.ops import banded as jbanded
from svsdf_tpu.ops import esdf as jesdf
from svsdf_tpu.ops import minco as jminco
from svsdf_tpu.ops import svsdf as jsvsdf
from svsdf_tpu.utils.gridmap import GridMap as JGridMap
from svsdf_tpu_torch import convert
from svsdf_tpu_torch.models import shapes
from svsdf_tpu_torch.ops import banded, esdf, minco, svsdf
from svsdf_tpu_torch.utils.gridmap import GridMap

torch.set_num_threads(1)

F64 = torch.float64


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _rand_banded(n, seed):
    """tests/test_banded.py::_rand_banded: diagonally dominant, no
    pivoting needed."""
    rng = np.random.default_rng(seed)
    m = np.zeros((n, n))
    for i in range(n):
        lo, hi = max(0, i - banded.LBW), min(n, i + banded.UBW + 1)
        m[i, lo:hi] = rng.uniform(-1, 1, hi - lo)
    return m + np.eye(n) * (banded.LBW + 2)


def test_dense_to_bands_matches_jax():
    ms = np.stack([_rand_banded(17, s) for s in (0, 1)])
    got = banded.dense_to_bands(_t(ms))
    for b in range(2):
        np.testing.assert_array_equal(
            got[b].numpy(), np.asarray(jbanded.dense_to_bands(
                jnp.asarray(ms[b]))))


@pytest.mark.parametrize("n, d", [(30, 3), (7, 1)])
def test_solve_matches_dense_and_jax(n, d):
    ms = np.stack([_rand_banded(n, s) for s in (0, 4)])
    rhs = np.random.default_rng(1).normal(size=(2, n, d))
    x = banded.banded_solve(banded.dense_to_bands(_t(ms)), _t(rhs))
    for b in range(2):
        np.testing.assert_allclose(x[b].numpy(),
                                   np.linalg.solve(ms[b], rhs[b]),
                                   atol=1e-10)
        jx = jbanded.banded_solve(jbanded.dense_to_bands(jnp.asarray(ms[b])),
                                  jnp.asarray(rhs[b]))
        np.testing.assert_allclose(x[b].numpy(), np.asarray(jx), atol=1e-12)


def test_grad_matches_dense_and_jax():
    n, d = 18, 2
    ms = np.stack([_rand_banded(n, s) for s in (3, 5)])
    rhs0 = np.random.default_rng(2).normal(size=(2, n, d))
    bands0 = banded.dense_to_bands(_t(ms))
    bands = bands0.clone().requires_grad_(True)
    rhs = _t(rhs0).requires_grad_(True)
    torch.sin(banded.banded_solve(bands, rhs)).sum().backward()
    valid = banded._band_index(n, "cpu")[0].numpy()
    # the dense oracle: the same parameterization through the band
    bd = bands0.clone().requires_grad_(True)
    rd = _t(rhs0).requires_grad_(True)
    i = torch.arange(n)[:, None].expand(n, banded.NDIAG)
    j = i + torch.arange(banded.NDIAG)[None] - banded.LBW
    v = torch.as_tensor(valid)
    lane = torch.arange(2)[:, None]
    dense = torch.zeros((2, n, n), dtype=F64).index_put(
        (lane, i[v][None], j[v][None]), bd[:, v])
    torch.sin(torch.linalg.solve(dense, rd)).sum().backward()
    np.testing.assert_allclose(bands.grad.numpy()[:, valid],
                               bd.grad.numpy()[:, valid], atol=1e-8)
    np.testing.assert_allclose(rhs.grad.numpy(), rd.grad.numpy(), atol=1e-8)
    # invalid band slots get no gradient
    assert not bands.grad.numpy()[:, ~valid].any()
    for b in range(2):
        gb, gr = jax.grad(lambda bb, rr: jnp.sum(jnp.sin(
            jbanded.banded_solve(bb, rr))), argnums=(0, 1))(
                jbanded.dense_to_bands(jnp.asarray(ms[b])),
                jnp.asarray(rhs0[b]))
        np.testing.assert_allclose(bands.grad[b].numpy()[valid],
                                   np.asarray(gb)[valid], atol=1e-10)
        np.testing.assert_allclose(rhs.grad[b].numpy(), np.asarray(gr),
                                   atol=1e-10)


def _minco_batch(b, n, seed):
    rng = np.random.default_rng(seed)
    times = rng.uniform(0.5, 2.5, (b, n))
    head = rng.normal(size=(b, 3, 3))
    tail = rng.normal(size=(b, 3, 3))
    tail[:, 0] += rng.uniform(3, 8, (b, 3))
    wps = rng.uniform(-2, 8, (b, n - 1, 3))
    return times, head, tail, wps


def _jax_lane(a, b):
    return [jnp.asarray(x[b]) for x in a]


def test_build_bands_matches_jax():
    args = _minco_batch(3, 5, seed=11)
    bands, rhs = minco.build_bands(*map(_t, args))
    for b in range(3):
        jb, jr = jminco.build_bands(*_jax_lane(args, b))
        np.testing.assert_allclose(bands[b].numpy(), np.asarray(jb),
                                   rtol=1e-14, atol=0)
        np.testing.assert_array_equal(rhs[b].numpy(), np.asarray(jr))


@pytest.mark.parametrize("n", [1, 4, 9])
def test_solve_raw_matches_jax_and_banded_route(n):
    """solve_raw takes the CR route (JAX's SOLVER = "cr"); the sequential
    banded LU is the other route on the same bands."""
    args = _minco_batch(4, n, seed=20 + n)
    traj = minco.solve_raw(*map(_t, args))
    assert traj.coeffs.shape == (4, n, 6, 3)
    bands, rhs = minco.build_bands(*map(_t, args))
    lu = banded.banded_solve(bands, rhs).reshape(4, n, 6, 3)
    scale = 1.0 + float(lu.abs().max())
    np.testing.assert_allclose(traj.coeffs.numpy() / scale,
                               lu.numpy() / scale, rtol=0, atol=1e-8)
    for b in range(4):
        jt = jminco.solve_raw(*_jax_lane(args, b))
        np.testing.assert_allclose(traj.coeffs[b].numpy(),
                                   np.asarray(jt.coeffs), rtol=1e-8,
                                   atol=1e-8 * scale)
    # the raw and normalized assemblies give the same spline
    norm = minco.solve(*map(_t, args))
    np.testing.assert_allclose(traj.coeffs.numpy(), norm.coeffs.numpy(),
                               rtol=1e-6, atol=1e-6 * scale)


def test_banded_solve_grad_through_minco_matches_jax():
    """tests/test_banded.py::test_cr_grad_matches_scan's case: d/dT of a
    loss through build_bands and the banded LU."""
    args = _minco_batch(2, 6, seed=7)
    times = _t(args[0]).requires_grad_(True)
    bands, rhs = minco.build_bands(times, *map(_t, args[1:]))
    torch.sin(banded.banded_solve(bands, rhs)).sum().backward()
    for b in range(2):
        h, tl, w = (jnp.asarray(a[b]) for a in args[1:])

        def loss(t):
            bb, rr = jminco.build_bands(t, h, tl, w)
            return jnp.sum(jnp.sin(jbanded.banded_solve(bb, rr)))

        np.testing.assert_allclose(times.grad[b].numpy(),
                                   np.asarray(jax.grad(loss)(
                                       jnp.asarray(args[0][b]))),
                                   rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("s", [2, 3, 4])
def test_solve_s_and_energy_s_match_jax(s):
    rng = np.random.default_rng(30 + s)
    b, n = 3, 4
    times = rng.uniform(0.8, 2.5, (b, n))
    head = rng.normal(0, 1, (b, s, 3))
    tail = rng.normal(0, 1, (b, s, 3))
    tail[:, 0] += 5.0
    wps = rng.normal(0, 2, (b, n - 1, 3))
    traj = minco.solve_s(s, _t(times), _t(head), _t(tail), _t(wps))
    assert traj.coeffs.shape == (b, n, 2 * s, 3)
    e = minco.energy_s(traj, s)
    assert e.shape == (b,)
    for i in range(b):
        jt = jminco.solve_s(s, jnp.asarray(times[i]), jnp.asarray(head[i]),
                            jnp.asarray(tail[i]), jnp.asarray(wps[i]))
        np.testing.assert_allclose(traj.coeffs[i].numpy(),
                                   np.asarray(jt.coeffs), rtol=1e-8,
                                   atol=1e-10)
        np.testing.assert_allclose(float(e[i]),
                                   float(jminco.energy_s(jt, s)), rtol=1e-10)
    if s == 3:
        # the general family at s = 3 is the quintic solve and its energy
        q = minco.solve(_t(times), _t(head), _t(tail), _t(wps))
        np.testing.assert_allclose(traj.coeffs.numpy(), q.coeffs.numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(e.numpy(), minco.energy(q).numpy(),
                                   rtol=1e-8)


def test_interp_sdf_matches_jax():
    """tests/test_env_frontend.py::test_esdf_interp's case, and random
    points across the grid and past its edges."""
    occ = np.zeros((8, 8, 4), np.uint8)
    occ[4, 4, 1] = 1
    f = esdf.esdf(occ, 1.0, device="cpu", dtype=F64)
    jf = jesdf.esdf(occ, 1.0)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=1e-12)
    one = esdf.interp_sdf(f, np.zeros(3), 1.0, [[1.0, 4.5, 1.5]])
    assert one.shape == (1,) and 2.5 < float(one[0]) < 4.5
    pts = np.random.default_rng(3).uniform([-1, -1, -1], [9, 9, 5], (64, 3))
    for p in ([[1.0, 4.5, 1.5]], pts, pts[0]):
        got = esdf.interp_sdf(f, np.zeros(3), 1.0, p)
        want = np.asarray(jesdf.interp_sdf(jf, np.zeros(3), 1.0,
                                           jnp.asarray(p)))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-12)


def test_gridmap_esdf_methods_match_jax():
    """tests/test_env_frontend.py::test_gridmap_esdf_convenience's case."""
    occ = np.zeros((8, 8, 4), np.uint8)
    occ[4, 4, :] = 1
    g = GridMap(resolution=0.5, xyz_min=np.zeros(3), occ=occ)
    jg = JGridMap(resolution=0.5, xyz_min=np.zeros(3), occ=occ)
    f = g.generate_esdf(device="cpu", dtype=F64)
    assert g.generate_esdf(device="cpu", dtype=F64) is f      # kept
    np.testing.assert_allclose(f.numpy(), np.asarray(jg.generate_esdf()),
                               atol=1e-12)
    assert f[4, 4, 0] < 0 < f[0, 0, 0]
    p = np.asarray([[0.6, 0.6, 0.5], [2.25, 2.25, 0.5], [1.3, 3.9, 1.1]])
    v = g.sdf_value(p, device="cpu", dtype=F64)
    np.testing.assert_allclose(v.numpy(), np.asarray(jg.sdf_value(p)),
                               atol=1e-12)
    v2, grad = g.sdf_value_with_grad(p, device="cpu", dtype=F64)
    jv, jgrad = jg.sdf_value_with_grad(p)
    np.testing.assert_allclose(v2.numpy(), np.asarray(jv), atol=1e-12)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), atol=1e-10)
    assert grad.shape == (3, 3)
    d = grad[0, :2].numpy()
    assert np.dot(d, np.asarray([0.6, 0.6]) - np.asarray([2.25, 2.25])) > 0
    # one point: a 0-D value and a (3,) gradient, as in JAX
    v1, g1 = g.sdf_value_with_grad(p[0], device="cpu", dtype=F64)
    jv1, jg1 = jg.sdf_value_with_grad(p[0])
    assert v1.shape == () and g1.shape == (3,)
    np.testing.assert_allclose(float(v1), float(jv1), atol=1e-12)
    np.testing.assert_allclose(g1.numpy(), np.asarray(jg1), atol=1e-10)


@pytest.mark.parametrize("deformable", [False, True],
                         ids=["rigid", "deformable"])
def test_sdf_at_time_matches_jax(deformable):
    rng = np.random.default_rng(9)
    n = 4
    times = rng.uniform(1.0, 2.0, n)
    head = np.zeros((3, 3))
    tail = np.zeros((3, 3))
    tail[0] = [8.0, 2.0, 1.0]
    wps = rng.uniform(0, 6, (n - 1, 3))
    jt = jminco.solve(*(jnp.asarray(a) for a in (times, head, tail, wps)))
    traj = convert.trajectory_from_numpy(np.asarray(jt.coeffs)[None],
                                         np.asarray(jt.durations)[None],
                                         device="cpu", dtype=F64)
    if deformable:
        jshape = jshapes.make_scaled_shape(
            "sdHeart", lambda t: 1.0 + 0.25 * jnp.sin(0.8 * t))
        shape = shapes.make_scaled_shape("sdHeart",
                                         shapes.breathing_scale(0.25, 0.8))
    else:
        jshape, shape = jshapes.make_shape("star"), shapes.make_shape("star")
    pts = rng.uniform([-2, -3], [10, 5], (12, 2))
    ts = rng.uniform(0.0, times.sum(), 12)
    got = svsdf.sdf_at_time(shape, traj, _t(pts)[None], _t(ts)[None])
    want = jsvsdf.sdf_at_time(jshape, jt, jnp.asarray(pts), jnp.asarray(ts))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=1e-12)
    # broadcasting: every point at one time
    got1 = svsdf.sdf_at_time(shape, traj, _t(pts)[None], _t([[ts[3]]]))
    want1 = jsvsdf.sdf_at_time(jshape, jt, jnp.asarray(pts),
                               jnp.asarray(ts[3]))
    np.testing.assert_allclose(got1[0].numpy(), np.asarray(want1),
                               atol=1e-12)
