"""Port parity: the batched SVSDF oracle (ops/svsdf.py), float64.

Two plans (MINCO trajectories of 4 pieces) with query points both near
the path (inside the swept volume of sdHeart) and far from it go through
the port's batched functions and, plan by plan, through the JAX
package's. sdf, t* and the world gradient agree at atol 1e-8 for

  * ``tstar_search_batch`` with the fast stage's configuration (table
    parabola) and the polish stage's (two wide rounds), the latter with
    exact poses and with poses read from a 512-sample fine table;
  * ``svsdf_query`` with the GSIP interior solve on every point, on the
    ``gsip_topk`` most interior points, and with ``gsip_fori`` set (the
    port accepts it and runs its one loop; JAX runs its padded form);
  * ``svsdf_grid``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svsdf_tpu.models import shapes as jshapes
from svsdf_tpu.ops import svsdf as jsv
from svsdf_tpu.utils import trajectory as jtrj
from svsdf_tpu_torch import convert
from svsdf_tpu_torch.ops import minco
from svsdf_tpu_torch.ops import svsdf as sv
from svsdf_tpu_torch.utils import trajectory as trj

torch.set_num_threads(1)

B, N, M = 2, 4, 24
ATOL = 1e-8

FAST = dict(coarse_n=96, refine_rounds=0, refine_n=16, use_inside=False)
POLISH = dict(coarse_n=128, refine_rounds=2, refine_n=16, gsip_iters=3,
              gsip_coarse_n=32, gsip_refine_rounds=1, gsip_topk=6)


def _t(a):
    return torch.as_tensor(a, dtype=torch.float64)


def _problem(seed=0):
    """(port Trajectory, [JAX Trajectory per plan], points (B, M, 2))."""
    rng = np.random.default_rng(seed)
    head = np.zeros((B, 3, 3))
    tail = np.zeros((B, 3, 3))
    tail[:, 0] = np.stack([rng.uniform(7, 10, B), rng.uniform(-2, 2, B),
                           rng.uniform(-1, 1, B)], -1)
    frac = np.linspace(0, 1, N + 1)[1:-1]
    wps = tail[:, None, 0] * frac[None, :, None] + rng.normal(
        0, 0.4, (B, N - 1, 3))
    times = rng.uniform(1.0, 2.0, (B, N))
    traj = minco.solve(_t(times), _t(head), _t(tail), _t(wps))
    jtrajs = [jtrj.Trajectory(jnp.asarray(traj.coeffs[b].numpy()),
                              jnp.asarray(traj.durations[b].numpy()))
              for b in range(B)]
    # half the points near the path (mostly inside sdHeart's sweep),
    # half anywhere in a box around it
    tq = rng.uniform(0, 1, (B, M // 2)) * traj.total_duration.numpy()[:, None]
    near = trj.pos(traj, _t(tq))[..., :2].numpy() + rng.normal(
        0, 0.8, (B, M // 2, 2))
    far = np.stack([rng.uniform(-6, 16, (B, M // 2)),
                    rng.uniform(-8, 8, (B, M // 2))], -1)
    return traj, jtrajs, np.concatenate([near, far], axis=1)


@pytest.fixture(scope="module")
def case():
    return _problem()


HEART = convert.shape_from_spec("sdHeart")
JHEART = jshapes.make_shape("sdHeart")


def _close(port, jax_rows):
    np.testing.assert_allclose(port.numpy(), np.stack(
        [np.asarray(r) for r in jax_rows]), atol=ATOL, rtol=0)


@pytest.mark.parametrize("cfg", [
    FAST, POLISH, dict(POLISH, refine_interp_n=512),
], ids=["fast-parabola", "polish-wide", "polish-wide-interp"])
def test_tstar_search_batch_matches_jax(case, cfg):
    traj, jtrajs, pts = case
    sdf, ts = sv.tstar_search_batch(HEART, traj, _t(pts),
                                    sv.SVSDFConfig(**cfg))
    jcfg = jsv.SVSDFConfig(**cfg)
    rows = [jsv.tstar_search_batch(JHEART, jtrajs[b], jnp.asarray(pts[b]),
                                   jcfg) for b in range(B)]
    _close(sdf, [r[0] for r in rows])
    _close(ts, [r[1] for r in rows])


@pytest.mark.parametrize("cfg", [
    dict(POLISH, gsip_topk=0), POLISH, dict(POLISH, gsip_fori=True),
    FAST,
], ids=["gsip-all", "gsip-topk", "gsip-fori", "outside-only"])
def test_svsdf_query_matches_jax(case, cfg):
    traj, jtrajs, pts = case
    res = sv.svsdf_query(HEART, traj, _t(pts), sv.SVSDFConfig(**cfg),
                         with_inside=cfg.get("use_inside", True))
    if cfg.get("use_inside", True):
        # the interior solve has work to do in both plans
        assert bool((res.sdf < 0).any(dim=1).all())
    jcfg = jsv.SVSDFConfig(**cfg)
    rows = [jsv.svsdf_query(JHEART, jtrajs[b], jnp.asarray(pts[b]), jcfg,
                            with_inside=jcfg.use_inside)
            for b in range(B)]
    _close(res.sdf, [r.sdf for r in rows])
    _close(res.t_star, [r.t_star for r in rows])
    _close(res.grad_world, [r.grad_world for r in rows])


def test_gsip_fori_gives_the_unrolled_values(case):
    traj, _, pts = case
    base = sv.SVSDFConfig(**dict(POLISH, gsip_topk=0))
    a = sv.svsdf_query(HEART, traj, _t(pts), base)
    b = sv.svsdf_query(HEART, traj, _t(pts),
                       dataclasses.replace(base, gsip_fori=True))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=ATOL)


def test_svsdf_grid_matches_jax(case):
    traj, jtrajs, _ = case
    xs = np.linspace(-4.0, 14.0, 9)
    ys = np.linspace(-6.0, 6.0, 7)
    cfg = dict(coarse_n=64, refine_rounds=1)
    grid = sv.svsdf_grid(HEART, traj, _t(xs), _t(ys), sv.SVSDFConfig(**cfg))
    assert grid.shape == (B, 9, 7)
    rows = [jsv.svsdf_grid(JHEART, jtrajs[b], jnp.asarray(xs),
                           jnp.asarray(ys), jsv.SVSDFConfig(**cfg))
            for b in range(B)]
    _close(grid, rows)
