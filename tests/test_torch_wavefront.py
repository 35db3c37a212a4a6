"""Port parity: the batched wavefront front end.

The JAX functions are vmapped over the lanes, as ``plan_batch_e2e``
runs them, so each lane's ``while_loop`` stops at its own convergence;
the port runs the lanes as one batch with per-lane active flags. Fields
are float32 on both sides and every comparison is exact: fields
(unreachable cells included), paths, yaw bins, lengths and success.
Each batch holds a lane whose goal is unreachable, and the 3-D field is
run with and without a cell cost.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svsdf_tpu.planner import wavefront as jw
from svsdf_tpu.utils.gridmap import GridMap as JGridMap
from svsdf_tpu_torch.planner import wavefront as tw
from svsdf_tpu_torch.utils.gridmap import GridMap

torch.set_num_threads(1)

CPU = dict(device="cpu")


def _free_2d():
    """14 x 11 grid: a wall with a gap, and a sealed 2 x 2 pocket."""
    free = np.ones((14, 11), bool)
    free[6, :8] = False
    free[9:13, 7] = False
    free[9:13, 10] = False
    free[9, 7:11] = False
    free[12, 7:11] = False
    return free


def _feas_3d(seed=0, k=4, x=9, y=7, d=3):
    rng = np.random.default_rng(seed)
    feas = rng.random((k, x, y)) < 0.85
    trans = rng.random((k, d, 8, x, y)) < 0.8
    # seal cell (7, 5): no transition enters it, no bin fits it
    feas[:, 7, 5] = False
    trans[..., 7, 5] = False
    trans[:, :, :, 7, 5] = False
    return feas, trans


def test_distance_field_and_path_2d():
    free = _free_2d()
    goals = np.asarray([[13, 0], [10, 8], [0, 10], [2, 2]])  # lane 1 sealed
    starts = np.asarray([[0, 0], [1, 1], [13, 3], [2, 2]])
    jd = np.asarray(jax.vmap(lambda g: jw.distance_field(
        jnp.asarray(free), g))(jnp.asarray(goals)))
    d = tw.distance_field(free, goals, **CPU)
    assert d.dtype == torch.float32
    np.testing.assert_array_equal(d.numpy(), jd)
    assert (jd[1] >= jw.INF).sum() > 100          # sealed goal: unreachable
    jp, jl, js = jax.vmap(lambda dd, s: jw.extract_path(dd, s, 40))(
        jnp.asarray(jd), jnp.asarray(starts))
    p, ln, ok = tw.extract_path(d, starts, 40, **CPU)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ln.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(js))
    assert ok.tolist() == [True, False, True, True]
    # yaw bins on a 6-bin feasibility whose free bins rotate along x
    feas = np.zeros((6,) + free.shape, bool)
    for i in range(free.shape[0]):
        for b in range(3):
            feas[(i // 3 + b) % 6, i] = free[i]
    jdp = np.asarray(jax.vmap(lambda pp: jw.assign_yaws_dp(
        jnp.asarray(feas), pp))(jp))
    np.testing.assert_array_equal(
        tw.assign_yaws_dp(feas, p, **CPU).numpy(), jdp)
    jg = np.asarray(jax.vmap(lambda pp: jw.assign_yaws(
        jnp.asarray(feas), pp))(jp))
    np.testing.assert_array_equal(tw.assign_yaws(feas, p, **CPU).numpy(),
                                  jg)


def test_plan_and_path_to_world():
    free = _free_2d()
    feas = np.stack([free, free & (np.arange(11)[None] % 2 == 0)])
    starts, goals = np.asarray([[0, 0], [13, 3]]), np.asarray([[13, 0],
                                                               [0, 10]])
    res = tw.plan(free, feas, starts, goals, max_len=48, **CPU)
    for b in range(2):
        jr = jw.plan(jnp.asarray(free), jnp.asarray(feas),
                     jnp.asarray(starts[b]), jnp.asarray(goals[b]),
                     max_len=48)
        np.testing.assert_array_equal(res.path_ij[b].numpy(),
                                      np.asarray(jr.path_ij))
        np.testing.assert_array_equal(res.yaw_bins[b].numpy(),
                                      np.asarray(jr.yaw_bins))
        np.testing.assert_array_equal(res.dist[b].numpy(),
                                      np.asarray(jr.dist))
        assert int(res.length[b]) == int(jr.length)
        assert bool(res.success[b]) == bool(jr.success)
    pts = np.asarray([[0.0, 0.0, 0.0], [13.9, 10.9, 1.0]])
    grid, jgrid = GridMap.from_points(pts, 1.0), JGridMap.from_points(pts,
                                                                     1.0)
    np.testing.assert_array_equal(
        tw.path_to_world(grid, res.path_ij[0], res.yaw_bins[0],
                         res.length[0], 2),
        jw.path_to_world(jgrid, np.asarray(res.path_ij[0]),
                         np.asarray(res.yaw_bins[0]), int(res.length[0]), 2))


@pytest.mark.parametrize("with_cost", [False, True])
def test_distance_field_and_path_3d(with_cost):
    feas, trans = _feas_3d()
    k, x, y = feas.shape
    cc = (np.random.default_rng(1).random((x, y)) * 0.7).astype(np.float32)
    cc = cc if with_cost else None
    goals = np.asarray([[4, 3], [7, 5], [8, 6], [0, 0]])   # lane 1 sealed
    starts = np.asarray([[0, 0], [0, 6], [1, 1], [8, 0]])
    jcc = None if cc is None else jnp.asarray(cc)
    jd = np.asarray(jax.vmap(lambda g: jw.distance_field_3d(
        jnp.asarray(feas), jnp.asarray(trans), g, 0.25, cell_cost=jcc))(
            jnp.asarray(goals)))
    d = tw.distance_field_3d(feas, trans, goals, 0.25, cell_cost=cc, **CPU)
    np.testing.assert_array_equal(d.numpy(), jd)
    assert (jd[1] >= jw.INF).all()
    jp, jb, jl, js = jax.vmap(lambda dd, s: jw.extract_path_3d(
        dd, jnp.asarray(trans), s, 30, 0.25, cell_cost=jcc))(
            jnp.asarray(jd), jnp.asarray(starts))
    p, b, ln, ok = tw.extract_path_3d(d, trans, starts, 30, 0.25,
                                      cell_cost=cc, **CPU)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ln.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(js))
    assert not ok[1] and ok[0] and ok[2]
