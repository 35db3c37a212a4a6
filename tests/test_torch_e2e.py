"""Port parity: ``plan_batch_e2e`` against the JAX package, float64.

The corridor map of tests/test_parallel.py (a wall with a gap, Circle
robot, 4 yaw bins of 7x7 stencils). Both sides get the same float32
feasibility maps and occupied-cell centres; the solve runs in float64
(JAX with x64, the port with ``dtype=torch.float64``) while the front
end's field and the obstacles stay float32 on both, as in the JAX
package. The front end must agree exactly: success, head and tail
(compared at 1e-6), and the harvested obstacles, in order. The solve
agrees at rtol 1e-4 in cost and 1e-6 in the certificate (measured here:
~1e-11 and ~1e-13).

Two cases: B=3 with the 2-D front end and one cheap stage; B=2 with the
3-D transition-checked front end, a cell cost, and two certify-refine
rounds whose margin makes both lanes re-solve.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svsdf_tpu.models import shapes as jshapes
from svsdf_tpu.ops import kernels as jk
from svsdf_tpu.ops.svsdf import SVSDFConfig as JSVSDFConfig
from svsdf_tpu.parallel import batch as jbatch
from svsdf_tpu.utils.config import PlannerConfig as JPlannerConfig
from svsdf_tpu_torch import convert
from svsdf_tpu_torch.models import shapes
from svsdf_tpu_torch.ops.svsdf import SVSDFConfig
from svsdf_tpu_torch.parallel import batch as pb
from svsdf_tpu_torch.utils.config import PlannerConfig
from svsdf_tpu_torch.utils.gridmap import GridMap

torch.set_num_threads(1)

N, N_OBS = 6, 16
SVS = dict(coarse_n=48, refine_rounds=1, refine_n=8, use_inside=False)


def _corridor():
    pts = [(x + 0.5, 7.2, z + 0.5) for x in range(24) for z in range(2)
           if not 10 <= x <= 13]
    pts += [(0.05, 0.05, 0.05), (23.9, 15.9, 1.9)]
    grid = GridMap.from_points(np.asarray(pts), 1.0, 1)
    ker = jk.rasterize_shape_kernels(jshapes.make_shape("Circle"), 7, 4,
                                     1.0, 0.5)
    feas = np.array(jk.feasibility_maps(jnp.asarray(grid.occ2d), ker))
    return grid, feas, grid.occupied_centers_2d()


def _compare(jo, out):
    np.testing.assert_array_equal(out.front_ok.numpy(),
                                  np.asarray(jo.front_ok))
    assert bool(out.front_ok.all())
    np.testing.assert_allclose(out.head.numpy(), np.asarray(jo.head),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.tail.numpy(), np.asarray(jo.tail),
                               rtol=0, atol=1e-6)
    assert out.obstacles.dtype == torch.float32
    np.testing.assert_array_equal(out.obstacles.numpy(),
                                  np.asarray(jo.obstacles))
    assert out.x.dtype == torch.float64
    np.testing.assert_allclose(out.cost.numpy(), np.asarray(jo.cost),
                               rtol=1e-4)
    np.testing.assert_allclose(out.cert_min.numpy(), np.asarray(jo.cert_min),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.x.numpy(), np.asarray(jo.x), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(out.coeffs.numpy(), np.asarray(jo.coeffs),
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("case", ["2d", "3d_refine"])
def test_plan_batch_e2e_matches_jax(case):
    grid, feas, occ = _corridor()
    xy_min = grid.xyz_min[:2].astype(np.float32)
    starts = np.asarray([[3, 3], [2, 5], [4, 2]])
    goals = np.asarray([[20, 12], [21, 11], [19, 13]])
    kw, jkw = {}, {}
    if case == "3d_refine":
        starts, goals = starts[:2], goals[:2]
        sten = jk.transition_stencils(jshapes.make_shape("Circle"), 4, 1.0,
                                      5.0, n_deltas=5)
        trans = np.array(jk.transition_feasibility(jnp.asarray(grid.occ2d),
                                                   sten))
        cc = (0.5 * (grid.occ2d == 0)).astype(np.float32)
        # a margin above the staged solve's certificates (~0.8-0.95 m):
        # every lane violates, escalates and re-solves in both rounds
        kw = dict(refine_rounds=2, refine_iters=6, cert_margin=1.2,
                  trans_feas=trans, cell_cost=cc)
        jkw = dict(kw, trans_feas=jnp.asarray(trans),
                   cell_cost=jnp.asarray(cc))
    iters = 15 if case == "2d" else 8
    jo = jbatch.plan_batch_e2e(
        jshapes.make_shape("Circle"), jnp.asarray(feas), jnp.asarray(occ),
        jnp.asarray(starts, jnp.int32), jnp.asarray(goals, jnp.int32),
        JPlannerConfig(mem_size=8),
        ((JSVSDFConfig(**SVS, use_pallas=False), iters, 2),), N, N_OBS, 1.0,
        jnp.asarray(xy_min), **jkw)
    # the same arrays, carried across as tensors
    feas_t, occ_t, trans_t, cc_t = convert.front_end_maps_from_numpy(
        feas, occ, kw.pop("trans_feas", None), kw.pop("cell_cost", None),
        device="cpu")
    out = pb.plan_batch_e2e(
        shapes.make_shape("Circle"), feas_t, occ_t, starts, goals,
        PlannerConfig(mem_size=8), ((SVSDFConfig(**SVS), iters, 2),), N,
        N_OBS, 1.0, xy_min, device="cpu", dtype=torch.float64,
        trans_feas=trans_t, cell_cost=cc_t, **kw)
    _compare(jo, out)
    assert float(out.cert_min.min()) > 0.0
    goal_xy = xy_min[None] + (goals + 0.5) * 1.0
    np.testing.assert_allclose(out.tail[:, 0, :2].numpy(), goal_xy,
                               atol=1e-4)
    if case == "3d_refine":
        # the refine rounds ran and re-solved: the certificate is below the
        # margin, so every round escalated
        assert bool((out.cert_min < 1.2).all())


def test_resample_and_harvest_helpers():
    """A straight 3-cell path resamples to evenly spaced states, and the
    harvest orders equidistant cells lower index first."""
    path = torch.as_tensor([[[0, 0], [1, 0], [2, 0], [2, 0]]])
    bins = torch.zeros((1, 4), dtype=torch.long)
    head, tail, states = pb._resample_path(
        path, bins, torch.as_tensor([3]), 4, 1.0,
        torch.zeros(2), 4, torch.float64)
    np.testing.assert_allclose(states[0, :, 0].numpy(),
                               [0.5, 1.0, 1.5, 2.0, 2.5])
    assert float(head[0, 0, 0]) == 0.5 and float(tail[0, 0, 0]) == 2.5
    occ = torch.as_tensor([[5.0, 1.0], [5.0, -1.0], [0.0, 9.0]])
    got = pb._harvest_topm(occ, torch.as_tensor([[[5.0, 0.0, 0.0]]]), 2)
    np.testing.assert_array_equal(got[0].numpy(), occ[:2].numpy())


def test_plan_batch_e2e_default_stages_matches_jax():
    """B=3 on the corridor at the JAX package's default schedule,
    default_stages(8): the fast and polish stages' scans (and GSIP's) in
    bfloat16 on both sides, float64 elsewhere (a float32 JAX solve under
    the tests' x64 mode is mixed precision, see
    test_torch_bf16_scan.py). The front end agrees exactly; the solve at
    _compare's tolerances and, tighter, at rtol 1e-9 in cost and 1e-9 m
    in the certificate (measured here: 1.2e-13 and 2.9e-13)."""
    grid, feas, occ = _corridor()
    xy_min = grid.xyz_min[:2].astype(np.float32)
    starts = np.asarray([[3, 3], [2, 5], [4, 2]])
    goals = np.asarray([[20, 12], [21, 11], [19, 13]])
    stages = pb.default_stages(8)
    assert all(st[0].scan_dtype == "bfloat16" for st in stages)
    jo = jbatch.plan_batch_e2e(
        jshapes.make_shape("Circle"), jnp.asarray(feas), jnp.asarray(occ),
        jnp.asarray(starts, jnp.int32), jnp.asarray(goals, jnp.int32),
        JPlannerConfig(mem_size=8), jbatch.default_stages(8), N, N_OBS, 1.0,
        jnp.asarray(xy_min))
    feas_t, occ_t, _, _ = convert.front_end_maps_from_numpy(
        feas, occ, None, None, device="cpu")
    out = pb.plan_batch_e2e(
        shapes.make_shape("Circle"), feas_t, occ_t, starts, goals,
        PlannerConfig(mem_size=8), stages, N, N_OBS, 1.0, xy_min,
        device="cpu", dtype=torch.float64)
    _compare(jo, out)
    np.testing.assert_allclose(out.cost.numpy(), np.asarray(jo.cost),
                               rtol=1e-9)
    np.testing.assert_allclose(out.cert_min.numpy(), np.asarray(jo.cert_min),
                               rtol=0, atol=1e-9)
