"""Port parity: the single-plan ``Planner`` with a mesh robot. The r = 1.0
cylinder (svsdf_tpu_torch/bench.py ``write_prism_obj`` of the Circle body,
synthetic_Circle's robot as a mesh), routed through ``shape_from_objpath``
from the config's ``inputdata``, on synthetic_Circle's gate map, at the
reduced settings of tests/test_planner_e2e.py::test_full_pipeline_mesh_shape
(coarse_n 96, one refine round, 3 GSIP iterations on 32 poses; 40 mid-end
and 80 back-end iterations, one certify round, no retries), against the
JAX ``Planner``, both in float64 (JAX with x64).

The front end's maps are held equal first, then the plan, at
tests/test_torch_pipeline.py's tolerances: the same A* path, the mid cost
at rtol 1e-6, equal certified, the final cost at rtol 1e-5 and the
certificate at atol 1e-4 (the back-end solve amplifies rounding, ROADMAP C).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svsdf_tpu.ops.svsdf import SVSDFConfig as JSVSDFConfig
from svsdf_tpu.planner.pipeline import Planner as JPlanner
from svsdf_tpu.utils.config import PlannerConfig as JPlannerConfig
from svsdf_tpu_torch.bench import write_prism_obj
from svsdf_tpu_torch.ops.svsdf import SVSDFConfig
from svsdf_tpu_torch.planner.pipeline import Planner
from svsdf_tpu_torch.utils import fixtures

torch.set_num_threads(1)

SVS = dict(coarse_n=96, refine_rounds=1, gsip_iters=3, gsip_coarse_n=32,
           gsip_refine_rounds=1)
PLAN = dict(mid_iters=40, back_iters=80, certify_rounds=1,
            certify_retries=0)


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    obj = write_prism_obj("Circle", str(
        tmp_path_factory.mktemp("mesh") / "roundRobot.obj"), extent=2.0)
    sc = fixtures.synthetic_scenario("Circle")
    return dataclasses.replace(sc.config, inputdata=obj), sc


@pytest.fixture(scope="module")
def jax_plan(scenario):
    cfg, sc = scenario
    jpl = JPlanner(JPlannerConfig(**dataclasses.asdict(cfg)), sc.map_points,
                   svs_cfg=JSVSDFConfig(**SVS))
    return jpl, jpl.plan(sc.start, sc.goal, **PLAN)


def test_mesh_planner_matches_jax(scenario, jax_plan):
    cfg, sc = scenario
    jpl, jres = jax_plan
    pl = Planner(cfg, sc.map_points, svs_cfg=SVSDFConfig(**SVS),
                 device="cpu", dtype=torch.float64)
    assert pl.shape.name == jpl.shape.name == "mesh:roundRobot"
    assert pl.shape.grid is not None
    np.testing.assert_array_equal(pl.feas, jpl.feas)
    for guard in pl.guard_ladder:
        np.testing.assert_array_equal(pl._trans_feas(guard),
                                      jpl._trans_feas(guard))
    res = pl.plan(sc.start, sc.goal, **PLAN)
    assert res.success and jres.success
    assert res.min_cert_sdf > 0.0
    np.testing.assert_array_equal(res.astar_path, jres.astar_path)
    np.testing.assert_allclose(res.mid_cost, jres.mid_cost, rtol=1e-6)
    assert res.certified == jres.certified
    for key in ("attempts", "refine_rounds", "n_obstacles"):
        assert res.timings[key] == jres.timings[key], key
    np.testing.assert_allclose(res.final_cost, jres.final_cost, rtol=1e-5)
    np.testing.assert_allclose(res.min_cert_sdf, jres.min_cert_sdf,
                               rtol=0, atol=1e-4)


def test_mesh_replan_on_the_host(scenario):
    """The online replanner with the mesh robot, against JAX's on the same
    config and map, at tests/test_torch_online.py's settings and
    tolerances (float64 on both sides; one cheap stage, 4 pieces, 16
    obstacles, two certify-refine rounds): the front end's maps exactly,
    success, the harvested obstacles in order, the cost at rtol 1e-4, the
    certificate and the spline coefficients at 1e-6."""
    from svsdf_tpu.planner.online import OnlineReplanner as JOnlineReplanner
    from svsdf_tpu_torch.planner.online import OnlineReplanner
    cfg, sc = scenario
    svs = dict(coarse_n=48, refine_rounds=1, refine_n=8, use_inside=False)
    kw = dict(n_pieces=4, n_obs=16, refine_rounds=2, refine_iters=4)
    jr = JOnlineReplanner(JPlannerConfig(**dataclasses.asdict(cfg)),
                          sc.map_points,
                          stages=((JSVSDFConfig(**svs), 8, 2),), **kw)
    rp = OnlineReplanner(cfg, sc.map_points,
                         stages=((SVSDFConfig(**svs), 8, 2),), device="cpu",
                         dtype=torch.float64, **kw)
    assert rp.shape.name == jr.shape.name == "mesh:roundRobot"
    for f in ("feas", "trans_feas", "cell_cost", "occ_pts"):
        np.testing.assert_array_equal(getattr(rp, f).numpy(),
                                      np.asarray(getattr(jr, f)))
    res = rp.replan(sc.start[:2], sc.goal[:2])
    jres = jr.replan(sc.start[:2], sc.goal[:2])
    assert res.success and jres.success
    assert res.cert_min > 0.0
    np.testing.assert_array_equal(res.obstacles, np.asarray(jres.obstacles))
    np.testing.assert_allclose(res.cost, jres.cost, rtol=1e-4)
    np.testing.assert_allclose(res.cert_min, jres.cert_min, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(res.traj.coeffs[0].numpy(),
                               np.asarray(jres.traj.coeffs), rtol=1e-6,
                               atol=1e-6)


def test_mesh_plan_batch_e2e_matches_jax(scenario):
    """``plan_batch_e2e`` with the mesh robot against JAX's on
    tests/test_torch_e2e.py's corridor (its 2-D case: B = 3, one cheap
    stage), float64 on both sides, at that file's tolerances: the front
    end exactly, the cost at rtol 1e-4, the certificate at 1e-6."""
    from svsdf_tpu.models import shapes as jshapes
    from svsdf_tpu.parallel import batch as jbatch
    from svsdf_tpu_torch import convert
    from svsdf_tpu_torch.models import shapes
    from svsdf_tpu_torch.parallel import batch as pb
    from svsdf_tpu_torch.utils.config import PlannerConfig
    from tests.test_torch_e2e import N, N_OBS, SVS as E2E_SVS, _compare, \
        _corridor
    cfg, _ = scenario
    shape = shapes.shape_from_objpath(cfg.inputdata)
    jshape = jshapes.shape_from_objpath(cfg.inputdata)
    assert shape.name == jshape.name == "mesh:roundRobot"
    grid, feas, occ = _corridor()
    xy_min = grid.xyz_min[:2].astype(np.float32)
    starts = np.asarray([[3, 3], [2, 5], [4, 2]])
    goals = np.asarray([[20, 12], [21, 11], [19, 13]])
    jo = jbatch.plan_batch_e2e(
        jshape, jnp.asarray(feas), jnp.asarray(occ),
        jnp.asarray(starts, jnp.int32), jnp.asarray(goals, jnp.int32),
        JPlannerConfig(mem_size=8),
        ((JSVSDFConfig(**E2E_SVS, use_pallas=False), 15, 2),), N, N_OBS,
        1.0, jnp.asarray(xy_min))
    feas_t, occ_t, _, _ = convert.front_end_maps_from_numpy(
        feas, occ, None, None, device="cpu")
    out = pb.plan_batch_e2e(
        shape, feas_t, occ_t, starts, goals, PlannerConfig(mem_size=8),
        ((SVSDFConfig(**E2E_SVS), 15, 2),), N, N_OBS, 1.0, xy_min,
        device="cpu", dtype=torch.float64)
    _compare(jo, out)
    assert float(out.cert_min.min()) > 0.0
