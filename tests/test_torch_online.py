"""Port parity: ``OnlineReplanner`` on two synthetic gate scenarios.

The port and the JAX package each build their replanner from the same
scenario (the port's own copy of the synthetic fixtures is held equal to
the JAX one) and plan one trip. The solve runs in float64 on both sides
(JAX with x64, the port with ``dtype=torch.float64``); to keep the JAX
compile short the schedule is one cheap stage, 4 spline pieces, 16
obstacles and 4 refine iterations, with the replanner's own 3-D front
end, route shaping and two certify-refine rounds.

Held: the front end's maps (feasibility, transition feasibility and
cell cost) exactly, success, the harvested obstacles in order, the cost
at rtol 1e-4, the certificate and the spline coefficients at 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

from svsdf_tpu.ops.svsdf import SVSDFConfig as JSVSDFConfig
from svsdf_tpu.planner.online import OnlineReplanner as JOnlineReplanner
from svsdf_tpu.utils import fixtures as jfixtures
from svsdf_tpu_torch import convert
from svsdf_tpu_torch.ops.svsdf import SVSDFConfig
from svsdf_tpu_torch.planner.online import OnlineReplanner
from svsdf_tpu_torch.utils import fixtures
from svsdf_tpu_torch.utils import trajectory as trj

torch.set_num_threads(1)

SVS = dict(coarse_n=48, refine_rounds=1, refine_n=8, use_inside=False)
KW = dict(n_pieces=4, n_obs=16, refine_rounds=2, refine_iters=4)


def test_synthetic_scenarios_match():
    assert fixtures.list_synthetic_scenarios() == \
        jfixtures.list_synthetic_scenarios()
    for name in fixtures.list_synthetic_scenarios():
        sc, jsc = (fixtures.synthetic_scenario(name),
                   jfixtures.synthetic_scenario(name))
        assert sc.name == jsc.name
        assert dataclasses.asdict(sc.config) == {
            k: (tuple(v) if isinstance(v, list) else v)
            for k, v in dataclasses.asdict(jsc.config).items()}
        for f in ("map_points", "start", "goal"):
            np.testing.assert_array_equal(getattr(sc, f), getattr(jsc, f))
        carried = convert.scenario_from_numpy(
            jsc.name, dataclasses.asdict(jsc.config), jsc.map_points,
            jsc.start, jsc.goal)
        assert carried.config == sc.config
    with pytest.raises(KeyError):
        fixtures.synthetic_scenario("sdRhombus")


@pytest.mark.parametrize("name", ["Circle", "Polygon"])
def test_online_replanner_matches_jax(name):
    sc = fixtures.synthetic_scenario(name)
    jsc = jfixtures.synthetic_scenario(name)
    jr = JOnlineReplanner(jsc.config, jsc.map_points,
                          stages=((JSVSDFConfig(**SVS), 8, 2),), **KW)
    rp = OnlineReplanner(sc.config, sc.map_points,
                         stages=((SVSDFConfig(**SVS), 8, 2),), device="cpu",
                         dtype=torch.float64, **KW)
    assert rp.shape.name == jr.shape.name
    np.testing.assert_array_equal(rp.feas.numpy(), np.asarray(jr.feas))
    np.testing.assert_array_equal(rp.trans_feas.numpy(),
                                  np.asarray(jr.trans_feas))
    assert rp.cell_cost.dtype == torch.float32
    np.testing.assert_array_equal(rp.cell_cost.numpy(),
                                  np.asarray(jr.cell_cost))
    np.testing.assert_array_equal(rp.occ_pts.numpy(), np.asarray(jr.occ_pts))
    assert rp.n_obs == jr.n_obs and rp.cert_margin == jr.cert_margin

    res = rp.replan(sc.start[:2], sc.goal[:2])
    jres = jr.replan(jsc.start[:2], jsc.goal[:2])
    assert res.success and jres.success
    np.testing.assert_array_equal(res.obstacles, np.asarray(jres.obstacles))
    np.testing.assert_allclose(res.cost, jres.cost, rtol=1e-4)
    np.testing.assert_allclose(res.cert_min, jres.cert_min, rtol=0,
                               atol=1e-6)
    assert res.traj.coeffs.shape == (1, KW["n_pieces"], 6, 3)
    np.testing.assert_allclose(res.traj.coeffs[0].numpy(),
                               np.asarray(jres.traj.coeffs), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(res.traj.durations[0].numpy(),
                               np.asarray(jres.traj.durations), rtol=0,
                               atol=1e-6)
    assert set(rp.build_breakdown) == set(jr.build_breakdown) == {
        "grid_s", "precompute_s", "first_replan_s"}
    # the plan crosses the gate and ends in the goal cell
    end = trj.pos(res.traj, res.traj.total_duration[:, None])[0, 0, :2]
    assert np.abs(end.numpy() - sc.goal[:2]).max() <= 0.5 + 1e-6
