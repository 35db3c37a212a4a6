"""Port parity: the single-plan pipeline (planner/pipeline.py, parity.py).

``Planner.plan`` on the Circle corridor of tests/test_planner_e2e.py at
its settings (coarse_n 128, 2 refine rounds, 4 GSIP iterations on 48
poses; 60 mid-end and 120 back-end iterations) against the JAX
``Planner``, both in float64 (JAX with x64). The feasibility and
transition maps are held equal first, then the plan: the same A* path,
mid cost at rtol 1e-6, equal certified, attempts and refine rounds, the
final cost at rtol 1e-5 and the certificate at atol 1e-4.

The last two are looser than the rest because the back-end solve
amplifies rounding: a 1e-14 relative perturbation of its warm start
moves its final cost by ~1.5e-6 (tests/test_torch_back_end.py::
test_optimize_amplifies_rounding_at_pipeline_settings), and the two
packages differ by rounding from the first iteration (measured here:
1.1e-6 in cost, 1.3e-5 m in the certificate). ROADMAP C records it;
tests/test_torch_back_end.py holds the solve itself at 1e-8 on settings
whose stages stop early.

Then the port's counterparts of the ladder tests of
tests/test_planner_e2e.py (near-miss extension, failed rung, waypoint
nudge, fine-yaw rung), and ``parity.reference_cost`` against the JAX
package's on the JAX plan's trajectory.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from svsdf_tpu.ops.svsdf import SVSDFConfig as JSVSDFConfig
from svsdf_tpu.planner import parity as jparity
from svsdf_tpu.planner.pipeline import Planner as JPlanner
from svsdf_tpu.utils.config import PlannerConfig as JPlannerConfig
from svsdf_tpu_torch import convert
from svsdf_tpu_torch.ops import minco
from svsdf_tpu_torch.ops.svsdf import SVSDFConfig
from svsdf_tpu_torch.planner import parity
from svsdf_tpu_torch.planner import pipeline as pp
from svsdf_tpu_torch.planner.pipeline import Planner, PlanResult
from svsdf_tpu_torch.utils import trajectory as trj
from svsdf_tpu_torch.utils.config import PlannerConfig
from tests.test_torch_mid_end import GOAL, START, corridor

torch.set_num_threads(1)

SVS = dict(coarse_n=128, refine_rounds=2, gsip_iters=4, gsip_coarse_n=48,
           gsip_refine_rounds=1)
ITERS = dict(mid_iters=60, back_iters=120)


def _planner(**kw):
    fields, pts = corridor()
    return Planner(PlannerConfig(**fields), pts, device="cpu",
                   dtype=torch.float64, **kw)


@pytest.fixture(scope="module")
def jax_plan():
    fields, pts = corridor()
    jpl = JPlanner(JPlannerConfig(**fields), pts,
                   svs_cfg=JSVSDFConfig(**SVS))
    return jpl, jpl.plan(START, GOAL, **ITERS)


def test_plan_matches_jax(jax_plan):
    jpl, jres = jax_plan
    pl = _planner(svs_cfg=SVSDFConfig(**SVS))
    np.testing.assert_array_equal(pl.grid.occ, jpl.grid.occ)
    np.testing.assert_array_equal(pl.feas, jpl.feas)
    for guard in pl.guard_ladder:
        np.testing.assert_array_equal(pl._trans_feas(guard),
                                      jpl._trans_feas(guard))
    np.testing.assert_array_equal(pl._conservative_feas(),
                                  jpl._conservative_feas())
    res = pl.plan(START, GOAL, **ITERS)
    assert res.success and jres.success
    np.testing.assert_array_equal(res.astar_path, jres.astar_path)
    np.testing.assert_allclose(res.mid_cost, jres.mid_cost, rtol=1e-6)
    assert res.certified == jres.certified
    for key in ("attempts", "refine_rounds", "n_obstacles"):
        assert res.timings[key] == jres.timings[key], key
    np.testing.assert_allclose(res.final_cost, jres.final_cost, rtol=1e-5)
    np.testing.assert_allclose(res.min_cert_sdf, jres.min_cert_sdf,
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(res.obstacles, jres.obstacles)
    # the requested endpoints are pinned into the spline
    total = res.traj.total_duration[:, None]
    ends = trj.pos(res.traj, torch.cat([total * 0.0, total], 1))[0]
    np.testing.assert_allclose(ends[:, :2].numpy(), [START[:2], GOAL[:2]],
                               atol=1e-6)
    # the certificate of the plan re-computed from scratch agrees
    pts, sdf = pl.certify(res.traj)
    assert len(pts) > 0 and float(sdf.min()) == res.min_cert_sdf


def test_reference_cost_matches_jax(jax_plan):
    jpl, jres = jax_plan
    fields, _ = corridor()
    svs = JSVSDFConfig(**SVS)
    want = jparity.reference_cost(jpl.shape, jres.traj, jres.obstacles,
                                  JPlannerConfig(**fields), svs)
    traj = convert.trajectory_from_numpy(np.asarray(jres.traj.coeffs),
                                         np.asarray(jres.traj.durations),
                                         device="cpu", dtype=torch.float64)
    got = parity.reference_cost(convert.shape_from_spec("Circle"), traj,
                                jres.obstacles, PlannerConfig(**fields),
                                SVSDFConfig(**SVS))
    for name in ("energy", "time", "penalty", "total", "min_svsdf"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-9, atol=1e-12, err_msg=name)
    assert got.n_active == want.n_active


def test_reference_mode_plan_runs_one_solve():
    pl = _planner(svs_cfg=SVSDFConfig(coarse_n=64, refine_rounds=1,
                                      gsip_iters=2, gsip_coarse_n=24))
    res = parity.reference_mode_plan(pl, START, GOAL, mid_iters=20,
                                     back_iters=10)
    assert res.success and np.isfinite(res.final_cost)
    assert np.isfinite(res.min_cert_sdf)
    assert res.certified == (res.min_cert_sdf > 0.0)
    assert len(res.obstacles) % 256 == 0


def _fake_result(success=True, certified=False, min_cert_sdf=-0.5,
                 final_cost=1.0):
    return PlanResult(success, None, None, np.zeros((2, 3)),
                      np.zeros((0, 3)), 1.0, final_cost,
                      certified=certified, min_cert_sdf=min_cert_sdf)


def test_fine_yaw_retry_planner():
    """The fine-yaw last rung: the clone has scaled bins and no rung of
    its own, is cached, and plan() adopts its certified result when the
    base ladder comes up uncertified."""
    fields, _ = corridor()
    pl = _planner(use_transition_check=False, fine_yaw_factor=2)
    fine = pl._get_fine_planner(2)
    assert fine.config.kernel_yaw_num == 2 * fields["kernel_yaw_num"]
    assert fine._fine_yaw_factor == 0
    assert fine.dtype == torch.float64 and fine.device == pl.device
    assert pl._get_fine_planner(2) is fine

    uncert = _fake_result(min_cert_sdf=-0.5)
    cert = _fake_result(certified=True, min_cert_sdf=0.3, final_cost=2.0)
    pl._attempt = lambda *a, **k: uncert

    class _Stub:
        def __init__(self, res):
            self.res, self.calls = res, 0

        def plan(self, *a, **k):
            self.calls += 1
            return self.res

    s2, s4 = _Stub(cert), _Stub(cert)
    pl._fine_planners = {2: s2, 4: s4}
    out = pl.plan(START, GOAL, certify_retries=1)
    assert out.certified and out.min_cert_sdf == 0.3
    assert s2.calls == 1 and s4.calls == 0     # stopped at factor 2
    # factor 2 worse than the base, factor 4 better: both run
    s2 = _Stub(_fake_result(min_cert_sdf=-1.0, final_cost=2.0))
    s4 = _Stub(_fake_result(min_cert_sdf=-0.1, final_cost=2.0))
    pl._fine_planners = {2: s2, 4: s4}
    out = pl.plan(START, GOAL, certify_retries=1)
    assert out.min_cert_sdf == -0.1
    assert s2.calls == 1 and s4.calls == 1


def test_near_miss_certify_extension(monkeypatch):
    """Extra warm-started refine rounds for a near miss
    (-0.15 < min_sdf < 0), none for a deep violation, at most 3."""
    pl = _planner(use_transition_check=False, fine_yaw_factor=0)
    path = np.stack([np.linspace(3.5, 20.5, 12), np.linspace(3.5, 12.5, 12),
                     np.zeros(12)], axis=-1)
    monkeypatch.setattr(pl, "generate_path", lambda *a, **k:
                        types.SimpleNamespace(success=True, path=path))
    monkeypatch.setattr(pl, "_harvest",
                        lambda q: np.array([[12.0, 7.5, 0.0]]))
    fake = types.SimpleNamespace(traj="traj", cost=torch.ones(1),
                                 opt_x=torch.zeros(1, 4))
    monkeypatch.setattr(pp.mid_end, "optimize", lambda *a, **k: fake)
    solves = []
    monkeypatch.setattr(pp.back_end, "optimize",
                        lambda *a, **k: solves.append(k) or fake)
    monkeypatch.setattr(pl, "_nudge_waypoints", lambda x, *a, **k: x)
    cert_pts = np.array([[12.0, 7.5]])

    def certify(seq):
        it = iter(seq)
        return lambda traj: (cert_pts, np.array([next(it)]))

    def attempt():
        solves.clear()
        return pl._attempt(START, GOAL, None, 1, 1, certify_rounds=0,
                           max_active_add=8)

    monkeypatch.setattr(pl, "certify", certify([-0.05, -0.02, 0.1]))
    res = attempt()
    assert res.certified and res.min_cert_sdf == 0.1
    assert len(solves) == 3              # initial + 2 extension rounds
    # the re-solves escalate the weight and the margin, on (0.1, 0.01)
    assert solves[1]["weight_p"] == 4.0 * pl.config.weight_p
    assert solves[2]["safety_hor"] == pl.config.safety_hor + 0.1 + 0.1
    assert solves[1]["mu_schedule"] == (0.1, 0.01)
    monkeypatch.setattr(pl, "certify", certify([-0.5, -0.4]))
    res = attempt()
    assert not res.certified and res.min_cert_sdf == -0.5
    assert len(solves) == 1              # only the initial solve
    monkeypatch.setattr(pl, "certify", certify([-0.05] * 5))
    res = attempt()
    assert not res.certified and res.min_cert_sdf == -0.05
    assert len(solves) == 4              # initial + 3 capped extensions


def test_failed_attempt_does_not_gate_later_rungs():
    """A failed front end mid-ladder must not skip the conservative
    rung, which plans on the unblocked map."""
    pl = _planner(use_transition_check=False, fine_yaw_factor=0)
    failed = PlanResult(False, None, None, np.zeros((2, 3)),
                        np.zeros((0, 3)), float("nan"), float("nan"))
    seq = iter([_fake_result(min_cert_sdf=-0.4),
                _fake_result(min_cert_sdf=-0.4), failed,
                _fake_result(certified=True, min_cert_sdf=0.5,
                             final_cost=2.0)])
    seen = []

    def fake_attempt(*a, **k):
        seen.append(bool(k.get("conservative", False)))
        return next(seq)

    pl._attempt = fake_attempt
    pl._last_cert = (np.array([[12.0, 7.5]]), np.array([-0.4]))
    out = pl.plan(START, GOAL, certify_retries=3)
    assert out.certified and out.min_cert_sdf == 0.5
    assert seen == [False, False, False, True]  # conservative reached
    assert out.timings["attempts"] == 4


def test_nudge_waypoints_moves_near_waypoints_away():
    """The nudge shifts the waypoints near the violated voxel along
    -grad (away from it), with a Gaussian falloff."""
    pl = _planner(use_transition_check=False, fine_yaw_factor=0)
    n = 4
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)[None]
    head = t([[0.0, 0.0, 0.0], [0.0] * 3, [0.0] * 3])
    tail = t([[12.0, 0.0, 0.0], [0.0] * 3, [0.0] * 3])
    wps = np.asarray([[3.0, 0.0, 0.0], [6.0, 0.0, 0.0], [9.0, 0.0, 0.0]])
    traj = minco.solve(torch.full((1, n), 1.5, dtype=torch.float64), head,
                       tail, t(wps))
    x = np.concatenate([np.zeros(n), wps.ravel()])
    out = pl._nudge_waypoints(x, traj, np.array([6.0, 0.5]), push=0.3, n=n)
    wps_out = out[n:].reshape(n - 1, 3)
    assert wps_out[1, 1] < -0.2          # near waypoint pushed away
    assert abs(wps_out[1, 0] - 6.0) < 0.1  # mostly lateral
    assert abs(wps_out[0, 1]) < abs(wps_out[1, 1])
    assert abs(wps_out[2, 1]) < abs(wps_out[1, 1])
    np.testing.assert_array_equal(out[:n], np.zeros(n))
    assert x[n + 4] == 0.0               # input not mutated


def test_pad_obstacles_and_solver_check():
    pl = _planner(use_transition_check=False, fine_yaw_factor=0)
    padded = pl._pad_obstacles(np.zeros((3, 3)), bucket=8)
    assert padded.shape == (8, 3) and np.all(padded[3:, 0] > 1e3)
    assert pl._pad_obstacles(np.zeros((1, 3)), bucket=8).shape == (8, 3)
    fields, pts = corridor()
    with pytest.raises(ValueError, match="unknown back-end solver"):
        Planner(PlannerConfig(**fields), pts, solver="bundle", device="cpu")
    assert pl.guard_ladder == [None]
    assert _planner().guard_ladder == [
        (dataclasses.asdict(PlannerConfig(**fields))["kernel_size"] // 2
         + 2) * 1.0, 4.0, 2.0]
