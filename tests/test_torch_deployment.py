"""chip_smoke.py's phase 15, the deployment loop, rehearsed on the host.

``chip_smoke.deployment_loop`` runs its six steps on ``device="cpu"``
in float32 against the host's float64 run, with every limit it holds on
the card: the synthetic_sdTrapezoid replan and a live back-end solve
under the live dashboard, the wire formats and a checkpoint, the command
stream and the closed-loop flight, a fleet (two lanes here, B=512 on the
card), 16 depth images of the scenario's map and of a second cloud (a
small forest here, phase 7's forest map on the card), and the disk memo
in-process, cold and warm (synthetic_Circle and its first fine-yaw
rung here; the card adds the reference-size sdHeart planner and its two
rungs). A step that misses its limit raises.
"""

import json

import numpy as np
import torch

import chip_smoke
from svsdf_tpu_torch.ops import minco
from svsdf_tpu_torch.planner.online import OnlineReplanner
from svsdf_tpu_torch.utils import fixtures, mapgen
from svsdf_tpu_torch.utils import trajectory as trj

torch.set_num_threads(1)


def test_deployment_loop_on_the_host(tmp_path, monkeypatch):
    monkeypatch.setenv("SVSDF_TORCH_CACHE_DIR", str(tmp_path / "memo"))
    sc = fixtures.synthetic_scenario("sdTrapezoid")
    rp = OnlineReplanner(sc.config, sc.map_points, device="cpu")
    head = torch.zeros(2, 3, 3)
    tail = torch.zeros(2, 3, 3)
    tail[:, 0, 0] = torch.tensor([3.0, 2.0])
    wps = torch.tensor([[[1.0, 0.3, 0.0]], [[1.0, -0.2, 0.1]]])
    fleet = minco.solve(torch.tensor([[0.9, 0.8], [0.7, 0.6]]), head, tail,
                        wps)
    circle = fixtures.synthetic_scenario("Circle")
    forest = mapgen.map_forest(res=1.0, seed=3, n_trees=4, extent=12.0)
    lines = chip_smoke.deployment_loop(
        torch, rp, sc, fleet, ("forest", forest, trj.Trajectory(
            fleet.coeffs[:1], fleet.durations[:1])),
        [("synthetic_Circle", circle.config, circle.map_points, (2,))],
        torch.device("cpu"), str(tmp_path))
    assert list(lines) == ["deploy_plan", "deploy_wire", "deploy_flight",
                           "deploy_fleet", "deploy_sensing", "deploy_memo",
                           "deploy_profile"]
    json.dumps(lines)
    plan, wire = lines["deploy_plan"], lines["deploy_wire"]
    assert plan["success"] and plan["opti_cost_entries"] >= 1
    assert wire["polytraj_bitwise"] and wire["checkpoint_bitwise"]
    flight = lines["deploy_flight"]
    assert flight["ticks"] == 1045 and flight["pos_err_vs_host_m"] <= 1e-4
    assert lines["deploy_fleet"]["flights"] == 2
    sensing = lines["deploy_sensing"]["clouds"]
    assert [c["cloud_points"] for c in sensing] == [len(sc.map_points),
                                                    len(forest)]
    assert all(c["depths_bitwise"] and c["pixels_set"] > 0 for c in sensing)
    memo, = lines["deploy_memo"]["cases"]
    assert memo["warm_bitwise"] and memo["yaw_bins"] == [4, 8]
    assert memo["entries"] == 4
    assert flight["traced_ticks"] == [5, 10]    # no device launches here
    assert (tmp_path / "live.html").exists()
    assert np.isfinite(plan["live_cost"])
