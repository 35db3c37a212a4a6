"""Every cell end to end through the harness on the host; the check's
control and planted faults of the timed path, each of which has to come
out not correct.

A card is not needed: the harness's set-up, requests and check run on
the CPU (``device="cpu"``), where the program takes the coarse scan's
plain version. Two sizes: ``TINY`` for the run's plumbing and the faults
that one plan shows, and ``SAMPLED`` for the sound answers, the control
and the optimizer's faults, since ``cost_left`` is a mean over the
sampled plans (sd about 0.1 a plan; its limits hold the card's 2048
staged and 256 forest plans) and means over a few plans stray past it.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from benchmark import faults, run
from svsdf_tpu_torch.ops import svsdf as svsdf_mod

SEED = 2 ** 31 + 12345
#: tiny sizes: every answer of the requests made is in the sample
TINY = {
    "sdHeart.staged-large": {"batch": 3, "check_samples": 64},
    "heart-prism.grid-field": {"points": 24, "check_samples": 8,
                               "trace_requests": 2},
    "heart-prism.forest-large": {"batch": 3, "check_samples": 64},
}
#: one request whose every plan is in the sample: enough plans for
#: cost_left's mean (a standard error of 0.0044 and 0.006)
SAMPLED = dict(TINY, **{
    "sdHeart.staged-large": {"batch": 512, "check_samples": 512},
    "heart-prism.forest-large": {"batch": 256, "check_samples": 256},
})
REQUESTS = {"sdHeart.staged-large": 1, "heart-prism.grid-field": 2,
            "heart-prism.forest-large": 1,
            "sdRhombus-breathing.staged-large": 1}


def _correct(cell, numbers) -> bool:
    return all(numbers[k] <= lim for k, lim in cell.limits.items())


def _answers(cell, n=2):
    e = cell.entry
    return [e.call(e.draw(run.rng_for(SEED, 0, i))) for i in range(n)]


_SAMPLED: dict = {}


def _sampled(name: str):
    """A cell at its ``SAMPLED`` size and its sound answers, made once."""
    if name not in _SAMPLED:
        cell = run.setup(name, SEED, "cpu", dict(SAMPLED[name], warmup=0))
        _SAMPLED[name] = cell, _answers(cell, REQUESTS[name])
    return _SAMPLED[name]


@pytest.fixture(params=sorted(TINY))
def sampled(request):
    return _sampled(request.param)


@pytest.mark.parametrize("workload,traced", [
    ("sdHeart.staged-large", False), ("heart-prism.grid-field", True),
    ("heart-prism.forest-large", True)])
def test_run_prints_the_contract_line(workload, traced):
    # a window that holds a few of the tiny requests on a loaded host
    res = run.run_cell(workload, SEED, 10.0, traced, device="cpu",
                       overrides=TINY[workload])
    line = json.loads(json.dumps(res))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    checks = line["checks"]
    assert set(checks) == set(run.cell_files(workload)[4])
    assert line["correct"] is all(c["value"] <= c["limit"]
                                  for c in checks.values())
    # every number but a mean over these few plans holds its limit
    # (test_sound_answers_are_correct holds them all at SAMPLED sizes)
    assert all(c["value"] <= c["limit"] for k, c in checks.items()
               if k != "cost_left"), checks
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(line["device"])
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in line["metrics"]
        assert len(line["metrics"]) == 2


def test_sound_answers_are_correct(sampled):
    cell, answers = sampled
    numbers = run.check(cell, SEED, answers)
    assert _correct(cell, numbers), numbers


def test_the_control_is_not_correct(sampled):
    cell, answers = sampled
    numbers = run.check(cell, SEED, answers, control=True)
    assert not _correct(cell, numbers), numbers


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "sdHeart.staged-large", "--seed", "1",
                   "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


# ---------------------------------------------------------------------------
# planted faults: the timed path broken underneath
# ---------------------------------------------------------------------------

#: faults one plan shows, each with the number that has to find it
PLAN_FAULTS = {"unchanged": "unsolved_share", "half": "unsolved_share",
               "sdf_shifted": "cost_gap_rel.q90",
               "cost_altered": "cost_gap_rel.q90",
               "trajectory_altered": "traj_gap_m"}


@pytest.fixture(scope="module", params=["sdHeart.staged-large",
                                        "heart-prism.forest-large"])
def plan_cell(request):
    return run.setup(request.param, SEED, "cpu", TINY[request.param])


def _found_by(cell, fault: str, number: str) -> dict:
    with faults.plant(fault):
        answers = _answers(cell, REQUESTS[cell.name])
    numbers = run.check(cell, SEED, answers)
    assert numbers[number] > cell.limits[number], (fault, numbers)
    assert not _correct(cell, numbers)
    return numbers


@pytest.mark.parametrize("fault", sorted(PLAN_FAULTS))
def test_plan_faults_are_not_correct(plan_cell, fault):
    _found_by(plan_cell, fault, PLAN_FAULTS[fault])


@pytest.mark.parametrize("workload", ["sdHeart.staged-large",
                                      "heart-prism.forest-large"])
def test_a_misdirected_optimizer_is_not_correct(workload):
    """The L-BFGS direction replaced by the gradient: every answer is
    consistent, and cost_left finds that it optimizes less. (Halved
    iterations read closer to the limit than a few hundred plans can
    tell apart; PERF.md gives their readings at the cells' sizes.)"""
    cell, _ = _sampled(workload)
    _found_by(cell, "steepest_descent", "cost_left")


@pytest.mark.parametrize("fault,number", [
    ("certificate_altered", "cert_gap_m"),
    ("route_altered", "front_end_mismatches")])
def test_forest_faults_are_not_correct(fault, number):
    cell = run.setup("heart-prism.forest-large", SEED, "cpu",
                     TINY["heart-prism.forest-large"])
    _found_by(cell, fault, number)


def _grid_fault(kind):
    query = svsdf_mod.svsdf_query
    last = {}

    def broken(shape, traj, pts, *a, **k):
        r = query(shape, traj, pts, *a, **k)
        sdf = r.sdf
        if kind == "unchanged":
            sdf = last.setdefault("sdf", sdf)
        elif kind == "half":
            sdf = sdf.clone()
            sdf[:, sdf.shape[1] // 2:] = 0.0
        else:
            sdf = sdf + 1e-3
        return r._replace(sdf=sdf)
    return broken


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_grid_faults_are_not_correct(fault, monkeypatch):
    cell = run.setup("heart-prism.grid-field", SEED, "cpu",
                     TINY["heart-prism.grid-field"])
    monkeypatch.setattr(svsdf_mod, "svsdf_query", _grid_fault(fault))
    numbers = run.check(cell, SEED, _answers(cell, 3))
    assert not _correct(cell, numbers), numbers
    assert np.isfinite(numbers["field_gap_m"])


# ---------------------------------------------------------------------------
# a robot added with data alone
# ---------------------------------------------------------------------------

#: a breathing sdRhombus (utils/fixtures.py's deformable_rhombus) under
#: the staged traffic, as a configuration would add it: its own files
#: beside copies of the harness's, in a checkout of its own
BREATHING = {"body": "sdRhombus", "scale": {
    "schedule": "breathing", "amp": 0.2, "rate": 0.8, "kernel_scale": 1.2}}
#: for this test only: the staged cell's limits, with cost_left at "the
#: optimizer lowered the cost" (the cell's own limits are calibrated on
#: the card when a configuration adds it)
BREATHING_LIMITS = {"traj_gap_m": 0.02, "cost_gap_rel.q90": 2e-5,
                    "cost_left": 1.0, "unsolved_share": 5.0}


def _checkout_with(tmp_path, monkeypatch, name: str, robot: dict) -> str:
    """A checkout under tmp_path holding the harness's data files and a
    configuration ``name`` of ``robot`` with a staged cell: the cell's
    name. The harness reads it from there."""
    root = tmp_path / "checkout"
    bench = root / "benchmark"
    for d in ("traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(run.HERE, d), bench / d)
    manifest = run.load_json(run.ROOT, "BENCHMARK.json")
    cfg = dict(run.load_json(run.HERE, "configs", "sdHeart.json"),
               robot=robot)
    cell = f"{name}.staged-large"
    (bench / "configs").mkdir()
    (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    (bench / "limits" / f"{cell}.json").write_text(
        json.dumps(BREATHING_LIMITS))
    manifest["configs"].append({
        "name": name, "source": "test", "reduced": [], "why": "test",
        "file": f"benchmark/configs/{name}.json"})
    manifest["workloads"].append({
        "name": cell, "config": name, "traffic": "staged-large",
        "chips": 1, "why": "test"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "sdHeart.staged-large" in m.get("workloads", []):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    monkeypatch.setattr(run, "ROOT", str(root))
    monkeypatch.setattr(run, "HERE", str(bench))
    return cell


def test_a_breathing_robot_needs_only_data(tmp_path, monkeypatch):
    """The staged entry end to end for the breathing robot: the program's
    ScaledShape and the reference's scaled body, correct; then the plan
    faults, each not correct while the robot breathes."""
    cell = _checkout_with(tmp_path, monkeypatch, "sdRhombus-breathing",
                          BREATHING)
    # 64 plans a request: about 3 in 100 read cost gaps past 2e-5 (a
    # bfloat16 basin of their own), so a tiny request's q90 would not
    # hold; such a request takes about 10 s on the host, and the window
    # holds two or so
    size = {"batch": 64, "check_samples": 64}
    res = run.run_cell(cell, SEED, 25.0, False, device="cpu",
                       overrides=dict(size, warmup=0))
    assert res["correct"], res["checks"]
    c = run.setup(cell, SEED, "cpu", dict(size, warmup=0))
    assert c.entry.shape.time_varying
    for fault, number in sorted(PLAN_FAULTS.items()):
        _found_by(c, fault, number)


def test_an_unknown_body_fails_at_setup(tmp_path, monkeypatch):
    cell = _checkout_with(tmp_path, monkeypatch, "sdNoSuch",
                          {"body": "sdNoSuch"})
    with pytest.raises(ValueError, match=r"bodies/sdNoSuch\.py"):
        run.setup(cell, SEED, "cpu", TINY["sdHeart.staged-large"])
