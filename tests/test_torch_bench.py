"""The port's benchmark entry point, ``svsdf_tpu_torch/bench.py``, on the host.

  * parity: the ``plans`` section's core (``bench_plans``) at B=4 on short
    stages (``default_stages(10, scan_dtype=None)``), float64, against the
    JAX package's ``plan_batch_staged`` on the same ``problem`` seeds and
    the same perturbed warm start, both re-scored on
    scripts/perf_sweep.py::hifi_cost's functional: the median cost within
    1e-8 relative, the median certificate within 1e-6 m. The certificate
    is looser because it is a minimum over interior points, whose GSIP
    solve at the functional's 8 iterations differs from JAX's by up to
    2.7e-8 m on the same trajectory (tests/test_torch_svsdf.py holds it at
    1e-8 at 3 iterations), and because the two solves' x differ by up to
    1.8e-7 at B=4 (measured), which the minimum follows at first order;
  * the re-score's config is perf_sweep.py's, field by field (read from
    its source: importing the script would set up JAX's compile cache);
  * the harness with ``--device cpu``, tiny budgets and a child whose
    sections are stand-ins (``replan_map`` stays the real one): a section
    that raises or overruns its budget reports no metric, only its error,
    and the others still run; when the total budget runs out during a
    section, the sections still pending report that they did not run; the
    partial headline prints before the final one; the exit code is not 0
    when ``plans`` failed; ``_headline``'s keys and types; ``replan_map``
    without the reference's fixture; ``main`` and the profiled section
    refuse to run without a card unless asked for the host.
"""

import ast
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svsdf_tpu.models import shapes as jshapes
from svsdf_tpu.ops.svsdf import SVSDFConfig as JSVSDFConfig
from svsdf_tpu.ops.svsdf import svsdf_query as jsvsdf_query
from svsdf_tpu.parallel import batch as jbatch
from svsdf_tpu.planner import back_end as jback_end
from svsdf_tpu.utils.config import PlannerConfig as JPlannerConfig
from svsdf_tpu_torch import bench
from svsdf_tpu_torch.bench import BENCH_MEM_SIZE, problem

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
B, N, M, ITERS = 4, 8, 64, 10


def _hifi_kwargs() -> dict:
    """The keyword arguments of the SVSDFConfig that
    scripts/perf_sweep.py::hifi_cost builds."""
    tree = ast.parse((ROOT / "scripts" / "perf_sweep.py").read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "hifi_cost")
    call = next(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "SVSDFConfig")
    return {k.arg: ast.literal_eval(k.value) for k in call.keywords}


def test_hifi_config_is_perf_sweeps():
    kw = _hifi_kwargs()
    assert kw == {"coarse_n": 256, "refine_rounds": 3, "gsip_iters": 8,
                  "gsip_coarse_n": 96, "gsip_refine_rounds": 1}
    ref = JSVSDFConfig(**kw)
    for f in dataclasses.fields(ref):
        assert getattr(bench.HIFI, f.name) == getattr(ref, f.name), f.name


def test_bench_plans_matches_jax():
    res = bench.bench_plans(n_pieces=N, n_obs=M, iters=ITERS,
                            scan_dtype=None, batches=(B,), device="cpu",
                            dtype=torch.float64)
    assert res["plan_batch_size"] == B and len(res["wall_s"]) == 3
    assert res["scan_dtype"] == "float32"
    assert "device_busy_share" not in res      # no device on the host

    # the JAX side at the last timed run's input: x0 + its perturbation
    h, t, o, x0 = (a.astype(np.float64) for a in problem(N, M, B))
    rng = np.random.default_rng(1)
    for _ in range(3):
        d = rng.uniform(-1e-3, 1e-3, x0.shape).astype(np.float32)
    shape = jshapes.make_shape("sdHeart")
    cfg = JPlannerConfig(mem_size=BENCH_MEM_SIZE)
    probs = jback_end.BackEndProblem(jnp.asarray(h), jnp.asarray(t),
                                     jnp.asarray(o))
    jres = jbatch.plan_batch_staged(
        shape, jnp.asarray(x0 + d), probs, cfg,
        jbatch.default_stages(ITERS, scan_dtype=None), N)
    hifi = JSVSDFConfig(**_hifi_kwargs())

    def one(x, hh, tt, ob):
        return jback_end.make_cost_fn(
            shape, jback_end.BackEndProblem(hh, tt, ob), cfg, hifi, N)(x)

    cost = jax.jit(jax.vmap(one))(jres.opt_x, probs.head, probs.tail,
                                   probs.obstacles)
    cert = jax.jit(jax.vmap(lambda tr, ob: jsvsdf_query(
        shape, tr, ob, hifi).sdf.min()))(jres.traj, probs.obstacles)
    np.testing.assert_allclose(res["median_cost"],
                               float(np.median(np.asarray(cost))), rtol=1e-8)
    # measured 5.0e-8 m apart (see the module's docstring)
    np.testing.assert_allclose(res["median_cert_min"],
                               float(np.median(np.asarray(cert))), atol=1e-6,
                               rtol=0)


# -- the harness --------------------------------------------------------

#: a child process: the real bench module with stand-in sections, chosen
#: by name from argv[1] (a JSON map section -> behaviour); replan_map and
#: every section not named stay the real ones
_FAKE_CHILD = r"""
import json, sys, time
from svsdf_tpu_torch import bench

PLANS = {"plans_per_s": 12.5, "plan_batch_wall_s": 0.32,
         "plan_batch_size": 4, "median_cost": 2700.5,
         "median_cert_min": -2.25, "median_final_cost": 2650.25,
         "scan_dtype": "bfloat16"}
METRICS = {"plans": PLANS, "grid": {"queries_per_s": 1000.5,
                                    "grid_batch_s": 0.5},
           "e2e": {"e2e_per_s": 8.5, "e2e_ok": 1.0,
                   "front_end_share": 0.125},
           "replan": {"backend_solve_p50_s": 0.25,
                      "backend_solve_p90_s": 0.5,
                      "backend_solve_finite_share": 1.0,
                      "backend_solve_cert_median": -2.0},
           "plans_profile": {"device_busy_share": 0.125}}


def stand_in(name, how):
    def section(device):
        assert device == "cpu"
        if how == "raise":
            raise ValueError(f"{name} stand-in failed")
        if how == "hang":
            time.sleep(600)
        return dict(METRICS[name])
    return section


for name, how in json.loads(sys.argv[1]).items():
    bench._SECTIONS[name] = stand_in(name, how)
sys.exit(bench.main(sys.argv[2:]))
"""

_OK = {"plans": "ok", "grid": "ok", "e2e": "ok", "replan": "ok",
       "plans_profile": "ok"}


@pytest.mark.parametrize("failing, how, budget_s, errors", [
    ("grid", "raise", 240, {"grid": "stand-in failed"}),
    ("grid", "hang", 240, {"grid": "killed: past its budget of 4 s"}),
    ("plans", "raise", 240, {"plans": "stand-in failed"}),
    # the total budget runs out while grid hangs: grid is killed, and the
    # sections still pending report that they did not run
    ("grid", "hang", 15, {"grid": "the total budget BENCH_BUDGET_S expired",
                          "e2e": "not run: the total budget",
                          "replan": "not run: the total budget",
                          "plans_profile": "not run: the total budget"}),
], ids=["raises", "overruns", "plans_fails", "total_budget_expires"])
def test_failed_section_reports_no_metric_and_the_rest_run(
        failing, how, budget_s, errors, monkeypatch, tmp_path, capsys):
    behaviour = dict(_OK, **{failing: how})
    monkeypatch.setattr(bench, "_child_argv", lambda device: [
        sys.executable, "-c", _FAKE_CHILD, json.dumps(behaviour),
        "--device", device])
    monkeypatch.setattr(bench, "_BUDGETS", {"plans": 60, "grid": 4,
                                            "e2e": 60, "replan": 60,
                                            "replan_map": 60,
                                            "plans_profile": 60})
    if budget_s < 60:                  # grid outlives the total budget
        monkeypatch.setitem(bench._BUDGETS, "grid", 600)
        monkeypatch.setattr(bench, "_RESTART_MARGIN_S", 1)
    monkeypatch.setenv("BENCH_BUDGET_S", str(budget_s))
    monkeypatch.setenv("SVSDF_REFERENCE_ROOT", str(tmp_path))
    rc = bench.main(["--device", "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["extra"]["partial"] for ln in lines] == [True, False]
    head = lines[-1]
    got = head["extra"]["section_errors"]
    # replan_map reports its own error when it runs, "not run" otherwise
    assert set(got) == set(errors) | {"replan_map"}
    for name, why in errors.items():
        assert why in got[name], (name, got[name])
    assert ("sdHeart fixture" in got["replan_map"] if budget_s >= 60
            else "not run" in got["replan_map"])
    metric = {"plans": head["value"],
              "grid": head["extra"]["svsdf_grid_queries_per_s"],
              "e2e": head["extra"]["e2e_plans_per_s"],
              "replan": head["extra"]["backend_solve_p50_ms"],
              "plans_profile": head["extra"]["device_busy_share"]}
    assert metric == dict({"plans": 12.5, "grid": 1000.5, "e2e": 8.5,
                           "replan": 250.0, "plans_profile": 0.125},
                          **{name: None for name in errors})
    assert head["extra"]["replan_latency_p50_ms"] is None
    assert rc == (1 if failing == "plans" else 0)


def test_headline_keys_and_types():
    res = {"plans": {"plans_per_s": 12.5, "plan_batch_wall_s": 0.32,
                     "plan_batch_size": 4, "median_cost": 2700.5,
                     "median_cert_min": -2.25, "median_final_cost": 2650.25,
                     "backend": "cuda",
                     "device": "NVIDIA H100 80GB HBM3, 700.00 W",
                     "scan_dtype": "bfloat16"},
           "grid": {"queries_per_s": 1000.5, "grid_batch_s": 0.5},
           "replan_map": {"error": "FileNotFoundError: no map"},
           "plans_profile": {"device_busy_share": 0.125}}
    head = json.loads(bench._headline(res, partial=True))
    assert set(head) == {"metric", "value", "unit", "vs_baseline",
                         "baseline_definition", "extra"}
    assert head["metric"] == "batched_svsdf_plans_per_s_per_gpu"
    assert head["unit"] == "plans/s" and head["value"] == 12.5
    assert head["vs_baseline"] is None
    assert "TPU" in head["baseline_definition"]
    extra = head["extra"]
    assert set(extra) == {
        "e2e_plans_per_s", "e2e_frontend_success_rate",
        "e2e_front_end_share", "replan_latency_p50_ms",
        "replan_cert_median", "replan_drift", "backend_solve_p50_ms",
        "backend_solve_p90_ms", "backend_solve_finite_share",
        "backend_solve_cert_median", "svsdf_grid_queries_per_s",
        "grid_query_batch_ms", "plan_batch_wall_s", "plan_batch_size",
        "median_cost", "median_cert_min", "median_final_cost",
        "achieved_gflops", "pct_vpu_peak", "pct_hbm_peak",
        "arithmetic_intensity", "device_busy_share", "backend", "device",
        "scan_dtype", "section_errors", "partial"}
    for key in ("achieved_gflops", "pct_vpu_peak", "pct_hbm_peak",
                "arithmetic_intensity", "e2e_plans_per_s",
                "backend_solve_p50_ms", "replan_latency_p50_ms"):
        assert extra[key] is None, key
    assert extra["partial"] is True
    assert extra["plan_batch_size"] == 4
    assert extra["median_cost"] == 2700.5
    assert extra["median_cert_min"] == -2.25
    assert extra["median_final_cost"] == 2650.25
    assert extra["device_busy_share"] == 0.125
    assert extra["svsdf_grid_queries_per_s"] == 1000.5
    assert extra["grid_query_batch_ms"] == 500.0
    assert extra["device"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert extra["scan_dtype"] == "bfloat16"
    assert extra["section_errors"] == {
        "replan_map": "FileNotFoundError: no map"}
    # nothing landed yet: every number null, the layout the same
    empty = json.loads(bench._headline({}, partial=False))
    assert empty["value"] is None and set(empty) == set(head)
    assert set(empty["extra"]) == set(extra)
    assert empty["extra"]["partial"] is False


def test_replan_map_without_the_fixture_reports_its_error(capsys):
    bench._child(["replan_map"], "cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "#START replan_map"
    tag, name, payload = out[-1].split(" ", 2)
    assert (tag, name) == ("#RESULT", "replan_map")
    entry = json.loads(payload)
    assert set(entry) == {"error", "section_wall_s"}
    assert entry["error"].startswith("FileNotFoundError")
    assert "sdHeart fixture" in entry["error"]


def test_main_needs_a_card_unless_asked_for_the_host(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--sections", "plans"], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            bench.main(argv)


def test_plans_profile_needs_the_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.bench_plans_profile(device="cpu")
