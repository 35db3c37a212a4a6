"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell
asks for. The cell is an entry of ``workloads`` in BENCHMARK.json; its
configuration, traffic, limits and per-layer readers are files found by
name (``configs/``, ``traffic/``, ``limits/``, ``metrics/``).

A configuration's robot is an analytic body of its own file
(``bodies/<name>.py``, found by the name its ``robot.body`` gives) or a
mesh, and may breathe (``robot.scale``); reference.py says how.

A run: set-up (the program's robot and planner, one warm-up request at
the cell's sizes, which builds every kernel); the measured window, a
closed loop with one client, each request drawn from (seed, index) and
its answer read back to the host before the next goes out; with
``--trace 1`` one more request under the profiler and the per-layer
readers; then the check of sampled answers against the plain reference.
The last line of standard output is the result as one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error and the result's last key.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import NamedTuple  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: build and kernel caches: fixed directories inside the checkout
BUILD = os.path.join(ROOT, "build")
#: host threads: fixed, so that a run does not depend on the machine's
#: core count
THREADS = 1
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = str(THREADS)
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BUILD, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(BUILD, "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(BUILD, "cuda_cache")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import entries, trace  # noqa: E402

#: top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "svsdf_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_files(name: str) -> tuple[dict, dict, dict, dict, dict]:
    """(manifest, workload, configuration, traffic, limits) of a cell."""
    manifest = load_json(ROOT, "BENCHMARK.json")
    wl = {w["name"]: w for w in manifest["workloads"]}.get(name)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = {c["name"]: c for c in manifest["configs"]}[wl["config"]]
    cfg = dict(load_json(ROOT, cfg_entry["file"]), name=wl["config"])
    traffic = load_json(HERE, "traffic", f"{wl['traffic']}.json")
    limits = load_json(HERE, "limits", f"{name}.json")
    return manifest, wl, cfg, traffic, limits


def rng_for(seed: int, *index) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, *index]))


def reader(metric: str):
    """The per-layer metric's reader, ``read(ctx) -> float | None``: the
    reader of its kind, ``metrics/<name before the first dot>.py``; the
    manifest's ``workloads`` say in which cells it reads."""
    kind = metric.split(".")[0]
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{kind}", os.path.join(HERE, "metrics",
                                                  f"{kind}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def smi() -> str:
    """The card's name, clocks, power draw and power limit."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.mem,"
             "power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable: {e}"
    return out.stdout.strip().replace("\n", " | ")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Cell(NamedTuple):
    """A cell set up in this process: its files and the program's entry."""
    name: str
    manifest: dict
    workload: dict
    traffic: dict
    limits: dict
    dev: torch.device
    entry: object


def setup(workload: str, seed: int, device: str = "cuda",
          overrides: dict | None = None) -> Cell:
    """The cell's set-up: the program's robot and planner, and warm-up
    requests at the cell's sizes (every kernel built and loaded).
    ``overrides`` replaces traffic keys (tests and calibration runs)."""
    manifest, wl, cfg, traffic, limits = cell_files(workload)
    traffic = dict(traffic, **(overrides or {}))
    dev = torch.device(device)
    torch.set_num_threads(THREADS)
    obj = entries.robot_obj(cfg, os.path.join(BUILD, "benchmark"))
    entry = entries.ENTRIES[traffic["entry"]](cfg, traffic, dev, obj)
    for w in range(traffic["warmup"]):
        entry.call(entry.draw(rng_for(seed, 1, w)))
    _sync(dev)
    return Cell(workload, manifest, wl, traffic, limits, dev, entry)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def window(cell: Cell, seed: int, seconds: float) -> dict:
    """The measured window: a closed loop with one client. Request i is
    drawn from (seed, 0, i) and its answer read back before the next goes
    out; the answers of the requests that finished within ``seconds``
    count, over the time to the last of them."""
    e = cell.entry
    answers, work, attempted, failed = [], 0, 0, 0
    t0 = time.perf_counter()
    t_last = t0
    while True:
        ans = e.call(e.draw(rng_for(seed, 0, len(answers))))
        t = time.perf_counter()
        if t - t0 > seconds:
            break
        answers.append(ans)
        work += e.count(ans)
        attempted += e.attempted(ans)
        failed += e.failed(ans)
        t_last = t
    return {"answers": answers, "work": work, "attempted": attempted,
            "failed": failed,
            "window_s": t_last - t0, "t0": t0}


def traced_metrics(cell: Cell, seed: int) -> tuple[dict, dict, dict]:
    """(per-layer metrics, device busy and window seconds, breakdown) of
    the traced span: ``trace_requests`` more requests under the profiler."""
    e, cuda = cell.entry, cell.dev.type == "cuda"
    extra = (e.beside_trace(rng_for(seed, 2), lambda: _sync(cell.dev))
             if hasattr(e, "beside_trace") else {})
    launches: list = []
    reqs = [e.draw(rng_for(seed, 3, i))
            for i in range(cell.traffic["trace_requests"])]
    with trace.scan_launches(launches):
        outs, tr = trace.traced(lambda: [e.call(r) for r in reqs], cuda)
    ctx = trace.Context(cell.traffic["entry"], sum(map(e.count, outs)), tr,
                        launches, outs[-1], extra)
    metrics = {}
    for m in cell.manifest["per_layer"]:
        if _applies(m, cell.name):
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    busy = trace.busy_intervals(tr.device)
    return (metrics, {"busy_s": float((busy[:, 1] - busy[:, 0]).sum()),
                      "window_s": tr.span_s}, trace.breakdown(tr))


def check(cell: Cell, seed: int, answers: list, control: bool = False):
    """The numbers compared for the answers sampled with (seed, 4)."""
    e = cell.entry
    if cell.dev.type == "cuda":
        torch.cuda.empty_cache()
    rows = entries.sample_rows([e.rows(a) for a in answers],
                               cell.traffic["check_samples"],
                               rng_for(seed, 4), whole=e.whole)
    reqs = {i: e.draw(rng_for(seed, 0, i)) for i in {r[0] for r in rows}}
    return e.check(reqs, answers, rows, cell.dev, control=control)


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", overrides: dict | None = None) -> dict:
    """One run of a cell; returns the result object."""
    cell = setup(workload, seed, device, overrides)
    w = window(cell, seed, seconds)
    setup_s = w["t0"] - T_START
    cuda = cell.dev.type == "cuda"
    peak = torch.cuda.max_memory_allocated(cell.dev) if cuda else 0
    result = {"correct": False, "attempted": w["attempted"],
              "failed": w["failed"]}
    dev_info = {}
    if traced:
        result["metrics"], dev_info, breakdown = traced_metrics(cell, seed)
    else:
        e2e = {"setup_s": setup_s, cell.traffic["rate_metric"]:
               w["work"] / w["window_s"] if w["window_s"] else 0.0}
        result["metrics"] = {
            m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
            for m in cell.manifest["end_to_end"] if _applies(m, workload)}
    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(cell.dev) if cuda else "cpu",
        "count": cell.workload["chips"], "memory_peak_bytes": peak,
        **dev_info}
    if traced:
        result["breakdown"] = breakdown
    numbers = check(cell, seed, w["answers"]) if w["answers"] else {}
    checks = {k: {"value": numbers.get(k), "limit": lim}
              for k, lim in cell.limits.items()}
    result["correct"] = bool(w["answers"]) and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _, wl, *_ = cell_files(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"needs {wl['chips']} CUDA device(s); have "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"# card: {smi()}", flush=True)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    print(f"# card: {smi()}", flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
