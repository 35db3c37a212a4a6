#!/usr/bin/env python3
"""Does what a process ran before change the bench's plans reading?

    python3 plans_ab.py [--out FILE]

The bench's ``plans`` section (``svsdf_tpu_torch.bench.plans_run``, B=512,
bfloat16 scans) is run in fresh child processes that differ only in what
ran before it. Each child builds the kernel, runs its case, and reports
the walls of each plans call (``plans_run`` opens no profiler session of
its own). The cases:

  fresh                 plans, plans: a fresh process, then a second call
                        in the same process (the control);
  profiler              SESSIONS torch.profiler sessions first, each over
                        50 launches of the coarse-scan kernel at
                        512x64x96 (chip_smoke.py's ``device_ms``, one
                        session a timed shape as in its phase 3), then
                        plans, plans;
  events                the same kernel launches timed by CUDA events
                        (chip_smoke.py's ``time_ms``, no profiler), then
                        plans, plans;
  fresh_then_profiler   plans, the SESSIONS profiler sessions, plans: the
                        same process before and after.

The children run in turns (the list, then reversed). Prints one JSON line
a child, then a summary line (each case's plans/s by call, the median
over its children) and the card's name and power limit; writes all of it
to ``--out`` as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
#: chip_smoke.py phase 3's profiler sessions (device_ms calls): the
#: eleven path shapes, twelve form rows, two floor rows, six grid-body
#: rows and eighteen bodies
SESSIONS = 49
CASES = ("fresh", "profiler", "events", "fresh_then_profiler")


def child(case: str) -> dict:
    import torch

    import chip_smoke as smoke
    from svsdf_tpu_torch import bench
    from svsdf_tpu_torch.models import shapes
    from svsdf_tpu_torch.ops import cuda_svsdf as cs

    if not torch.cuda.is_available():
        raise RuntimeError("plans_ab.py needs a CUDA card")
    cs.build()
    heart = shapes.make_shape("sdHeart")
    inp = smoke.scan_inputs(torch, 512, 64, 96, seed=99)

    def launches(timer):
        t0 = time.perf_counter()
        for _ in range(SESSIONS):
            timer(torch, lambda: cs.coarse_scan(heart, *inp))
        return time.perf_counter() - t0

    def plans():
        res = bench.plans_run()[0]
        return {k: res[k] for k in ("plans_per_s", "wall_s",
                                    "median_final_cost", "scan_launches")}

    out = {"case": case, "calls": []}
    if case == "profiler":
        out["prefix_s"] = launches(smoke.device_ms)
    elif case == "events":
        out["prefix_s"] = launches(smoke.time_ms)
    out["calls"].append(plans())
    if case == "fresh_then_profiler":
        out["prefix_s"] = launches(smoke.device_ms)
    out["calls"].append(plans())
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", choices=CASES, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "plans_ab.json"))
    args = ap.parse_args()
    if args.case:
        print("#RESULT " + json.dumps(child(args.case)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("plans_ab.py needs a CUDA card")
    from svsdf_tpu_torch.bench import smi_line

    rows = []
    for case in CASES + CASES[::-1]:
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, __file__, "--case", case],
                             capture_output=True, text=True, cwd=ROOT,
                             check=False, timeout=900)
        line = next((ln for ln in run.stdout.splitlines()
                     if ln.startswith("#RESULT ")), None)
        if run.returncode != 0 or line is None:
            sys.stderr.write(run.stderr[-4000:])
            raise RuntimeError(f"case {case} failed ({run.returncode})")
        row = json.loads(line.split(" ", 1)[1])
        row["child_s"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {case: [statistics.median(
        r["calls"][i]["plans_per_s"] for r in rows if r["case"] == case)
        for i in range(2)] for case in CASES}
    costs = {c["median_final_cost"] for r in rows for c in r["calls"]}
    card = smi_line()
    print(json.dumps({"plans_per_s_by_call": summary,
                      "median_final_costs": sorted(costs)}), flush=True)
    print(card, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "sessions": SESSIONS, "rows": rows,
                   "plans_per_s_by_call": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
