"""Readings for the benchmark's limits and for the choice of a cell's
sizes, on the card, in one process:

    python3 -m benchmark.calibrate --workload <name> --seeds 1,2,3 \
        (--seconds <s> | --requests <n>) [--batch B] \
        [--faults f1,f2 --fault-seeds 4,5,6] [--trace 1]

For each seed: a measured window of ``--seconds`` as a run makes it, or
``--requests`` requests drawn as a run draws them, untimed; the numbers
the check compares for the program's sampled answers (the lower readings
of the limits), and the same numbers with the reference at
``Prec.control()`` in the program's place (the upper readings). Then,
for each of ``--faults`` (``faults.plant``) and each of
``--fault-seeds``, the numbers of the program with that fault planted
(upper readings where the control reads none). With ``--trace 1`` the
per-layer metrics of one traced span follow, last (a profiler session
slows every later launch of its process). ``--batch`` sets the traffic's
batch: the sweep that picks it. One JSON line each.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import faults, run


def _requests(cell, seed: int, seconds, requests) -> dict:
    if requests is None:
        return run.window(cell, seed, seconds)
    e = cell.entry
    t0 = time.perf_counter()
    answers = [e.call(e.draw(run.rng_for(seed, 0, i)))
               for i in range(requests)]
    return {"answers": answers, "work": sum(map(e.count, answers)),
            "failed": sum(map(e.failed, answers)),
            "window_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--requests", type=int)
    ap.add_argument("--batch", type=int)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if (args.seconds is None) == (args.requests is None):
        ap.error("give one of --seconds and --requests")
    seeds = [int(s) for s in args.seeds.split(",")]
    over = {} if args.batch is None else {"batch": args.batch}
    cell = run.setup(args.workload, seeds[0], args.device, over)
    cuda = cell.dev.type == "cuda"
    print(json.dumps({"workload": args.workload, "overrides": over,
                      "setup_s": time.perf_counter() - run.T_START,
                      "card": run.smi() if cuda else "cpu"}), flush=True)
    for seed in seeds:
        w = _requests(cell, seed, args.seconds, args.requests)
        peak = torch.cuda.max_memory_allocated(cell.dev) if cuda else 0
        n = len(w["answers"])
        print(json.dumps({
            "seed": seed, "requests": n, "work": w["work"],
            "failed": w["failed"], "window_s": w["window_s"],
            "rate": w["work"] / w["window_s"] if w["window_s"] else None,
            "request_s": w["window_s"] / n if n else None,
            "memory_peak_bytes": peak,
            "program": run.check(cell, seed, w["answers"]) if n else None,
            "control": run.check(cell, seed, w["answers"], control=True)
            if n else None}), flush=True)
    fault_seeds = [int(s) for s in args.fault_seeds.split(",") if s]
    for fault in filter(None, args.faults.split(",")):
        for seed in fault_seeds:
            with faults.plant(fault):
                w = _requests(cell, seed, args.seconds, args.requests)
            print(json.dumps({
                "fault": fault, "seed": seed, "requests": len(w["answers"]),
                "request_s": w["window_s"] / max(1, len(w["answers"])),
                "program": run.check(cell, seed, w["answers"])
                if w["answers"] else None}), flush=True)
    if args.trace:
        metrics, dev_info, breakdown = run.traced_metrics(cell, seeds[-1])
        print(json.dumps({"metrics": metrics, "device": dev_info,
                          "breakdown": breakdown}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
