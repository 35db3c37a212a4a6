"""Structured profiling (svsdf_tpu/utils/profiling.py) — the reference's
ad-hoc chrono accumulators (SURVEY.md §5: A* per-expansion timing
`front_end_Astar.hpp:65-67`, back-end
`total_opt_time/total_sdf_time/total_AABB_time`
`back_end_optimizer.hpp:31-33`) replaced with a device-aware toolkit:

  * `stage(name)` — wall-clock context manager that records into the
    module Profile and (optionally) opens a
    `torch.profiler.record_function` range so the stage shows up in
    profiler traces.
  * `device_trace(logdir)` — a `torch.profiler.profile` of a region (CPU
    and, with a card, CUDA activity), written as a Chrome trace into
    `logdir` (TensorBoard or Perfetto open it).
  * `timed(fn)` — decorator variant of `stage`.
  * `Profile.report()` — per-stage count/total/mean table.

Device timings are honest only when the stage waits for the device:
pass the output to `stage(...).block(out)`, which synchronizes the CUDA
device of every tensor in it, since a launch returns at enqueue time.
"""

from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict
from typing import Any, Dict, Optional

import torch


class Profile:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def add(self, name: str, seconds: float):
        self.totals[name] += seconds
        self.counts[name] += 1

    def report(self) -> str:
        rows = ["stage                          count   total_ms    mean_ms"]
        for name in sorted(self.totals, key=lambda k: -self.totals[k]):
            tot = self.totals[name] * 1e3
            n = self.counts[name]
            rows.append(f"{name:<30} {n:>5} {tot:>10.2f} {tot / n:>10.3f}")
        return "\n".join(rows)

    def clear(self):
        self.totals.clear()
        self.counts.clear()


#: module-level profile, like the reference's global accumulators
PROFILE = Profile()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _block(x):
    """Wait for the CUDA device of every tensor in x (nested tuples,
    lists, dicts and NamedTuples)."""
    for dev in {t.device for t in _tensors(x) if t.is_cuda}:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def stage(name: str, profile: Optional[Profile] = None,
          annotate: bool = True):
    """Time a stage around launches and the wait for their result:

    with profiling.stage("back_end") as s:
        out = plan(...)
        s.block(out)        # count until the device result is real
    """
    prof = profile if profile is not None else PROFILE

    class _Handle:
        def block(self, x):
            _block(x)

    ctx = (torch.profiler.record_function(name) if annotate
           else contextlib.nullcontext())
    t0 = time.perf_counter()
    try:
        with ctx:
            yield _Handle()
    finally:
        prof.add(name, time.perf_counter() - t0)


def timed(name: Optional[str] = None,
          profile: Optional[Profile] = None):
    """Decorator: time each call, blocking on the returned tensors."""
    def deco(fn):
        sname = name or fn.__name__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with stage(sname, profile=profile) as s:
                out = fn(*a, **kw)
                s.block(out)
            return out

        return wrapper

    return deco


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile a region (CPU, and CUDA where a card is present) and
    write its Chrome trace into ``logdir`` (the structured replacement
    for printf timing; SURVEY.md §5). Yields the profiler, whose
    ``key_averages()`` the caller may read after the block."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                logdir)) as prof:
        yield prof


def bench_fn(fn, *args, reps: int = 5, warmup: int = 1,
             perturb=None) -> Dict[str, Any]:
    """Honest microbenchmark: per-rep unique inputs and a wait for the
    device closing the timer. perturb: fn(args, i) -> args for rep i;
    default adds 1e-5*(i+1) to the first argument."""

    def default_perturb(a, i):
        return (torch.as_tensor(a[0]) + 1e-5 * (i + 1),) + tuple(a[1:])

    perturb = perturb or default_perturb
    out = fn(*args)
    _block(out)
    for _ in range(warmup):
        out = fn(*perturb(args, 997))
        _block(out)
    times = []
    for i in range(reps):
        a = perturb(args, i)
        t0 = time.perf_counter()
        out = fn(*a)
        _block(out)
        times.append(time.perf_counter() - t0)
    times.sort()
    return {"median_s": times[len(times) // 2], "min_s": times[0],
            "mean_s": sum(times) / len(times), "reps": reps}
