"""Structured profiling (svsdf_tpu/utils/profiling.py) — the reference's
ad-hoc chrono accumulators (SURVEY.md §5: A* per-expansion timing
`front_end_Astar.hpp:65-67`, back-end
`total_opt_time/total_sdf_time/total_AABB_time`
`back_end_optimizer.hpp:31-33`) replaced with a device-aware toolkit:

  * `span(name)` — a named range in a running profiler session, free
    outside one: the program's layer boundaries.
  * `host_bool(t, site)` — a host read of a device flag inside the span
    `sync.<site>`, so that every host wait of a solve is counted.
  * `stage(name)` — wall-clock context manager that records into the
    module Profile and (optionally) opens a `span` so the stage shows up
    in profiler traces.
  * `device_trace(logdir)` — a `torch.profiler.profile` of a region (CPU
    and, with a card, CUDA activity), written as a Chrome trace into
    `logdir` (TensorBoard or Perfetto open it).
  * `is_device_activity(event)` — whether a profiler event is work the
    device ran (not an annotation drawn on its timeline).
  * `Profile.report()` — per-stage count/total/mean table.

Device timings are honest only when the stage waits for the device:
pass the output to `stage(...).block(out)`, which synchronizes the CUDA
device of every tensor in it, since a launch returns at enqueue time.
"""

from __future__ import annotations

import contextlib
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


#: what ``span`` returns while no profiler session runs: one shared
#: context that does nothing
_NULL_SPAN = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` around a block, while a
    torch.profiler session runs in this thread (an autograd engine thread
    takes its caller's session); otherwise a shared null context: no
    clock, no accumulator, no device sync.

    The range is a host event (the profiler's ``cpu_op``). It is not a
    user annotation: the profiler draws those on the device's timeline
    as well, where readers that take every device row for a kernel would
    count it. A launch made inside the range lies inside it on the
    profiler's clock, which is how the device time of a layer is found
    (the kernel of each launch)."""
    if not torch.autograd._profiler_enabled():
        return _NULL_SPAN
    return torch._C._profiler._RecordFunctionFast(name)


def host_bool(t, site: str) -> bool:
    """``bool(t)`` of a one-element tensor: on a device tensor a host
    wait for the device. Inside a profiler session the read is the span
    ``sync.<site>``, so that the host waits of a solve are counted and
    timed."""
    with span("sync." + site):
        return bool(t)


def is_device_activity(event) -> bool:
    """Whether an event of a finished session's raw trace
    (``prof.profiler.kineto_results.events()``) is work the device ran:
    a kernel, copy or fill. A user annotation (``record_function``) is
    drawn on the device's timeline too and is not."""
    return (event.device_type() == torch.autograd.DeviceType.CUDA
            and not event.is_user_annotation())


@contextlib.contextmanager
def stage(name: str, profile: Optional[Profile] = None,
          annotate: bool = True):
    """Time a stage around launches and the wait for their result:

    with profiling.stage("back_end") as s:
        out = plan(...)
        s.block(out)        # count until the device result is real

    With ``annotate`` the stage is a ``span`` too.
    """
    prof = profile if profile is not None else PROFILE

    class _Handle:
        def block(self, x):
            _block(x)

    ctx = span(name) if annotate else _NULL_SPAN
    t0 = time.perf_counter()
    try:
        with ctx:
            yield _Handle()
    finally:
        prof.add(name, time.perf_counter() - t0)


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
