"""The traced span: one request of a cell under torch.profiler, read in
memory (no trace file), and the context the per-layer readers take.

Only a traced run opens a profiler session, and only after its measured
window: a session leaves every later launch of its process slower.
"""

from __future__ import annotations

import contextlib
import re
import time
from typing import NamedTuple

import numpy as np
import torch

#: the user annotation around the traced request
SPAN = "benchmark.span"
#: the coarse-scan kernel's name in the device trace
SCAN_KERNEL = "coarse_scan_kernel"


class Trace(NamedTuple):
    span_s: float            # the traced span's length
    device: list             # (name, start_s, end_s) device activities
    host: list               # (name, start_s, end_s) host events


@contextlib.contextmanager
def scan_launches(record: list):
    """Record (body, B, M, K, bfloat16, deformable, grid bytes) of every
    coarse-scan kernel launch the program makes inside the block, in
    launch order."""
    from svsdf_tpu_torch.ops import cuda_svsdf as cs
    launch = cs._launch

    def recorded(shape, points, xy, cos, sin, scan_dtype=None, ts=None):
        grid = getattr(shape, "grid", None)
        record.append({
            "body": "grid" if grid is not None else shape.name,
            "b": points.shape[0], "m": points.shape[1], "k": xy.shape[1],
            "bf16": cs.scan_type(scan_dtype) == torch.bfloat16,
            "scaled": bool(shape.time_varying),
            "grid_bytes": 0 if grid is None else grid.field.nbytes})
        return launch(shape, points, xy, cos, sin, scan_dtype, ts)

    cs._launch = recorded
    try:
        yield record
    finally:
        cs._launch = launch


def traced(fn, cuda: bool):
    """(fn's result, Trace) of one call of ``fn`` under the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(SPAN):
            out = fn()
    dev_t = torch.autograd.DeviceType.CUDA
    span, device, host = None, [], []
    for e in prof.profiler.kineto_results.events():
        row = (e.name(), e.start_ns() * 1e-9, e.end_ns() * 1e-9)
        if e.name() == SPAN:
            # the annotation is also drawn on the device's timeline
            if e.device_type() != dev_t:
                span = row
        elif e.device_type() == dev_t:
            device.append(row)
        else:
            host.append(row)
    if span is None:
        raise RuntimeError("the profiler recorded no span")
    t0, t1 = span[1], span[2]
    clip = lambda rows: [(n, max(a, t0) - t0, min(b, t1) - t0)
                         for n, a, b in rows if b > t0 and a < t1]
    return out, Trace(t1 - t0, clip(device), clip(host))


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def busy_intervals(device: list) -> np.ndarray:
    """The union of the device activities' intervals: (n, 2), sorted."""
    if not device:
        return np.zeros((0, 2))
    iv = np.array(sorted((a, b) for _, a, b in device))
    out = [iv[0].copy()]
    for a, b in iv[1:]:
        if a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append(np.array([a, b]))
    return np.array(out)


def _label(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_:.]", "_", name)[:64]


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, by name, and the idle
    gaps by the innermost host event running at each gap's middle
    ("host_untraced" where none was), in seconds."""
    by_name: dict = {}
    for n, a, b in tr.device:
        by_name[_label(n)] = by_name.get(_label(n), 0.0) + (b - a)
    busy = busy_intervals(tr.device)
    edges = np.concatenate([[0.0], busy.ravel(), [tr.span_s]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    idle: dict = {}
    if len(gaps):
        host = sorted(tr.host, key=lambda r: r[1])
        starts = np.array([r[1] for r in host] or [np.inf])
        ends = np.array([r[2] for r in host] or [-np.inf])
        mids = gaps.mean(axis=1)
        # the latest-starting host event that still runs at the middle
        j = np.searchsorted(starts, mids, side="right") - 1
        found = np.full(len(mids), -1)
        for _ in range(256):
            live = (found < 0) & (j >= 0)
            if not live.any():
                break
            hit = live & (ends[np.maximum(j, 0)] >= mids)
            found[hit] = j[hit]
            j = np.where(live & ~hit, j - 1, j)
        for (g0, g1), f in zip(gaps, found):
            name = _label(host[f][0]) if f >= 0 else "host_untraced"
            idle[name] = idle.get(name, 0.0) + float(g1 - g0)
    rank = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(by_name), "idle_gaps": rank(idle)}


class Context(NamedTuple):
    """What a per-layer reader reads: the cell's entry kind, the traced
    span's work (plans or queries), its trace, the coarse-scan launches
    recorded in it, the traced request's answer, and measurements the
    harness took beside it (``extra``)."""
    entry: str
    work: int
    trace: Trace
    launches: list
    answer: dict
    extra: dict


def timed_turns(fns: dict, turns: int, sync) -> dict:
    """Host seconds of each of ``fns``, run in turns ``turns`` times, each
    call closed by ``sync``: name -> list of seconds."""
    out = {k: [] for k in fns}
    for _ in range(turns):
        for k, fn in fns.items():
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            out[k].append(time.perf_counter() - t0)
    return out
