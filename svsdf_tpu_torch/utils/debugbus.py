"""Structured observability bus: events, cost curves, timers (own copy of
svsdf_tpu/utils/debugbus.py; pure Python).

Replaces the reference's debug stack — the global ROS debug_publisher
(`src/utils/src/debug_publisher.cpp:10-33`: DBSendNew / DBSendOptiStep /
DBSendLogCost topics) plus the pygame monitor GUI — with an in-process
structured recorder: timestamped events, named scalar series (cost
curves, iteration counts), wall-clock timing sections, JSONL export,
and a text summary. The planner emits to the module-level BUS.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Any, Dict, List


class DebugBus:
    def __init__(self):
        self.events: List[Dict[str, Any]] = []
        self.series: Dict[str, List] = defaultdict(list)
        self.timers: Dict[str, float] = defaultdict(float)
        self._t0 = time.time()
        self._stop = False
        self._paused = False
        self._steps = 0

    # -- command channel (the /debug_cmd code-21 early exit:
    # debugMsgcallback plan_manager.cpp:431-445 -> TrajOptimizer::exit
    # -> earlyExitLMBM back_end_optimizer.hpp:1105-1111). The pipeline
    # polls stop_requested between optimization rounds, and a live solve
    # (utils/lbfgs.py LBFGSParams.live) once per iteration, and returns
    # its best-so-far trajectory, the reference's abort semantics. ------
    def request_stop(self):
        self._stop = True
        self.send("cmd", "stop_requested")

    def clear_stop(self):
        self._stop = False

    @property
    def stop_requested(self) -> bool:
        return self._stop

    # -- pause / single-step gate (the reference's `debugpause`
    # step-through, back_end_optimizer.hpp:1093-1103). A live solve calls
    # wait_if_paused once per optimizer iteration: while paused, the loop
    # blocks; step() releases exactly one iteration; resume() releases
    # the gate. ----------------------------------------------------------
    def pause(self):
        self._paused = True
        self.send("cmd", "paused")

    def resume(self):
        self._paused = False
        self._steps = 0
        self.send("cmd", "resumed")

    def step(self, n: int = 1):
        """Allow n more optimizer iterations while paused."""
        self._steps = getattr(self, "_steps", 0) + n

    @property
    def paused(self) -> bool:
        return getattr(self, "_paused", False)

    def wait_if_paused(self, poll_s: float = 0.02):
        if not getattr(self, "_paused", False):
            return
        if getattr(self, "_steps", 0) > 0:
            self._steps -= 1
            return
        while self._paused and self._steps == 0 and not self._stop:
            time.sleep(poll_s)
        if self._steps > 0:
            self._steps -= 1

    # -- events (DBSendNew "title@msg") -----------------------------------
    def send(self, source: str, message: str, **payload):
        self.events.append(dict(t=time.time() - self._t0, source=source,
                                message=message, **payload))

    # -- scalar series (DBSendLogCost / DBSendOptiStep) --------------------
    def log_scalar(self, name: str, value, step=None):
        self.series[name].append(
            (time.time() - self._t0,
             step if step is not None else len(self.series[name]),
             float(value)))

    # -- timing sections (the reference's ad-hoc chrono accumulators,
    #    back_end_optimizer.hpp:31-33) -------------------------------------
    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timers[name] += time.perf_counter() - t0

    # -- export -------------------------------------------------------------
    def dump_jsonl(self, path: str):
        with open(path, "w") as f:
            for e in self.events:
                f.write(json.dumps({"type": "event", **e}) + "\n")
            for name, rows in self.series.items():
                for (t, step, v) in rows:
                    f.write(json.dumps({"type": "scalar", "name": name,
                                        "t": t, "step": step,
                                        "value": v}) + "\n")
            for name, secs in self.timers.items():
                f.write(json.dumps({"type": "timer", "name": name,
                                    "seconds": secs}) + "\n")

    def summary(self) -> str:
        lines = [f"events: {len(self.events)}"]
        for name, rows in self.series.items():
            vals = [v for (_, _, v) in rows]
            lines.append(f"series {name}: n={len(vals)} "
                         f"last={vals[-1]:.6g} min={min(vals):.6g}")
        for name, secs in sorted(self.timers.items()):
            lines.append(f"timer {name}: {secs * 1e3:.1f} ms")
        return "\n".join(lines)

    def clear(self):
        self.events.clear()
        self.series.clear()
        self.timers.clear()


#: module-level bus, mirroring the reference's global debug_publisher
BUS = DebugBus()
