"""Self-contained HTML observability dashboard (svsdf_tpu/viz/dashboard.py,
the same HTML bytes from the same bus) — the debug_assistant
GUI's job (`src/debug_assistant/scripts/main.py` + component.py:
news ticker, per-iteration optimizer monitor, cost curves) rendered as
a static artifact from a DebugBus instead of a pygame window over ROS
topics.

`render_dashboard(bus, path)` writes one HTML file with: the event
news feed, one SVG line panel per scalar series (cost curves,
iteration counts), and the wall-clock timer table. No external assets;
light/dark via CSS custom properties.
"""

from __future__ import annotations

import html
import json

from svsdf_tpu_torch.utils.debugbus import DebugBus

_CSS = """
:root { color-scheme: light dark; }
body {
  margin: 24px; background: var(--surface); color: var(--ink);
  font: 14px/1.5 system-ui, sans-serif;
  --surface: #fcfcfb; --ink: #0b0b0b; --ink2: #52514e;
  --muted: #c3c2b7; --grid: #eeeeec; --series: #2a78d6;
}
@media (prefers-color-scheme: dark) {
  body { --surface: #1a1a19; --ink: #ffffff; --ink2: #c3c2b7;
         --muted: #52514e; --grid: #2c2c2b; --series: #3987e5; }
}
h1 { font-size: 18px; } h2 { font-size: 15px; color: var(--ink2); }
table { border-collapse: collapse; margin: 8px 0 24px; }
td, th { padding: 4px 12px; border-bottom: 1px solid var(--grid);
         text-align: left; font-variant-numeric: tabular-nums; }
th { color: var(--ink2); font-weight: 600; }
.panel { display: inline-block; margin: 0 16px 16px 0;
         vertical-align: top; }
svg text { fill: var(--ink2); font: 11px system-ui, sans-serif; }
svg .grid { stroke: var(--grid); stroke-width: 1; }
svg .line { stroke: var(--series); stroke-width: 2; fill: none; }
svg .axis { stroke: var(--muted); stroke-width: 1; }
"""


def _fmt(v: float) -> str:
    return f"{v:.6g}"


def _svg_line_panel(name: str, rows, width=420, height=180) -> str:
    """One scalar series as an inline SVG line panel (single series —
    the title names it, no legend)."""
    xs = [r[1] for r in rows]
    ys = [r[2] for r in rows]
    if len(xs) < 2:
        return (f'<div class="panel"><h2>{html.escape(name)}</h2>'
                f'<p>{_fmt(ys[0]) if ys else "—"}</p></div>')
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(ys), max(ys)
    if y1 - y0 < 1e-12:
        y1 = y0 + 1.0
    pad_l, pad_r, pad_t, pad_b = 56, 10, 8, 22
    pw, ph = width - pad_l - pad_r, height - pad_t - pad_b

    def sx(x):
        return pad_l + pw * (x - x0) / max(x1 - x0, 1e-12)

    def sy(y):
        return pad_t + ph * (1.0 - (y - y0) / (y1 - y0))

    pts = " ".join(f"{sx(x):.1f},{sy(y):.1f}" for x, y in zip(xs, ys))
    gridlines, labels = [], []
    for k in range(4):
        gy = pad_t + ph * k / 3
        gv = y1 - (y1 - y0) * k / 3
        gridlines.append(f'<line class="grid" x1="{pad_l}" y1="{gy:.1f}" '
                         f'x2="{width - pad_r}" y2="{gy:.1f}"/>')
        labels.append(f'<text x="{pad_l - 6}" y="{gy + 4:.1f}" '
                      f'text-anchor="end">{_fmt(gv)}</text>')
    end_lab = (f'<text x="{sx(xs[-1]) - 4:.1f}" y="{sy(ys[-1]) - 6:.1f}" '
               f'text-anchor="end">{_fmt(ys[-1])}</text>')
    xaxis = (f'<line class="axis" x1="{pad_l}" y1="{height - pad_b}" '
             f'x2="{width - pad_r}" y2="{height - pad_b}"/>'
             f'<text x="{pad_l}" y="{height - 6}">step {xs[0]:g}</text>'
             f'<text x="{width - pad_r}" y="{height - 6}" '
             f'text-anchor="end">{xs[-1]:g}</text>')
    return (f'<div class="panel"><h2>{html.escape(name)}</h2>'
            f'<svg width="{width}" height="{height}" role="img" '
            f'aria-label="{html.escape(name)}">'
            f'{"".join(gridlines)}{"".join(labels)}{xaxis}'
            f'<polyline class="line" points="{pts}"/>{end_lab}'
            f'</svg></div>')


def render_dashboard(bus: DebugBus, path: str,
                     title: str = "svsdf_tpu run") -> str:
    parts = [f"<!doctype html><meta charset='utf-8'>"
             f"<title>{html.escape(title)}</title>"
             f"<style>{_CSS}</style><h1>{html.escape(title)}</h1>"]
    if bus.series:
        parts.append("<h2>Series</h2><div>")
        for name in sorted(bus.series):
            parts.append(_svg_line_panel(name, bus.series[name]))
        parts.append("</div>")
    if bus.timers:
        parts.append("<h2>Timers</h2><table><tr><th>section</th>"
                     "<th>wall (ms)</th></tr>")
        for name, secs in sorted(bus.timers.items(),
                                 key=lambda kv: -kv[1]):
            parts.append(f"<tr><td>{html.escape(name)}</td>"
                         f"<td>{secs * 1e3:.1f}</td></tr>")
        parts.append("</table>")
    if bus.events:
        parts.append("<h2>Events</h2><table><tr><th>t (s)</th>"
                     "<th>source</th><th>message</th></tr>")
        for e in bus.events[-500:]:
            extra = {k: v for k, v in e.items()
                     if k not in ("t", "source", "message")}
            msg = e["message"] + (f"  {json.dumps(extra)}" if extra
                                  else "")
            parts.append(f"<tr><td>{e['t']:.3f}</td>"
                         f"<td>{html.escape(str(e['source']))}</td>"
                         f"<td>{html.escape(msg)}</td></tr>")
        parts.append("</table>")
    with open(path, "w") as f:
        f.write("".join(parts))
    return path


def load_bus_jsonl(path: str) -> DebugBus:
    """Rehydrate a DebugBus from its dump_jsonl artifact — the
    cross-process story (the reference streams these over ROS topics;
    we stream them through a file/queue of JSONL lines)."""
    bus = DebugBus()
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            kind = rec.pop("type")
            if kind == "event":
                bus.events.append(rec)
            elif kind == "scalar":
                bus.series[rec["name"]].append(
                    (rec["t"], rec["step"], rec["value"]))
            elif kind == "timer":
                bus.timers[rec["name"]] = rec["seconds"]
    return bus


class LiveDashboard:
    """Render the dashboard file DURING a solve.

    A daemon thread re-renders `path` every `interval_s` while the
    context is active (and once on exit), so cost curves streamed by
    the live observer (utils/lbfgs.py LBFGSParams.live) appear in
    the HTML as the optimizer runs — the role of debug_assistant's
    pygame monitor (SURVEY.md §2.4), with the browser as the viewer:

        with LiveDashboard(BUS, "run.html"):
            back_end.optimize(..., live=True)
    """

    def __init__(self, bus: DebugBus, path: str,
                 interval_s: float = 0.5,
                 title: str = "svsdf_tpu live"):
        self.bus, self.path = bus, path
        self.interval_s, self.title = interval_s, title
        self.renders = 0
        self._stop = None

    def __enter__(self):
        import threading

        self._stop = threading.Event()

        def loop():
            while not self._stop.wait(self.interval_s):
                self._render()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def _render(self):
        try:
            render_dashboard(self.bus, self.path, title=self.title)
            self.renders += 1
        except Exception:              # noqa: BLE001 — keep streaming
            pass

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._render()                 # final consistent frame
        return False
