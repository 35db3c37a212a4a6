"""The program's own spans in the traced span, and the device time each
of them owns.

The program opens a span at each of its layer boundaries
(``svsdf_tpu_torch/utils/profiling.py::span``): a host event named
``<layer>.<part>`` (``batch.stage``, ``lbfgs.line_search``,
``minco.solve``, ``oracle.scan``, ``sync.<site>`` ...). Its spans are host
events only, so they sit in ``Trace.host`` beside the runtime calls that
launch the device's work.

A device row belongs to the innermost span open on the host when its
work was launched. A trace row keeps no link from a kernel to its launch,
so the link is taken by order: on the program's one stream the device
runs its work in the order the host launched it, so the rows pair with
the launch calls (``LAUNCHES``) in order, from the last back. The
profiler loses the rows of a few launches near the start of a session
(0 to 13 of ~240 k in a plan cell on the H100), whose launches are left
over at the front; where it loses one later, the rows before it pair
with their neighbours' launches, which mostly sit in the same span
(against the profiler's correlation ids on the H100, the spans of
99.25% to 100% of a plan cell's rows agree). The pairing uses no device
timestamp: the spans and the launch calls are host events on one
clock, while the device's clock can sit off the host's. Spans on the
autograd engine's thread nest in time inside the caller's, which waits
for them, so the innermost span is the latest-starting one still open.
"""

from __future__ import annotations

from typing import NamedTuple

#: the first word of every span the program opens
LAYERS = ("batch", "lbfgs", "minco", "oracle", "sync")
#: host runtime and driver calls that put one row of work on the device
LAUNCHES = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync"})
#: launch calls without a device row beyond which the pairing is not
#: trusted
SPARE = 64


def is_span(name: str) -> bool:
    return "." in name and name.split(".", 1)[0] in LAYERS


def host_spans(tr, name: str) -> list:
    """The (name, start, end) host rows of the program's spans named
    ``name``, or whose name starts with it where it ends in a dot."""
    hit = ((lambda n: n.startswith(name)) if name.endswith(".")
           else (lambda n: n == name))
    return [r for r in tr.host if is_span(r[0]) and hit(r[0])]


def innermost(prefix: str):
    """A test of a span chain: its innermost span's name starts with
    ``prefix``."""
    return lambda chain: bool(chain) and chain[-1].startswith(prefix)


class Owned(NamedTuple):
    """Device busy time by owning span: ``busy_s`` is the union of the
    device rows' intervals; ``rows`` holds, for each device row, its share
    of that union (the part no earlier row covered) and the names of the
    spans open at its launch, outermost first (empty: no span)."""
    busy_s: float
    rows: list

    def seconds(self, test) -> float:
        """Busy seconds of the rows whose span chain passes ``test``."""
        return sum(s for s, chain in self.rows if test(chain))

    def share(self, test) -> float:
        """The same, in % of the busy time."""
        return 100.0 * self.seconds(test) / self.busy_s


def owned(tr) -> Owned | None:
    """The device rows of ``tr`` with the spans that own them; None where
    the trace has no device row or no program span, or has fewer launch
    calls than device rows or more than ``SPARE`` over."""
    spans = [r for r in tr.host if is_span(r[0])]
    launches = sorted(a for n, a, _ in tr.host if n in LAUNCHES)
    device = sorted(tr.device, key=lambda r: r[1])
    spare = len(launches) - len(device)
    if not device or not spans or not 0 <= spare <= SPARE:
        return None
    at = launches[spare:]
    # a sweep in time: spans open before, and close after, a launch at
    # the same instant; an outer span (the longer) opens first
    events = [(a, 0, -b, i) for i, (_, a, b) in enumerate(spans)]
    events += [(b, 2, 0.0, i) for i, (_, _, b) in enumerate(spans)]
    events += [(t, 1, 0.0, k) for k, t in enumerate(at)]
    events.sort()
    chains = [()] * len(spans)
    open_: list = []
    at_launch = [()] * len(at)
    for _, kind, _, i in events:
        if kind == 0:
            chains[i] = (chains[open_[-1]] if open_ else ()) + (spans[i][0],)
            open_.append(i)
        elif kind == 2:
            if i in open_:
                open_.remove(i)
        else:
            at_launch[i] = chains[open_[-1]] if open_ else ()
    rows, reach = [], float("-inf")
    for (_, a, b), chain in zip(device, at_launch):
        rows.append((max(0.0, b - max(a, reach)), chain))
        reach = max(reach, b)
    busy = sum(s for s, _ in rows)
    return Owned(busy, rows) if busy > 0 else None
