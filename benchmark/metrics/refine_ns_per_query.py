"""The SVSDF oracle's work past the coarse scan, a query: the device
time of every kernel but the coarse scan's in the traced query batches
(pose tables, refinement rounds, the field's assembly) over the points
queried, in ns. Moves queries_per_s."""

from benchmark.trace import SCAN_KERNEL, is_kernel


def read(ctx):
    if not ctx.trace.device or not ctx.work:
        return None
    s = sum(b - a for n, a, b in ctx.trace.device
            if is_kernel(n) and SCAN_KERNEL not in n)
    return 1e9 * s / ctx.work
