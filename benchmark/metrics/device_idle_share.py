"""The device's idle share of the traced span: 1 minus the union of its
activity intervals over the span, in %. Moves the cell's rate: while the
card idles, the host sets the pace."""

from benchmark.trace import busy_intervals


def read(ctx):
    if not ctx.trace.device:
        return None
    busy = busy_intervals(ctx.trace.device)
    return 100.0 * (1.0 - (busy[:, 1] - busy[:, 0]).sum() / ctx.trace.span_s)
