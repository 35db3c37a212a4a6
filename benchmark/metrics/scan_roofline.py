"""The coarse-scan kernel's share of its roofline in the traced span:
the launches' least time (roofline.least_seconds) over their profiled
device time, in %. Moves the cell's rate.

The launches' sizes are recorded where the program launches the kernel
(trace.scan_launches), their times read from the trace. Where the two
counts differ (a launch path that bypasses the recorded one, such as a
replayed CUDA graph, or a renamed kernel), the reading would no longer
stand for the kernel that runs, so the traced run fails here rather than
leave the metric out. With no launch on either side the kernel is off
the path and the metric is left out."""

from benchmark import roofline
from benchmark.trace import SCAN_KERNEL


def read(ctx):
    times = [b - a for n, a, b in ctx.trace.device if SCAN_KERNEL in n]
    if not times and not ctx.launches:
        return None
    if len(times) != len(ctx.launches):
        raise RuntimeError(
            f"scan_roofline: {len(times)} {SCAN_KERNEL} kernels in the "
            f"trace, {len(ctx.launches)} launches recorded")
    return 100.0 * sum(map(roofline.least_seconds, ctx.launches)) / sum(times)
