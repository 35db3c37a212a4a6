"""Device kernels a plan in the traced solve: the profiler's count of
kernel launches in the span over the plans it solved. Moves the cell's
rate: each launch costs the host its dispatch."""

from benchmark.trace import is_kernel


def read(ctx):
    if not ctx.trace.device or not ctx.work:
        return None
    return sum(is_kernel(n) for n, _, _ in ctx.trace.device) / ctx.work
