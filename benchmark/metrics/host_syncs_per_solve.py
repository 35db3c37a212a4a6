"""Host waits for the device a solve: the program's ``sync.*`` spans
(each a host read of a device flag: a done mask, a line-search exit, a
GSIP or front-end test) over its request spans in the traced span. Each
stalls the host's launches until the device drains, and breaks a CUDA
graph's capture. Moves the cell's rate."""

from benchmark import spans


def read(ctx):
    solves = len(spans.host_spans(ctx.trace, "batch.staged")) + len(
        spans.host_spans(ctx.trace, "batch.e2e"))
    if not solves:
        return None
    return len(spans.host_spans(ctx.trace, "sync.")) / solves
