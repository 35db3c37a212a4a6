"""The SVSDF oracle's refinement a query: the device time of the work
launched with the ``oracle.refine`` span innermost (the exact samples
of the refinement rounds, or the table parabola) over the points
queried in the traced span, in ns. Moves queries_per_s."""

from benchmark import spans


def read(ctx):
    own = spans.owned(ctx.trace)
    if own is None or not ctx.work:
        return None
    return 1e9 * own.seconds(spans.innermost("oracle.refine")) / ctx.work
