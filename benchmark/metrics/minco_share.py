"""MINCO's share of the device's busy time in the traced span: the
device time of the work launched with a ``minco.*`` span innermost (the
spline solve's bands and block cyclic reduction, and the transposed solve
of its backward pass) over all busy time, in %. Moves the cell's rate."""

from benchmark import spans


def read(ctx):
    own = spans.owned(ctx.trace)
    return None if own is None else own.share(spans.innermost("minco."))
