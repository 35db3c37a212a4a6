"""The line search's share of the device's busy time in the traced span,
inclusive: the device time of the work launched anywhere under an
``lbfgs.line_search`` span (the trial points' cost and gradient
evaluations with the MINCO solves and oracle passes in them) over all
busy time, in %. Moves the cell's rate."""

from benchmark import spans


def read(ctx):
    own = spans.owned(ctx.trace)
    if own is None:
        return None
    return own.share(lambda chain: "lbfgs.line_search" in chain)
