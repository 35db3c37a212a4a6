"""The SVSDF oracle's share of the device's busy time in the traced
span: the device time of the work launched with an ``oracle.*`` span
innermost (pose tables and the coarse scan, refinement, the GSIP inside
solve) over all busy time, in %. Moves the cell's rate."""

from benchmark import spans


def read(ctx):
    own = spans.owned(ctx.trace)
    return None if own is None else own.share(spans.innermost("oracle."))
