"""The device's busy time in the traced span that no program span owns:
work launched while no span of the program was open, over all busy time,
in %. What the layer shares cannot see; moves the cell's rate."""

from benchmark import spans


def read(ctx):
    own = spans.owned(ctx.trace)
    return None if own is None else own.share(lambda chain: not chain)
