"""The front end's share of a whole end-to-end solve, in %: the front
end alone (wavefront field and path, resample, harvest) over a whole
plan_batch_e2e on the same draws, each timed on the host clock closed by
a device synchronisation, in turns, the medians of each. Moves the
cell's rate."""

import statistics


def read(ctx):
    t = ctx.extra.get("front_end_turns")
    if not t:
        return None
    return 100.0 * statistics.median(t["front"]) / statistics.median(
        t["whole"])
