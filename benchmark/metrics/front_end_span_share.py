"""The front end's share of the traced end-to-end request on the host
clock: the length of the program's ``batch.front_end`` span over that of
its ``batch.e2e`` span (wavefront field and path, yaw bins, resample,
harvest), in %. Moves certified_plans_per_s."""

from benchmark import spans


def read(ctx):
    length = lambda rows: sum(b - a for _, a, b in rows)
    whole = length(spans.host_spans(ctx.trace, "batch.e2e"))
    if not whole:
        return None
    return 100.0 * length(spans.host_spans(ctx.trace,
                                           "batch.front_end")) / whole
