"""The readers of the program's spans (``benchmark/spans.py`` and the
per-layer metrics that read it) on hand-built traces: innermost
attribution, inclusive line-search time, work launched under no span,
launches and device rows that differ in number, and a program without
spans. The spans are host events, so every reader of the device's rows,
and the breakdown's device time and idle time, read the same with or
without them."""

import pytest

from benchmark import run, spans
from benchmark.trace import Context, Trace, breakdown

L = "cudaLaunchKernel"
#: a staged request's spans, launches (kernel k at 1.6 ...) and other
#: host events; minco.backward stands for a span on the autograd engine's
#: thread, inside the caller's line search in time
HOST = [
    ("batch.staged", 0.0, 10.0), ("batch.stage", 0.5, 9.5),
    ("lbfgs.direction", 0.6, 0.9), (L, 0.7, 0.71),
    ("lbfgs.line_search", 1.0, 4.0), ("minco.solve", 1.5, 2.0),
    ("aten::mm", 1.55, 1.65), (L, 1.6, 1.61),
    ("minco.backward", 2.5, 3.0), (L, 2.6, 2.61),
    (L, 3.5, 3.51),
    ("oracle.scan", 5.0, 6.0), (L, 5.1, 5.11),
    ("sync.lbfgs.active", 6.5, 7.0), ("cudaMemcpyAsync", 6.6, 6.7),
    ("cudaStreamSynchronize", 6.7, 6.95),
    (L, 11.0, 11.01),
]
DEVICE = [
    ("direction_kernel", 0.8, 1.3),       # lbfgs.direction, 0.5
    ("gemm", 1.7, 2.7),                   # minco.solve, 1.0
    ("cr_transposed", 2.7, 3.2),          # minco.backward, 0.5
    ("elementwise", 3.6, 4.6),            # lbfgs.line_search, 1.0
    ("coarse_scan_kernel", 5.2, 6.2),     # oracle.scan, 1.0
    ("Memcpy DtoH (Device -> Pinned)", 6.8, 6.9),  # sync, 0.1
    ("copy", 11.1, 11.5),                 # no span, 0.4
]
BUSY = 4.5


def _ctx(host=HOST, device=DEVICE, work=16, span_s=12.0):
    return Context("staged", work, Trace(span_s, list(device), list(host)),
                   [], {}, {})


def _read(metric, ctx):
    return run.reader(metric)(ctx)


def test_innermost_attribution():
    ctx = _ctx()
    assert _read("minco_share.staged", ctx) == pytest.approx(
        100 * 1.5 / BUSY)
    assert _read("oracle_share.staged", ctx) == pytest.approx(
        100 * 1.0 / BUSY)
    assert _read("unspanned_share.staged", ctx) == pytest.approx(
        100 * 0.4 / BUSY)
    own = spans.owned(ctx.trace)
    assert own.busy_s == pytest.approx(BUSY)
    chains = [c for _, c in own.rows]
    assert chains[2] == ("batch.staged", "batch.stage", "lbfgs.line_search",
                         "minco.backward")
    assert chains[5] == ("batch.staged", "batch.stage", "sync.lbfgs.active")
    assert chains[6] == ()


def test_the_line_search_share_is_inclusive():
    # the trial points' MINCO solve and its backward count with the rest
    assert _read("line_search_share.staged", _ctx()) == pytest.approx(
        100 * 2.5 / BUSY)


def test_overlapping_rows_split_the_busy_time_once():
    device = DEVICE[:1] + [("gemm", 1.7, 2.9)] + DEVICE[2:]
    own = spans.owned(_ctx(device=device).trace)
    assert own.busy_s == pytest.approx(BUSY)
    # the overlap goes to the row that started first
    assert own.seconds(spans.innermost("minco.")) == pytest.approx(1.5)


def test_syncs_a_solve_and_the_front_end_span():
    assert _read("host_syncs_per_solve.staged", _ctx()) == 1.0
    host = [("batch.e2e", 0.0, 10.0), ("batch.front_end", 0.5, 1.5),
            ("batch.stage", 2.0, 9.0), ("sync.wavefront.relax", 0.7, 0.8),
            ("sync.wavefront.path", 1.0, 1.1),
            ("sync.lbfgs.active", 3.0, 3.1)]
    ctx = _ctx(host=host, device=[])
    assert _read("front_end_span_share.forest", ctx) == pytest.approx(10.0)
    assert _read("host_syncs_per_solve.forest", ctx) == 3.0
    # the syncs of the front end read on the host alone: no device row
    assert _read("minco_share.forest", ctx) is None


def test_refine_span_ns():
    host = [("oracle.grid", 0.0, 1.0), ("oracle.scan", 0.1, 0.2),
            (L, 0.15, 0.16), ("oracle.refine", 0.3, 0.9), (L, 0.4, 0.41),
            (L, 0.5, 0.51), ("oracle.grid", 1.0, 2.0)]
    device = [("coarse_scan_kernel", 0.2, 0.3), ("gemv", 0.45, 0.55),
              ("cat", 0.6, 0.65)]
    ctx = _ctx(host=host, device=device, work=1000, span_s=2.0)
    assert _read("refine_span_ns.grid", ctx) == pytest.approx(
        1e9 * 0.15 / 1000)
    assert _read("unspanned_share.grid", ctx) == 0.0


def test_launches_without_a_row_are_left_over():
    # the profiler loses the rows of a session's first launches
    want = spans.owned(_ctx().trace).rows
    lost = [(L, 0.01, 0.02), (L, 0.02, 0.03)] + HOST
    assert spans.owned(_ctx(host=lost).trace).rows == want
    many = [(L, 0.001 * i, 0.001 * i) for i in range(1, spans.SPARE + 2)]
    assert spans.owned(_ctx(host=many + HOST).trace) is None


def test_unknown_links_and_a_program_without_spans_read_nothing():
    # fewer launches than device rows: the link is not known
    host = [r for r in HOST if r != (L, 11.0, 11.01)]
    assert spans.owned(_ctx(host=host).trace) is None
    plain = [r for r in HOST if not spans.is_span(r[0])]
    for metric in ("minco_share.staged", "oracle_share.staged",
                   "line_search_share.staged", "unspanned_share.staged",
                   "host_syncs_per_solve.staged",
                   "front_end_span_share.forest", "refine_span_ns.grid"):
        assert _read(metric, _ctx(host=plain)) is None, metric
        assert _read(metric, _ctx(host=host)) is None or \
            metric.startswith(("host_syncs", "front_end")), metric


def test_span_names():
    assert spans.is_span("oracle.refine") and spans.is_span("sync.x.y")
    assert not spans.is_span("aten::mm") and not spans.is_span("batch")
    assert not spans.is_span("benchmark.span")
    tr = Trace(1.0, [], [("batch.staged", 0, 1), ("batch.stage", 0, 1),
                         ("sync.a", 0, 1)])
    assert [r[0] for r in spans.host_spans(tr, "batch.stage")] == [
        "batch.stage"]
    assert len(spans.host_spans(tr, "batch.")) == 2


@pytest.mark.parametrize("metric", ["device_idle_share.staged",
                                    "launches_per_plan.staged",
                                    "refine_ns_per_query.grid",
                                    "scan_roofline.staged"])
def test_existing_readers_read_the_same_with_spans(metric):
    plain = [r for r in HOST if not spans.is_span(r[0])]
    launch = [{"body": "sdHeart", "b": 16, "m": 64, "k": 96, "bf16": True,
               "scaled": False, "grid_bytes": 0}]
    with_spans, without = (
        Context("staged", 16, Trace(12.0, list(DEVICE), host), launch, {},
                {}) for host in (HOST, plain))
    assert _read(metric, with_spans) == _read(metric, without)


def test_breakdown_keeps_its_device_and_idle_time():
    plain = [r for r in HOST if not spans.is_span(r[0])]
    a = breakdown(Trace(12.0, DEVICE, HOST))
    b = breakdown(Trace(12.0, DEVICE, plain))
    assert a["device_ops"] == b["device_ops"]
    idle = lambda d: sum(v for _, v in d["idle_gaps"])
    assert idle(a) == pytest.approx(idle(b))
    # the spans name gaps that no host event covered
    assert dict(b["idle_gaps"]).get("host_untraced", 0.0) > \
        dict(a["idle_gaps"]).get("host_untraced", 0.0)
