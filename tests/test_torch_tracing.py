"""The port's spans (``utils/profiling.py``: ``span``, ``host_bool``) on
the plan and field paths, under a CPU ``torch.profiler`` session.

Held: a small ``plan_batch_staged`` (sdHeart, B = 4, both stages of
``default_stages(40)``, which the sdHeart configuration runs) and a small
``plan_batch_e2e`` (the corridor map, one certify-and-refine round) open
exactly the layer vocabulary, nested as the layers call each other; their
answers are the same to the bit with and without a session; outside a
session no profiler range is entered at all; and the ``sync.*`` spans of
a staged solve are the host reads its iteration counts imply. A span is a
host event, not a user annotation: the profiler draws user annotations on
the device's timeline too.
"""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from svsdf_tpu_torch import convert
from svsdf_tpu_torch.bench import problem
from svsdf_tpu_torch.models import shapes
from svsdf_tpu_torch.ops import kernels as kops
from svsdf_tpu_torch.ops import minco
from svsdf_tpu_torch.ops.svsdf import SVSDFConfig, svsdf_grid
from svsdf_tpu_torch.parallel import batch as pb
from svsdf_tpu_torch.planner import back_end
from svsdf_tpu_torch.utils import lbfgs, profiling
from svsdf_tpu_torch.utils.config import PlannerConfig
from svsdf_tpu_torch.utils.gridmap import GridMap

torch.set_num_threads(1)

LAYERS = ("batch", "lbfgs", "minco", "oracle", "sync")
STAGED = {"batch.staged", "batch.stage", "lbfgs.direction",
          "lbfgs.line_search", "minco.solve", "minco.backward",
          "oracle.scan", "oracle.refine", "oracle.gsip",
          "sync.lbfgs.active", "sync.svsdf.inside"}
E2E = {"batch.e2e", "batch.front_end", "batch.stage", "batch.certify",
       "lbfgs.direction", "lbfgs.line_search", "minco.solve",
       "minco.backward", "oracle.scan", "oracle.refine",
       "sync.lbfgs.active", "sync.lbfgs.wolfe", "sync.wavefront.relax",
       "sync.wavefront.path", "sync.batch.certify_round",
       "sync.batch.certify_solve"}
#: where each span may sit: its innermost enclosing span
PARENTS = {
    "batch.staged": {None}, "batch.e2e": {None},
    "batch.front_end": {"batch.e2e"},
    "batch.stage": {"batch.staged", "batch.e2e"},
    "batch.certify": {"batch.e2e"},
    "lbfgs.direction": {"batch.stage", "batch.certify"},
    "lbfgs.line_search": {"batch.stage", "batch.certify"},
    "minco.solve": {"lbfgs.line_search", "batch.stage", "batch.staged",
                    "batch.e2e", "batch.certify"},
    "minco.backward": {"lbfgs.line_search", "batch.stage",
                       "batch.certify"},
    "oracle.scan": {"lbfgs.line_search", "batch.stage", "batch.certify",
                    "oracle.gsip"},
    "oracle.refine": {"lbfgs.line_search", "batch.stage", "batch.certify",
                      "oracle.gsip"},
    "oracle.gsip": {"lbfgs.line_search", "batch.stage", "batch.certify"},
}


def _staged_run():
    h, t, o, x0 = (torch.as_tensor(a) for a in problem(8, 16, 4, seed=3))
    return lambda: pb.plan_batch_staged(
        shapes.make_shape("sdHeart"), x0, back_end.BackEndProblem(h, t, o),
        PlannerConfig(mem_size=8), pb.default_stages(40), 8, device="cpu")


def _e2e_run():
    pts = [(x + 0.5, 7.2, z + 0.5) for x in range(24) for z in range(2)
           if not 10 <= x <= 13]
    pts += [(0.05, 0.05, 0.05), (23.9, 15.9, 1.9)]
    grid = GridMap.from_points(np.asarray(pts), 1.0, 1)
    circle = shapes.make_shape("Circle")
    ker = kops.rasterize_shape_kernels(circle, 7, 4, 1.0, 0.5, device="cpu")
    feas = kops.feasibility_maps(grid.occ2d.copy(), ker, device="cpu")
    feas_t, occ_t, _, _ = convert.front_end_maps_from_numpy(
        feas.numpy(), grid.occupied_centers_2d(), device="cpu")
    svs = SVSDFConfig(coarse_n=48, refine_rounds=1, refine_n=8,
                      use_inside=False)
    return lambda: pb.plan_batch_e2e(
        circle, feas_t, occ_t, np.asarray([[3, 3], [2, 5]]),
        np.asarray([[20, 12], [21, 11]]), PlannerConfig(mem_size=8),
        ((svs, 6, 2),), 6, 16, 1.0, grid.xyz_min[:2].astype(np.float32),
        refine_rounds=1, refine_iters=3, cert_margin=1.2, device="cpu")


def _traced(run):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run()
    rows = [(e.name(), e.start_ns(), e.end_ns(), e)
            for e in prof.profiler.kineto_results.events()
            if e.name().split(".")[0] in LAYERS and "." in e.name()]
    return out, sorted(rows, key=lambda r: (r[1], -r[2]))


def _parents(rows):
    """Each span's innermost enclosing span (None: outermost)."""
    out, open_ = [], []
    for name, a, b, _ in rows:
        while open_ and open_[-1][2] < b:
            open_.pop()
        out.append((name, open_[-1][0] if open_ else None))
        open_.append((name, a, b))
    return out


def _same(a, b):
    for x, y in zip(a, b):
        if torch.is_tensor(x):
            assert torch.equal(x, y)
        else:
            _same(x, y)


_CACHE: dict = {}


def _cached(name):
    if name not in _CACHE:
        run = _staged_run() if name == "staged" else _e2e_run()
        plain = run()
        _CACHE[name] = plain, _traced(run)
    return _CACHE[name]


@pytest.mark.parametrize("name,vocabulary", [("staged", STAGED),
                                             ("e2e", E2E)])
def test_spans_are_the_vocabulary_nested_by_layer(name, vocabulary):
    _, (_, rows) = _cached(name)
    assert {r[0] for r in rows} == vocabulary
    pairs = _parents(rows)
    request = "batch.staged" if name == "staged" else "batch.e2e"
    assert sum(n == request for n, _ in pairs) == 1
    for child, parent in pairs:
        if child.startswith("sync."):
            assert parent is not None
        else:
            assert parent in PARENTS[child], (child, parent)


@pytest.mark.parametrize("name", ["staged", "e2e"])
def test_answers_are_the_same_to_the_bit_under_a_session(name):
    plain, (traced, _) = _cached(name)
    _same(plain, traced)


@pytest.mark.parametrize("name", ["staged", "e2e"])
def test_spans_are_host_events_not_user_annotations(name):
    _, (_, rows) = _cached(name)
    assert all(e.activity_type() == "cpu_op" and not e.is_user_annotation()
               for *_, e in rows)


def test_syncs_are_the_host_reads_the_iterations_imply(monkeypatch):
    # each stage's loop: one done test a loop pass and one at its exit; the
    # polish stage (GSIP on) also tests for inside points at every full
    # cost evaluation, one before the loop and one a pass
    iters = []
    minimize = lbfgs.minimize

    def recorded(*a, **kw):
        res = minimize(*a, **kw)
        iters.append(int(res.n_iters.max()))
        return res

    monkeypatch.setattr(lbfgs, "minimize", recorded)
    _, rows = _traced(_staged_run())
    count = collections.Counter(r[0] for r in rows)
    fast, polish = iters
    assert count["lbfgs.direction"] == fast + polish
    assert count["sync.lbfgs.active"] == fast + 1 + polish + 1
    assert count["sync.svsdf.inside"] == polish + 1
    assert sum(n.startswith("sync.") for n in count) == 2


def test_no_session_no_range(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, *a, **kw):
            entered.append(a)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Counting)
    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    assert profiling.span("minco.solve") is profiling.span("oracle.scan")
    assert profiling.host_bool(torch.tensor(True), "x") is True
    _staged_run()()
    traj = minco.solve(torch.full((1, 3), 1.5),
                       torch.zeros((1, 3, 3)),
                       torch.tensor([[[5.0, 0, 0], [0, 0, 0], [0, 0, 0]]]),
                       torch.tensor([[[1.5, 0.1, 0.0], [3.5, -0.1, 0.1]]]))
    svsdf_grid(shapes.make_shape("sdHeart"), traj, torch.linspace(-1, 6, 8),
               torch.linspace(-2, 2, 8), SVSDFConfig(coarse_n=32,
                                                     refine_n=8))
    with profiling.stage("work", profile=profiling.Profile()):
        pass
    assert entered == []
    # the counting stand-in is entered once a session runs
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("minco.solve"):
            pass
        assert profiling.host_bool(torch.tensor(False), "x") is False
    assert entered == [("minco.solve",), ("sync.x",)]


def test_grid_field_spans():
    traj = minco.solve(torch.full((1, 3), 1.5), torch.zeros((1, 3, 3)),
                       torch.tensor([[[5.0, 0, 0], [0, 0, 0], [0, 0, 0]]]),
                       torch.tensor([[[1.5, 0.1, 0.0], [3.5, -0.1, 0.1]]]))
    run = lambda: svsdf_grid(shapes.make_shape("sdHeart"), traj,
                             torch.linspace(-1, 6, 8),
                             torch.linspace(-2, 2, 8),
                             SVSDFConfig(coarse_n=32, refine_n=8))
    plain = run()
    field, rows = _traced(run)
    assert torch.equal(plain, field)
    assert _parents(rows) == [("oracle.grid", None),
                              ("oracle.scan", "oracle.grid"),
                              ("oracle.refine", "oracle.grid")]


class _Event:
    def __init__(self, device, annotation):
        self.device, self.annotation = device, annotation

    def device_type(self):
        return self.device

    def is_user_annotation(self):
        return self.annotation


def test_device_activity_leaves_annotations_out():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    assert profiling.is_device_activity(_Event(cuda, False))
    assert not profiling.is_device_activity(_Event(cuda, True))
    assert not profiling.is_device_activity(_Event(cpu, False))
