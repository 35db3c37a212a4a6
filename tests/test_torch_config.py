"""Port parity: the configuration classes and the default stage
schedules against the JAX package's, field by field, so that a field
added, renamed or re-defaulted on either side fails here.

Fields the port accepts and ignores (each documented on its class):
``LBFGSParams.scan_unroll`` (the unroll factor of a ``lax.scan`` the
eager loop does not have) and ``SVSDFConfig``'s ``gsip_fori``,
``use_pallas`` and ``pallas_min_points`` (on CUDA the coarse scan is
always the kernel, and the GSIP loop has no shape to fix).
"""

import dataclasses

import numpy as np
import pytest
import torch

from svsdf_tpu.ops import svsdf as jsv
from svsdf_tpu.parallel import batch as jbatch
from svsdf_tpu.utils import config as jconfig
from svsdf_tpu.utils import lbfgs as jlbfgs
from svsdf_tpu.utils import lmbm as jlmbm
from svsdf_tpu_torch.ops import svsdf as tsv
from svsdf_tpu_torch.parallel import batch as pb
from svsdf_tpu_torch.utils import config as tconfig
from svsdf_tpu_torch.utils import lbfgs as tlbfgs
from svsdf_tpu_torch.utils import lmbm as tlmbm

torch.set_num_threads(1)

#: (JAX class, port class)
CLASSES = {"LBFGSParams": (jlbfgs.LBFGSParams, tlbfgs.LBFGSParams),
           "LMBMParams": (jlmbm.LMBMParams, tlmbm.LMBMParams),
           "SVSDFConfig": (jsv.SVSDFConfig, tsv.SVSDFConfig),
           "PlannerConfig": (jconfig.PlannerConfig, tconfig.PlannerConfig)}
#: fields the port accepts and ignores
IGNORED = {"LBFGSParams": {"scan_unroll": 1},
           "SVSDFConfig": {"gsip_fori": True, "use_pallas": True,
                           "pallas_min_points": 1}}


def _defaults(cls) -> dict:
    """Field name -> default, in declaration order (a dataclass or a
    NamedTuple)."""
    if dataclasses.is_dataclass(cls):
        return {f.name: (f.default_factory()
                         if f.default is dataclasses.MISSING else f.default)
                for f in dataclasses.fields(cls)}
    return {name: cls._field_defaults.get(name, "<required>")
            for name in cls._fields}


def _same(a, b) -> bool:
    if isinstance(a, (np.ndarray, list, tuple)):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("name", list(CLASSES))
def test_fields_and_defaults_match_jax(name):
    jcls, tcls = CLASSES[name]
    want, got = _defaults(jcls), _defaults(tcls)
    assert list(got) == list(want)          # names, in the same order
    differ = {k: (got[k], want[k]) for k in want if not _same(got[k],
                                                              want[k])}
    assert not differ


@pytest.mark.parametrize("name", list(IGNORED))
def test_ignored_fields_are_accepted(name):
    """Each accepted-and-ignored field constructs with a value other
    than its default and is a field of the JAX class too."""
    jcls, tcls = CLASSES[name]
    for field, value in IGNORED[name].items():
        assert field in _defaults(jcls)
        assert getattr(tcls(**{field: value}), field) == value


def test_scan_unroll_leaves_the_solve_unchanged():
    """L-BFGS on a convex quadratic with scan_unroll 1 and 4: the same
    iterates to the bit."""
    a = torch.as_tensor(np.random.default_rng(0).uniform(0.5, 3.0, (3, 6)),
                        dtype=torch.float64)

    def fun(x):
        return 0.5 * (a * x * x).sum(-1), a * x

    x0 = torch.ones((3, 6), dtype=torch.float64)
    runs = [tlbfgs.minimize(fun, x0, tlbfgs.LBFGSParams(
        mem_size=4, max_iterations=20, scan_unroll=u)) for u in (1, 4)]
    for a_, b_ in zip(*runs):
        assert torch.equal(a_, b_)


def _stage_fields(stage) -> tuple:
    cfg, *rest = stage
    return (dataclasses.asdict(cfg), *rest)


@pytest.mark.parametrize("schedule", [
    ("default_stages", (40,), {}),
    ("default_stages", (40,), {"scan_dtype": None}),
    ("default_stages", (80,), {}),
    ("default_stages_lowlat", (50,), {}),
    ("default_stages_lowlat", (50,), {"scan_dtype": None})],
    ids=lambda s: f"{s[0]}{s[1]}{'-f32' if s[2] else ''}")
def test_default_stage_schedules_match_jax(schedule):
    fn, args, kw = schedule
    want = getattr(jbatch, fn)(*args, **kw)
    got = getattr(pb, fn)(*args, **kw)
    assert [_stage_fields(s) for s in got] == [_stage_fields(s)
                                               for s in want]
