"""Port parity: the back-end cost (planner/back_end.py), float64.

Two plans of the main path's problem set (the port's copy of bench.py's
``_problem``) at a random x: ``make_cost_pair_fn``'s full cost with its
gradient and ``OracleState``, its frozen surrogate at a nearby trial
point, and ``make_cost_fn``, for the fast stage's SVSDF configuration
(outside only) and the polish stage's (GSIP on the 6 most interior
points), against the JAX package's, plan by plan, at rtol 1e-8.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svsdf_tpu.models import shapes as jshapes
from svsdf_tpu.planner import back_end as jbe
from svsdf_tpu.parallel import batch as jbatch
from svsdf_tpu.utils.config import PlannerConfig as JPlannerConfig
from svsdf_tpu_torch import convert
from svsdf_tpu_torch.bench import BENCH_MEM_SIZE, problem
from svsdf_tpu_torch.parallel import batch as pb
from svsdf_tpu_torch.planner import back_end

torch.set_num_threads(1)

B, N, M = 2, 5, 32
RTOL = 1e-8


@pytest.fixture(scope="module")
def case():
    h, t, o, x0 = (a.astype(np.float64) for a in problem(N, M, B, seed=3))
    rng = np.random.default_rng(4)
    x = x0 + rng.normal(0, 0.05, x0.shape)
    step = rng.normal(0, 0.02, x0.shape)
    return h, t, o, x, step


def _stage(i):
    return (pb.default_stages(10, scan_dtype=None)[i][0],
            jbatch.default_stages(10, scan_dtype=None)[i][0])


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=1e-10)


@pytest.mark.parametrize("stage", [0, 1], ids=["fast", "polish"])
def test_cost_pair_matches_jax(case, stage):
    h, t, o, x, step = case
    svs, jsvs = _stage(stage)
    cfg = convert.planner_config_from_dict(
        {"mem_size": BENCH_MEM_SIZE, "not_a_field": 1})
    jcfg = JPlannerConfig(mem_size=BENCH_MEM_SIZE)
    prob, xt = convert.problem_from_numpy(h, t, o, x, device="cpu",
                                          dtype=torch.float64)
    heart = convert.shape_from_spec("sdHeart")
    full, frozen = back_end.make_cost_pair_fn(heart, prob, cfg, svs, N)
    f, g, st = full(xt)
    f2, g2 = frozen(xt + torch.as_tensor(step), st)
    f_plain = back_end.make_cost_fn(heart, prob, cfg, svs, N)(xt)
    torch.testing.assert_close(f_plain, f, rtol=1e-12, atol=0)
    if stage == 1:
        assert bool((st.sdf0 < 0).any(dim=1).all())

    jheart = jshapes.make_shape("sdHeart")

    def pair(i, xx, prob_arrays, *st_):
        jprob = jbe.BackEndProblem(*prob_arrays)
        fns = jbe.make_cost_pair_fn(jheart, jprob, jcfg, jsvs, N)
        return fns[i](xx, *st_)

    jfull = jax.jit(functools.partial(pair, 0))
    jfrozen = jax.jit(functools.partial(pair, 1))
    for b in range(B):
        arrays = (jnp.asarray(h[b]), jnp.asarray(t[b]), jnp.asarray(o[b]))
        jf, jg, jst = jfull(jnp.asarray(x[b]), arrays)
        _close(f[b], jf)
        _close(g[b], jg)
        for name in jst._fields:
            _close(getattr(st, name)[b], getattr(jst, name))
        jf2, jg2 = jfrozen(jnp.asarray(x[b] + step[b]), arrays, jst)
        _close(f2[b], jf2)
        _close(g2[b], jg2)


def test_cost_rows_repeat_plans_lane_major(case):
    """R = B*C rows (the parallel line search) price plan r // C."""
    h, t, o, x, _ = case
    prob, xt = convert.problem_from_numpy(h, t, o, x, device="cpu",
                                          dtype=torch.float64)
    svs, _ = _stage(0)
    cost = back_end.make_cost_fn(convert.shape_from_spec("sdHeart"), prob,
                                 convert.planner_config_from_dict({}), svs,
                                 N)
    one = cost(xt)
    torch.testing.assert_close(cost(xt.repeat_interleave(3, dim=0)),
                               one.repeat_interleave(3), rtol=0, atol=0)
