"""Port parity: the back-end cost (planner/back_end.py), float64.

Two plans of the main path's problem set (the port's copy of bench.py's
``_problem``) at a random x: ``make_cost_pair_fn``'s full cost with its
gradient and ``OracleState``, its frozen surrogate at a nearby trial
point, and ``make_cost_fn``, for the fast stage's SVSDF configuration
(outside only) and the polish stage's (GSIP on the 6 most interior
points), against the JAX package's, plan by plan, at rtol 1e-8.

Then the single-plan solve ``optimize`` from the JAX mid end's warm
start on the Circle corridor of tests/test_planner_e2e.py: against the
JAX ``optimize`` at rtol 1e-8 with equal iteration counts, and its
sensitivity to a 1e-14 perturbation of the warm start at the pipeline's
settings.
"""

import dataclasses
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


@pytest.fixture(scope="module")
def corridor_warm_start():
    """The Circle corridor of tests/test_planner_e2e.py as the JAX
    pipeline feeds its back end: the JAX A* path and mid end, and the
    harvested obstacles padded as Planner._attempt pads them."""
    from svsdf_tpu.ops.svsdf import SVSDFConfig as JSVSDFConfig
    from svsdf_tpu.planner import mid_end as jmid
    from svsdf_tpu.planner.pipeline import Planner as JPlanner, _rotz
    from tests.test_torch_mid_end import GOAL, START, corridor

    fields, pts = corridor()
    jsvs = JSVSDFConfig(coarse_n=128, refine_rounds=2, gsip_iters=4,
                        gsip_coarse_n=48, gsip_refine_rounds=1)
    jpl = JPlanner(JPlannerConfig(**fields), pts, svs_cfg=jsvs)
    front = jpl.generate_path(START, GOAL)
    q = jpl._subsample(front.path, 3.0)
    obs = jpl._pad_obstacles(jpl._harvest(q), headroom=512)
    head, tail = np.zeros((3, 3)), np.zeros((3, 3))
    head[0], tail[0] = front.path[0], front.path[-1]
    head[0, :2], tail[0, :2] = START[:2], GOAL[:2]
    mid = jmid.optimize(head, tail, q, np.full(len(q) + 1,
                                               fields["inittime"]),
                        np.stack([_rotz(w[2]) for w in q]),
                        JPlannerConfig(**fields), max_iters=60)
    carried = convert.astar_result_from_numpy(*front)
    np.testing.assert_array_equal(carried.path, front.path)
    assert carried.expansions == front.expansions
    return fields, jpl.shape, jsvs, np.asarray(mid.opt_x), head, tail, obs


@pytest.mark.parametrize("kw", [
    {},
    {"mu_schedule": (0.1, 0.01), "weight_p": 240.0, "safety_hor": 0.5},
], ids=["default-ladder", "refine-overrides"])
def test_optimize_matches_jax(corridor_warm_start, kw):
    """The scheduled back-end solve from the JAX mid end's opt_x: the
    3-stage mu ladder (stages jump on convergence) and a certify-refine
    round's 2-stage ladder with weight and margin overrides. The stall
    tolerance is raised so each stage stops after a few iterations: over
    longer runs the solve amplifies rounding (tests/test_torch_pipeline.py)."""
    fields, jshape, jsvs, opt_x, head, tail, obs = corridor_warm_start
    fields = dict(fields, back_rel_stall=0.05)
    jres = jbe.optimize(jshape, head, tail, obs, opt_x,
                        JPlannerConfig(**fields), jsvs, max_iters=20, **kw)
    x, h, t = convert.warm_start_from_numpy(opt_x, head, tail, device="cpu",
                                            dtype=torch.float64)
    svs = convert.svsdf_config_from_dict(dataclasses.asdict(jsvs))
    res = back_end.optimize(convert.shape_from_spec("Circle"), h, t,
                            obs[None], x,
                            convert.planner_config_from_dict(fields), svs,
                            max_iters=20, device="cpu", dtype=torch.float64,
                            **kw)
    # 40 + 40 + 20 (or 40 + 20) iterations of budget: the early stages
    # jumped to their bounds
    assert int(res.n_iters[0]) == int(jres.n_iters) > 40
    np.testing.assert_allclose(float(res.cost[0]), float(jres.cost),
                               rtol=1e-8)
    np.testing.assert_allclose(res.opt_x[0].numpy(), np.asarray(jres.opt_x),
                               rtol=1e-7, atol=1e-7)
    assert bool(res.converged[0]) == bool(jres.converged)
    with pytest.raises(ValueError, match="unknown back-end solver"):
        back_end.optimize(convert.shape_from_spec("Circle"), h, t,
                          obs[None], x, device="cpu", solver="bfgs")


def test_optimize_amplifies_rounding_at_pipeline_settings(corridor_warm_start):
    """Why whole plans are compared at 1e-5 and not 1e-8: at the
    pipeline's own settings (stall tolerance 1e-6, 120 iterations in the
    last stage) a 1e-14 relative perturbation of the warm start moves the
    port's final cost far above rounding (1e-8 here), yet stays below the
    1e-5 at which tests/test_torch_pipeline.py holds the port to JAX."""
    fields, _, jsvs, opt_x, head, tail, obs = corridor_warm_start
    cfg = convert.planner_config_from_dict(fields)
    svs = convert.svsdf_config_from_dict(dataclasses.asdict(jsvs))
    rng = np.random.default_rng(0)
    costs = []
    for scale in (0.0, 1e-14):
        x0 = opt_x * (1.0 + scale * rng.standard_normal(opt_x.shape))
        x, h, t = convert.warm_start_from_numpy(x0, head, tail,
                                                device="cpu",
                                                dtype=torch.float64)
        res = back_end.optimize(convert.shape_from_spec("Circle"), h, t,
                                obs[None], x, cfg, svs, max_iters=120,
                                device="cpu", dtype=torch.float64)
        costs.append(float(res.cost[0]))
    rel = abs(costs[1] / costs[0] - 1.0)
    print(f"final cost moved by {rel:.3g} relative")
    assert 1e-8 < rel < 1e-5
