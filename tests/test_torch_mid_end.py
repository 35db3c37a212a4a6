"""Port parity: the mid end (planner/mid_end.py), float64.

On the Circle corridor of tests/test_planner_e2e.py (a wall with a gap,
start (3.5, 3.5), goal (20.5, 12.5)), the A* path's 3 m waypoints and
their yaw references feed both packages:

  * ``make_cost_fn``'s value and autograd gradient at random decision
    vectors against the JAX cost and ``jax.grad`` at rtol 1e-10, with
    the attitude term off (the default) and on;
  * ``optimize`` from the same waypoints for 60 iterations: equal
    iteration counts, opt_x and cost at rtol 1e-8.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svsdf_tpu.planner import mid_end as jmid
from svsdf_tpu.utils.config import PlannerConfig as JPlannerConfig
from svsdf_tpu_torch import convert
from svsdf_tpu_torch.planner import mid_end
from svsdf_tpu_torch.planner.pipeline import Planner, _rotz
from svsdf_tpu_torch.utils.config import PlannerConfig

torch.set_num_threads(1)

START, GOAL = np.array([3.5, 3.5, 0.0]), np.array([20.5, 12.5, 0.0])


def corridor():
    """tests/test_planner_e2e.py::_scenario: config fields and map."""
    pts = []
    for x in range(24):
        for z in range(2):
            if not (10 <= x <= 13):
                pts.append((x + 0.5, 7.2, z + 0.5))
    pts += [(0.05, 0.05, 0.05), (23.9, 15.9, 1.9)]
    cfg = dict(inputdata="shapes/Circle.obj", kernel_size=7,
               kernel_yaw_num=4, occupancy_resolution=1.0, safety_hor=0.4,
               inittime=1.5)
    return cfg, np.asarray(pts)


@pytest.fixture(scope="module")
def problem():
    """(head, tail, waypoints, times, ref_rots) of the corridor's plan,
    as the pipeline builds them."""
    fields, pts = corridor()
    pl = Planner(PlannerConfig(**fields), pts, device="cpu",
                 dtype=torch.float64)
    front = pl.generate_path(START, GOAL)
    assert front.success
    q = pl._subsample(front.path, 3.0)
    head, tail = np.zeros((3, 3)), np.zeros((3, 3))
    head[0], tail[0] = front.path[0], front.path[-1]
    head[0, :2], tail[0, :2] = START[:2], GOAL[:2]
    times = np.full(len(q) + 1, fields["inittime"])
    rots = np.stack([_rotz(w[2]) for w in q])
    return fields, head, tail, q, times, rots


@pytest.mark.parametrize("weight_ar", [0.0, 2.0], ids=["default",
                                                       "attitude"])
def test_cost_and_gradient_match_jax(problem, weight_ar):
    fields, head, tail, q, times, rots = problem
    fields = dict(fields, weight_ar=weight_ar)
    cfg = convert.planner_config_from_dict(fields)
    jcfg = JPlannerConfig(**fields)
    n = len(q) + 1
    rng = np.random.default_rng(3)
    xs = np.concatenate([rng.normal(0, 0.3, (4, n)),
                         q.reshape(1, -1) + rng.normal(0, 0.5,
                                                       (4, 3 * (n - 1)))],
                        axis=1)
    t = lambda a: torch.as_tensor(a)[None].expand(4, *np.shape(a))
    prob = mid_end.MidEndProblem(t(head), t(tail), t(q), t(rots))
    cost = mid_end.make_cost_fn(prob, cfg)
    xt = torch.as_tensor(xs).requires_grad_(True)
    f = cost(xt)
    (g,) = torch.autograd.grad(f.sum(), xt)
    jprob = jmid.MidEndProblem(*(jnp.asarray(a) for a in
                                 (head, tail, q, rots)))
    jvg = jax.jit(jax.value_and_grad(jmid.make_cost_fn(jprob, jcfg)))
    for b in range(4):
        jf, jg = jvg(jnp.asarray(xs[b]))
        np.testing.assert_allclose(float(f[b].detach()), float(jf),
                                   rtol=1e-10)
        np.testing.assert_allclose(g[b].numpy(), np.asarray(jg),
                                   rtol=1e-10, atol=1e-10 * float(
                                       np.abs(np.asarray(jg)).max()))


def test_optimize_matches_jax(problem):
    fields, head, tail, q, times, rots = problem
    cfg = convert.planner_config_from_dict(fields)
    jres = jmid.optimize(head, tail, q, times, rots, JPlannerConfig(**fields),
                         max_iters=60)
    res = mid_end.optimize(head[None], tail[None], q[None], times[None],
                           rots[None], cfg, max_iters=60, device="cpu",
                           dtype=torch.float64)
    assert int(res.n_iters[0]) == int(jres.n_iters)
    np.testing.assert_allclose(float(res.cost[0]), float(jres.cost),
                               rtol=1e-8)
    np.testing.assert_allclose(res.opt_x[0].numpy(), np.asarray(jres.opt_x),
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(res.traj.coeffs[0].numpy(),
                               np.asarray(jres.traj.coeffs), rtol=1e-8,
                               atol=1e-8)
    # the waypoint pull held the junctions near the A* waypoints, and
    # the identity ref_rots default equals passing identities
    junctions = res.traj.coeffs[0, 1:, 0, :].numpy()
    assert np.abs(junctions[:, :2] - q[:, :2]).max() < 1.0
    eye = mid_end.optimize(head[None], tail[None], q[None], times[None],
                           None, dataclasses.replace(cfg, weight_ar=1.0),
                           max_iters=3, device="cpu", dtype=torch.float64)
    eye2 = mid_end.optimize(head[None], tail[None], q[None], times[None],
                            np.tile(np.eye(3), (1, len(q), 1, 1)),
                            dataclasses.replace(cfg, weight_ar=1.0),
                            max_iters=3, device="cpu", dtype=torch.float64)
    torch.testing.assert_close(eye.opt_x, eye2.opt_x, rtol=0, atol=0)
