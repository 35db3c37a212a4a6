"""Port parity: the whole slice, ``plan_batch_staged``, float64.

Two plans of the main path's problem set (the port's copy of bench.py's
``_problem``: sdHeart, n=8 pieces, M=64 obstacle points,
``PlannerConfig(mem_size=8)``) are solved by the port and by the JAX
package under ``default_stages(10, scan_dtype=None)``: the fast stage
(outside-only SVSDF, table parabola) then the polish stage (two wide
rounds, GSIP on the 6 most interior points), each with the frozen-oracle
parallel line search. Both sides run the same arithmetic in float64, so
the final cost agrees at rtol 1e-4, x at atol 1e-3 and the last stage's
iteration count exactly (measured on this problem: 1e-13 apart).
"""

import numpy as np
import torch

import jax.numpy as jnp

from svsdf_tpu.models import shapes as jshapes
from svsdf_tpu.parallel import batch as jbatch
from svsdf_tpu.planner.back_end import BackEndProblem as JBackEndProblem
from svsdf_tpu.utils.config import PlannerConfig as JPlannerConfig
from svsdf_tpu_torch import convert
from svsdf_tpu_torch.bench import BENCH_MEM_SIZE, problem
from svsdf_tpu_torch.parallel import batch as pb
from svsdf_tpu_torch.planner import back_end
from svsdf_tpu_torch.utils.config import PlannerConfig

torch.set_num_threads(1)

B, N, M, ITERS = 2, 8, 64, 10


def test_plan_batch_staged_matches_jax():
    h, t, o, x0 = (a.astype(np.float64) for a in problem(N, M, B))
    jres = jbatch.plan_batch_staged(
        jshapes.make_shape("sdHeart"), jnp.asarray(x0),
        JBackEndProblem(jnp.asarray(h), jnp.asarray(t), jnp.asarray(o)),
        JPlannerConfig(mem_size=BENCH_MEM_SIZE),
        jbatch.default_stages(ITERS, scan_dtype=None), N)
    prob, x = convert.problem_from_numpy(h, t, o, x0, device="cpu",
                                         dtype=torch.float64)
    res = pb.plan_batch_staged(
        convert.shape_from_spec("sdHeart"), x, prob,
        PlannerConfig(mem_size=BENCH_MEM_SIZE),
        pb.default_stages(ITERS, scan_dtype=None), N, device="cpu")

    assert res.opt_x.shape == (B, 4 * N - 3)
    assert res.traj.coeffs.shape == (B, N, 6, 3)
    assert bool(torch.isfinite(res.cost).all())
    np.testing.assert_allclose(res.cost.numpy(), np.asarray(jres.cost),
                               rtol=1e-4)
    np.testing.assert_array_equal(res.n_iters.numpy(),
                                  np.asarray(jres.n_iters))
    np.testing.assert_allclose(res.opt_x.numpy(), np.asarray(jres.opt_x),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(res.traj.coeffs.numpy(),
                               np.asarray(jres.traj.coeffs), atol=1e-3,
                               rtol=1e-6)
    # the solve moved: the polish stage's cost fell from its start
    start = back_end.make_cost_fn(
        convert.shape_from_spec("sdHeart"), prob,
        PlannerConfig(mem_size=BENCH_MEM_SIZE),
        pb.default_stages(ITERS, scan_dtype=None)[1][0], N)(x)
    assert bool((res.cost < start).all())
