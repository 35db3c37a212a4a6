"""Port parity: a mesh robot through the batch solve. ``plan_batch_staged``
with the sdHeart prism (svsdf_tpu_torch/bench.py ``write_prism_obj``, the
mesh robot ``chip_smoke.py`` drives) at B = 4 on the bench problem, in both
scan types, against the JAX package's.

Both sides run float64 outside the scans (JAX under the tests' x64 mode),
as tests/test_torch_bf16_scan.py does for the analytic bodies. The JAX
robot's field is held in float32 (``_F32Grid``): under x64 JAX keeps its
GridSDF2D field in float64, so its bfloat16 body would return float64
where the port's, like a JAX run outside x64, returns float32 products
of the bfloat16 weights with the float32 field. The float64 scans are the
same on both sides either way (the field's values are float32, widened
exactly).

The bfloat16 solve of the JAX package runs in a subprocess with XLA's
``--xla_allow_excess_precision=false --xla_backend_optimization_level=0``.
By default XLA may skip the rounding of a bfloat16 intermediate that a
float32 operation reads, and on the CPU it does so in the jitted mesh
body (the bilinear weights meet the float32 field):
``test_jit_excess_precision_is_the_difference`` shows it, 0.015-0.021 m
on the scan matrix, where the op-by-op evaluation equals the port's to
the bit (tests/test_torch_mesh_sdf.py). Without excess precision the
jitted body still differs by up to one float32 ulp at 4% of the entries
(LLVM contracts the bilinear sum into fused multiply-adds), enough to
move bfloat16 argmins and two of the four plans by 0.2% in cost; at
optimization level 0 the jitted body is the op-by-op one. The port and
its kernel round every bfloat16 operation, as the JAX source writes
them.

Tolerances: the iteration counts equal; the cost at rtol 1e-6 and x at
atol 1e-5, as for sdHeart's analytic body in test_torch_bf16_scan.py (the
two solves differ by rounding from the first iteration and the solve
amplifies it, ROADMAP C).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svsdf_tpu.models import mesh_sdf as jmesh
from svsdf_tpu.models import shapes as jshapes
from svsdf_tpu.ops import svsdf as jsv
from svsdf_tpu.parallel import batch as jbatch
from svsdf_tpu.planner.back_end import BackEndProblem as JBackEndProblem
from svsdf_tpu.utils.config import PlannerConfig as JPlannerConfig
from svsdf_tpu_torch import convert
from svsdf_tpu_torch.bench import BENCH_MEM_SIZE, problem, write_prism_obj
from svsdf_tpu_torch.models import mesh_sdf
from svsdf_tpu_torch.ops import cuda_svsdf as cs
from svsdf_tpu_torch.parallel import batch as pb
from svsdf_tpu_torch.utils.config import PlannerConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
B, N, M = 4, 8, 64


@dataclasses.dataclass(frozen=True)
class _F32Grid(jmesh.GridSDF2D):
    """The JAX package's GridSDF2D with its field in float32, the field
    it has outside x64 mode."""

    @property
    def field(self):
        return jnp.asarray(np.asarray(self.values, np.float32).reshape(
            self.nx, self.ny))


def _jax_robot(path):
    """The JAX package's mesh robot of ``path`` with a float32 field."""
    stock = jmesh.shape_from_mesh(path)
    g = stock.body_sdf.__self__
    grid = _F32Grid(**{f.name: getattr(g, f.name)
                       for f in dataclasses.fields(g)})
    return jshapes.Shape2D(name=stock.name, body_sdf=grid.sdf_xy)


@pytest.fixture(scope="module")
def robots(tmp_path_factory):
    path = write_prism_obj("sdHeart", str(
        tmp_path_factory.mktemp("mesh") / "heart_prism.obj"))
    return path, mesh_sdf.shape_from_mesh(path), _jax_robot(path)


#: the JAX package's bfloat16 staged solve, run where XLA rounds every
#: bfloat16 operation (argv: the robot's .obj, the problem's .npz)
_JAX_SOLVE = """
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
from svsdf_tpu.parallel import batch as jbatch
from svsdf_tpu.planner.back_end import BackEndProblem
from svsdf_tpu.utils.config import PlannerConfig
from tests.test_torch_mesh_slice import BENCH_MEM_SIZE, N, _jax_robot
p = np.load(sys.argv[2])
res = jbatch.plan_batch_staged(
    _jax_robot(sys.argv[1]), jnp.asarray(p["x0"]),
    BackEndProblem(*(jnp.asarray(p[k]) for k in ("h", "t", "o"))),
    PlannerConfig(mem_size=BENCH_MEM_SIZE),
    jbatch.default_stages(8, scan_dtype="bfloat16"), N)
np.savez(sys.argv[2], cost=np.asarray(res.cost),
         opt_x=np.asarray(res.opt_x), n_iters=np.asarray(res.n_iters))
"""


def _jax_bf16_solve(path, problems, tmp):
    npz = str(tmp / "problem.npz")
    np.savez(npz, **dict(zip("htox", problems[:3])), x0=problems[3])
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_allow_excess_precision=false"
                        " --xla_backend_optimization_level=0").strip()
    subprocess.run([sys.executable, "-c", _JAX_SOLVE, path, npz], cwd=ROOT,
                   env=env, check=True, timeout=900)
    return np.load(npz)


def _stages(scan_dtype):
    """default_stages(8) with the scans in ``scan_dtype`` (None: the
    solve's float64)."""
    return (pb.default_stages(8, scan_dtype=scan_dtype),
            jbatch.default_stages(8, scan_dtype=scan_dtype))


@pytest.fixture(scope="module")
def problems():
    h, t, o, x0 = (a.astype(np.float64) for a in problem(N, M, B, seed=3))
    return (h, t, o, x0)


@pytest.fixture(scope="module", params=[None, "bfloat16"],
                ids=["float64_scans", "bfloat16_scans"])
def solves(request, robots, problems, tmp_path_factory):
    path, shape, jshape = robots
    h, t, o, x0 = problems
    stages, jstages = _stages(request.param)
    if request.param is None:
        jres = jbatch.plan_batch_staged(
            jshape, jnp.asarray(x0),
            JBackEndProblem(*(jnp.asarray(a) for a in (h, t, o))),
            JPlannerConfig(mem_size=BENCH_MEM_SIZE), jstages, N)
        jres = {k: np.asarray(getattr(jres, k))
                for k in ("cost", "opt_x", "n_iters")}
    else:
        jres = _jax_bf16_solve(path, problems, tmp_path_factory.mktemp("j"))
    prob, x = convert.problem_from_numpy(h, t, o, x0, device="cpu",
                                         dtype=torch.float64)
    res = pb.plan_batch_staged(shape, x, prob,
                               PlannerConfig(mem_size=BENCH_MEM_SIZE),
                               stages, N, device="cpu")
    return request.param, res, jres


def test_mesh_plan_batch_staged_matches_jax(solves):
    scan_dtype, res, jres = solves
    assert res.cost.dtype == torch.float64
    assert bool(torch.isfinite(res.cost).all())
    np.testing.assert_array_equal(res.n_iters.numpy(), jres["n_iters"])
    np.testing.assert_allclose(res.cost.numpy(), jres["cost"], rtol=1e-6)
    np.testing.assert_allclose(res.opt_x.numpy(), jres["opt_x"], atol=1e-5,
                               rtol=0)


def test_jit_excess_precision_is_the_difference(robots):
    """Under jit with XLA's default excess precision the JAX package's
    bfloat16 mesh scan skips roundings that its op-by-op evaluation (and
    the port) make; op by op the two packages agree to the bit."""
    _, shape, jshape = robots
    rng = np.random.default_rng(0)
    pts = rng.uniform(-6, 6, (500, 2))
    t = np.linspace(0.0, 1.0, 96)
    xy = np.stack([8 * t - 4, 2 * np.sin(5 * t)], -1)
    yaw = 2 * np.sin(3 * t)
    table = jsv.PoseTable(*(jnp.asarray(a) for a in (t, xy, np.cos(yaw),
                                                     np.sin(yaw))))
    scan = lambda q: jsv._sdf_from_table(jshape, table, q, dtype="bfloat16")
    eager = np.asarray(scan(jnp.asarray(pts)))
    jitted = np.asarray(jax.jit(scan)(jnp.asarray(pts)))
    got = cs.scan_matrix(shape, *(torch.as_tensor(a)[None].to(torch.bfloat16)
                                  for a in (pts, xy, np.cos(yaw),
                                            np.sin(yaw))))[0]
    np.testing.assert_array_equal(got.numpy(), eager)
    assert np.abs(jitted - eager).max() > 1e-3


def test_mesh_solve_is_near_the_analytic_body(solves, problems):
    """The mesh robot is sdHeart up to its grid and facets: its solve's
    costs lie within 5% of the analytic body's on the same problems."""
    scan_dtype, res, _ = solves
    h, t, o, x0 = problems
    stages, _ = _stages(scan_dtype)
    prob, x = convert.problem_from_numpy(h, t, o, x0, device="cpu",
                                         dtype=torch.float64)
    ana = pb.plan_batch_staged(convert.shape_from_spec("sdHeart"), x, prob,
                               PlannerConfig(mem_size=BENCH_MEM_SIZE),
                               stages, N, device="cpu")
    np.testing.assert_allclose(res.cost.numpy(), ana.cost.numpy(),
                               rtol=0.05)
