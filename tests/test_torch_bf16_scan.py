"""Port parity: the bfloat16 coarse scan, the JAX package's default
(``default_stages`` and ``default_stages_lowlat`` scan in bfloat16).

  * the plain scan's (B, M, K) matrix at ``scan_dtype="bfloat16"``
    against the JAX package's ``_sdf_from_table(dtype="bfloat16")``, bit
    for bit for the 17 analytic bodies, with and without a pre-transform
    (PyTorch keeps a Python constant in float32 against a bfloat16 tensor
    where JAX rounds it first: models/shapes.py ``_k`` follows JAX).
    Polygon computes in float32 against its float32 vertices on both
    sides; XLA's CPU compile contracts its segment foot w - e t into fused
    multiply-adds, so it is held at one float32 ulp (ROADMAP C);
  * the scan's outputs (min, first argmin, neighbours) against JAX's
    argmin / min / take_along_axis on the same bfloat16 matrix;
  * the kernel's algorithm (``coarse_scan_split_reference``: K split
    across S lanes, the butterfly, recomputed neighbours) bit for bit
    against the plain version in bfloat16 on inputs built to tie, for
    every S, rigid and deformable;
  * a B=4 ``plan_batch_staged`` at ``default_stages(8)`` (bfloat16 scans,
    float64 elsewhere) against the JAX package's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svsdf_tpu.models import shapes as jshapes
from svsdf_tpu.ops import svsdf as jsv
from svsdf_tpu.parallel import batch as jbatch
from svsdf_tpu.planner.back_end import BackEndProblem as JBackEndProblem
from svsdf_tpu.utils.config import PlannerConfig as JPlannerConfig
from svsdf_tpu_torch import convert
from svsdf_tpu_torch.bench import BENCH_MEM_SIZE, problem
from svsdf_tpu_torch.models import shapes
from svsdf_tpu_torch.ops import cuda_svsdf as cs
from svsdf_tpu_torch.parallel import batch as pb
from svsdf_tpu_torch.utils.config import PlannerConfig

torch.set_num_threads(1)

BF16 = torch.bfloat16
BODIES = list(jshapes.shape_names()) + ["Polygon"]
PRES = [(0.0, 0.0, 0.0), (0.3, -0.2, 25.0)]


def _case(m, k, seed=0):
    """Points in [-6, 6]^2 and a wiggly pose path, float32."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-6, 6, (m, 2)).astype(np.float32)
    t = np.linspace(0.0, 1.0, k)
    xy = np.stack([8 * t - 4, 2 * np.sin(5 * t)], -1).astype(np.float32)
    yaw = (2.0 * np.sin(3 * t)).astype(np.float32)
    return pts, xy, np.cos(yaw), np.sin(yaw), t.astype(np.float32)


def _jax_matrix(name, pre, pts, xy, c, s, t):
    table = jsv.PoseTable(jnp.asarray(t), jnp.asarray(xy), jnp.asarray(c),
                          jnp.asarray(s))
    return np.asarray(jsv._sdf_from_table(
        jshapes.make_shape(name, poly_params=pre), table, jnp.asarray(pts),
        dtype="bfloat16")).astype(np.float32)


@pytest.mark.parametrize("pre", PRES, ids=["pre0", "pre"])
@pytest.mark.parametrize("name", BODIES)
def test_bf16_matrix_matches_jax_table_scan(name, pre):
    pts, xy, c, s, t = _case(512, 96, seed=len(name))
    want = _jax_matrix(name, pre, pts, xy, c, s, t)
    f = lambda a: torch.as_tensor(a)[None].to(BF16)
    got = cs.scan_matrix(shapes.make_shape(name, poly_params=pre), f(pts),
                         f(xy), f(c), f(s))[0]
    if name == "Polygon":
        # float32 on both sides: bf16 points against float32 vertices
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=4.8e-7)
        return
    assert got.dtype == BF16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("name", BODIES)
def test_bf16_scan_outputs_match_jax(name):
    """min, first argmin and the clipped neighbours, back in float32."""
    pre = PRES[1]
    pts, xy, c, s, t = _case(300, 37, seed=7)
    d = _jax_matrix(name, pre, pts, xy, c, s, t)
    f = lambda a: torch.as_tensor(a)[None]
    mn, ar, fm, fp = cs.coarse_scan_reference(
        shapes.make_shape(name, poly_params=pre), f(pts), f(xy), f(c), f(s),
        scan_dtype="bfloat16")
    assert mn.dtype == fm.dtype == fp.dtype == torch.float32
    i = d.argmin(1)
    k = d.shape[1]
    at = lambda idx: np.take_along_axis(d, idx[:, None], 1)[:, 0]
    if name == "Polygon":
        # argmins may differ only where two poses tie within an ulp
        diff = ar[0].numpy() != i
        assert np.abs(at(ar[0].numpy()) - d.min(1))[diff].max(
            initial=0.0) <= 4.8e-7
        np.testing.assert_allclose(mn[0].numpy(), d.min(1), atol=4.8e-7,
                                   rtol=0)
        return
    np.testing.assert_array_equal(ar[0].numpy(), i)
    np.testing.assert_array_equal(mn[0].numpy(), d.min(1))
    np.testing.assert_array_equal(fm[0].numpy(),
                                  at(np.clip(i - 1, 0, k - 1)))
    np.testing.assert_array_equal(fp[0].numpy(),
                                  at(np.clip(i + 1, 0, k - 1)))


def _tie_case(b, m, k, seed):
    """Inputs built to tie (tests/test_torch_scan_split.py::_tie_case):
    every pose twice in a row, a third of the points by the first pose
    and a third by the last; bfloat16 rounding adds ties of its own."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, k)[np.arange(k) // 2][None]
    ph = rng.uniform(0, 2, (b, 1))
    xy = np.stack([8 * t - 4 + ph, 2 * np.sin(5 * t + ph)], -1)
    yaw = 2.0 * np.sin(3 * t + ph)
    third = m // 3
    near = lambda i: xy[:, i:i + 1] + rng.uniform(-0.3, 0.3, (b, third, 2))
    pts = np.concatenate([near(0), near(k - 1),
                          rng.uniform(-6, 6, (b, m - 2 * third, 2))], 1)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32)
    y = f(yaw)
    ts = f(np.broadcast_to(12.0 * t, (b, k)).copy())
    return (f(pts), f(xy), torch.cos(y), torch.sin(y)), ts


@pytest.mark.parametrize("s", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("name", ["sdHeart", "Circle", "Polygon", "sdPie",
                                  "star"])
def test_split_model_bf16_ties_bit_for_bit(name, s):
    shape = shapes.make_shape(name, poly_params=PRES[1])
    scaled = shapes.make_scaled_shape(
        name, lambda t: 1.0 + 0.35 * torch.sin(0.9 * t),
        poly_params=PRES[1])
    ties = 0
    for k in (1, 3, 37, 64):
        inp, ts = _tie_case(3, 301, k, seed=k)
        for sh in (shape, scaled):
            got = cs.coarse_scan_split_reference(sh, *inp, s, "bfloat16", ts)
            want = cs.coarse_scan_reference(sh, *inp, "bfloat16", ts)
            assert torch.equal(got[1], want[1])
            for a, b in zip(got[::2] + got[3:], want[::2] + want[3:]):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        if k > 1:
            m = cs.scan_matrix(shape, *(v.to(BF16) for v in inp))
            ties += int((m == m.min(-1, keepdim=True).values).sum(-1).gt(
                1).sum())
    assert ties > 100       # the minima tie, beyond the duplicated poses


def test_plan_batch_staged_default_stages_matches_jax():
    """B=4 plans, default_stages(8): the fast and polish stages' scans in
    bfloat16 (GSIP's boundary scans inherit it) on both sides, float64
    elsewhere. Under the tests' x64 mode the JAX solve of float32 inputs
    promotes part of its arithmetic to float64, so a float32 run is not
    like for like; in float64 the two solves are 3.5e-8 apart in cost and
    5.6e-7 in x on this problem: held at rtol 1e-6 and atol 1e-5, with
    equal iteration counts."""
    b, n, m = 4, 8, 64
    h, t, o, x0 = (a.astype(np.float64) for a in problem(n, m, b))
    stages = pb.default_stages(8)
    assert all(st[0].scan_dtype == "bfloat16" for st in stages)
    jres = jbatch.plan_batch_staged(
        jshapes.make_shape("sdHeart"), jnp.asarray(x0),
        JBackEndProblem(*(jnp.asarray(a) for a in (h, t, o))),
        JPlannerConfig(mem_size=BENCH_MEM_SIZE), jbatch.default_stages(8), n)
    prob, x = convert.problem_from_numpy(h, t, o, x0, device="cpu",
                                         dtype=torch.float64)
    res = pb.plan_batch_staged(convert.shape_from_spec("sdHeart"), x, prob,
                               PlannerConfig(mem_size=BENCH_MEM_SIZE),
                               stages, n, device="cpu")
    assert res.cost.dtype == torch.float64
    assert bool(torch.isfinite(res.cost).all())
    np.testing.assert_array_equal(res.n_iters.numpy(),
                                  np.asarray(jres.n_iters))
    np.testing.assert_allclose(res.cost.numpy(), np.asarray(jres.cost),
                               rtol=1e-6)
    np.testing.assert_allclose(res.opt_x.numpy(), np.asarray(jres.opt_x),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("s", [1, 2, 4, 8, 16, 32])
def test_split_argmin_on_bf16_tie_rows(s):
    """The split reduction on bfloat16 rows that tie everywhere (values
    from {-1/4, ..., 1/4} in steps of 1/8, signed zeros in both orders,
    all +inf, the minimum last): the first argmin and the winner's bits
    of torch.min, for every S and odd and even per-lane counts (K < S
    included). The packed forms' pair order, (k, k+S) low half first
    with a +inf dead half after an odd count, takes the same k in the
    same order as a lane's plain walk, so this model is theirs too; the
    pair records' layout is held on the card."""
    rng = np.random.default_rng(s)
    ties = 0
    for k in (1, 2, 3, 5, 37, 64):
        rows = rng.integers(-2, 3, (60, k)) * 0.125
        rows[:4] = np.inf
        rows[4:12] = np.where(rng.uniform(size=(8, k)) < 0.5, 0.0, -0.0)
        rows[12:16, -1] = -1.0
        f = torch.as_tensor(rows, dtype=torch.float32).to(BF16)
        best, arg = cs.split_argmin(f, s)
        want, want_arg = torch.min(f, dim=-1)
        assert torch.equal(arg, want_arg)
        assert torch.equal(best.view(torch.int16), want.view(torch.int16))
        ties += int(((f == want[:, None]).sum(-1) > 1).sum())
    assert ties > 100
