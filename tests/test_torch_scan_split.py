"""The coarse-scan kernel's algorithm on the CPU (ops/cuda_svsdf.py).

The kernel (csrc/coarse_scan.cu) splits each point's K poses across S
lanes of a warp, combines the lanes' first minima by a lexicographic
butterfly and recomputes the argmin's neighbours.
``coarse_scan_split_reference`` models exactly that in plain PyTorch.
Here it is held:

  * bit for bit against the plain version ``coarse_scan_reference`` for
    every S on inputs built to tie, and its reduction ``split_argmin``
    against ``torch.min`` on matrices with all-+inf rows and signed zeros;
  * against the JAX package's ``pallas_svsdf.coarse_scan_reference`` on
    the same numpy inputs, at 1e-5 (XLA's CPU compile may contract to
    fused multiply-adds, so not bit for bit);
  * ``launch_geometry`` within the card's limits at every shape the paths
    launch;
  * the grid query's set-up (``bench.grid_setup``) and ``svsdf_grid``
    against the JAX bench's trajectory and ``svsdf_query``.

The kernel itself is held against the plain version on a card by
tests/test_torch_cuda_kernel.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svsdf_tpu.models import shapes as jshapes
from svsdf_tpu.ops import minco as jminco
from svsdf_tpu.ops import pallas_svsdf as jps
from svsdf_tpu.ops import svsdf as jsv
from svsdf_tpu_torch import convert
from svsdf_tpu_torch.bench import grid_setup
from svsdf_tpu_torch.ops import cuda_svsdf as cs
from svsdf_tpu_torch.ops import svsdf as sv

torch.set_num_threads(1)

LANES = [1, 2, 4, 8, 16, 32]
BODIES = ["sdHeart", "Circle", "Polygon", "sdPie"]
PRE = (0.3, -0.2, 25.0)


def _tie_case(b, m, k, seed):
    """Numpy inputs built to tie: every pose appears twice in a row, a
    third of the points lie by the first pose (argmin 0) and a third by
    the last (argmin K-1 when K is odd), the rest in [-6, 6]^2."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, k)[np.arange(k) // 2][None]
    ph = rng.uniform(0, 2, (b, 1))
    xy = np.stack([8 * t - 4 + ph, 2 * np.sin(5 * t + ph)], -1)
    yaw = 2.0 * np.sin(3 * t + ph)
    third = m // 3
    near = lambda i: xy[:, i:i + 1] + rng.uniform(-0.3, 0.3, (b, third, 2))
    pts = np.concatenate([near(0), near(k - 1),
                          rng.uniform(-6, 6, (b, m - 2 * third, 2))], 1)
    return pts, xy, yaw


def _torch(pts, xy, yaw):
    f = lambda a: torch.as_tensor(a, dtype=torch.float32)
    yaw_t = f(yaw)
    return f(pts), f(xy), torch.cos(yaw_t), torch.sin(yaw_t)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("s", LANES)
@pytest.mark.parametrize("name", BODIES)
def test_split_model_equals_plain_bit_for_bit(name, s):
    """Duplicated poses, minima at k=0 and K-1, K < S and K not a
    multiple of S."""
    shape = convert.shape_from_spec(name, poly_params=PRE)
    for k in (1, 3, 37, 64):
        inp = _torch(*_tie_case(3, 301, k, seed=k))
        got = cs.coarse_scan_split_reference(shape, *inp, s)
        want = cs.coarse_scan_reference(shape, *inp)
        assert torch.equal(got[1], want[1])
        for a, b in zip(got[::2] + got[3:], want[::2] + want[3:]):
            assert torch.equal(_bits(a), _bits(b))


def _tie_matrices(k, seed):
    """(R, K) float32 rows: all +inf, signed zeros in both orders, all
    equal, values from {0, 1, 2} (ties everywhere), the minimum last, and
    random values."""
    rng = np.random.default_rng(seed)
    zeros = np.where(rng.uniform(size=k) < 0.5, 0.0, -0.0)
    rows = [np.full(k, np.inf), zeros, -zeros, np.full(k, 0.5),
            rng.integers(0, 3, k).astype(float),
            np.r_[np.full(k - 1, 5.0), 1.0][-k:],
            np.r_[-0.0, np.full(k - 1, np.inf)][:k],
            np.r_[np.full(k - 1, np.inf), -0.0][-k:],
            rng.normal(size=k)]
    return torch.as_tensor(np.stack(rows), dtype=torch.float32)


@pytest.mark.parametrize("s", LANES)
def test_split_argmin_equals_torch_min_on_tie_matrices(s):
    for k in (1, 2, 3, 31, 37, 64):
        f = _tie_matrices(k, seed=k)[None]                  # (1, R, K)
        best, arg = cs.split_argmin(f, s)
        want, want_arg = torch.min(f, dim=-1)
        assert torch.equal(arg, want_arg)
        # the winner's own bits: -0.0 and +0.0 are told apart
        assert torch.equal(_bits(best), _bits(want))


@pytest.mark.parametrize("s", LANES)
def test_split_argmin_nan_never_wins(s):
    """As the sequential strict `<` of the kernel (torch.min would return
    the NaN): a NaN is passed over, and a row of NaNs gives (+inf, 0)."""
    nan = float("nan")
    f = torch.tensor([[nan, 2.0, 1.0, nan, 1.0], [nan] * 5])
    best, arg = cs.split_argmin(f, s)
    assert best.tolist() == [1.0, float("inf")]
    assert arg.tolist() == [2, 0]


#: (B, M, K) of every coarse scan chip_smoke.py's paths launch or time:
#: the main and e2e paths' stages and GSIP rounds, the single plan's back
#: end and certificate, replans (batch 1 and the line search's 4), the
#: grid query, the phase-3 parity cases and the card tests' shapes
PATH_SHAPES = [(512, 64, 96), (512, 64, 128), (512, 12, 32), (512, 36, 32),
               (512, 108, 32), (512, 48, 96), (512, 48, 128), (512, 48, 192),
               (1, 768, 128), (1, 512, 128), (1, 16, 64), (1, 48, 64),
               (1, 45, 96), (4, 45, 96), (1, 160, 128), (4, 160, 128),
               (1, 160, 192), (32, 64, 96), (32, 64, 128), (32, 12, 32),
               (1, 65536, 256), (1, 7, 37), (1, 1024, 37), (1, 2000, 37),
               (1, 4096, 64), (3, 1000, 37), (4, 100, 5), (1, 1, 1),
               (2, 500, 3)]
#: the lane counts the design expects at the shapes that matter most
EXPECTED_S = {(512, 64, 96): 4, (512, 12, 32): 8, (1, 768, 128): 32,
              (1, 512, 128): 32, (1, 65536, 256): 2}


@pytest.mark.parametrize("shape", PATH_SHAPES,
                         ids=lambda c: "x".join(map(str, c)))
def test_launch_geometry_within_limits(shape):
    b, m, k = shape
    s, threads, (gx, gy) = cs.launch_geometry(b, m, k)
    cap = min(32, max(1, k // 4))
    assert s & (s - 1) == 0 and 1 <= s <= min(32, k) and s <= cap
    # the smallest S that brings TARGET_THREADS, unless capped
    assert b * m * s >= cs.TARGET_THREADS or 2 * s > cap
    assert s == 1 or b * m * (s // 2) < cs.TARGET_THREADS
    assert threads % 32 == 0 and 32 <= threads <= cs.MAX_THREADS <= 1024
    per_block = threads // s
    assert gy == b and gx * per_block >= m > (gx - 1) * per_block
    # the block's pose table: a float4 record a pose, and 6 floats for
    # each of the fallback Polygon's 4 edges, within 48 KB
    assert 16 * k + 24 * 4 <= 48 * 1024
    if shape in EXPECTED_S:
        assert s == EXPECTED_S[shape]


def _jax_matrix(js, pts, xy, yaw):
    """pallas_svsdf.coarse_scan_reference's (M, K) matrix, float32."""
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    pts, xy, yaw = f32(pts), f32(xy), f32(yaw)
    d = pts[:, None, :] - xy[None]
    c, s = jnp.cos(yaw), jnp.sin(yaw)
    prx = c[None] * d[..., 0] + s[None] * d[..., 1]
    pry = -s[None] * d[..., 0] + c[None] * d[..., 1]
    return np.asarray(jps._sdf_xy(js, prx, pry))


@pytest.mark.parametrize("s", [1, 8, 32])
@pytest.mark.parametrize("name", BODIES)
def test_split_model_agrees_with_jax_reference(name, s):
    js = jshapes.make_shape(name, poly_params=PRE)
    shape = convert.shape_from_spec(name, poly_params=PRE)
    pts, xy, yaw = _tie_case(2, 301, 37, seed=s)
    mn, ar, _, _ = cs.coarse_scan_split_reference(shape,
                                                  *_torch(pts, xy, yaw), s)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    for b in range(2):
        mn_j, _ = jps.coarse_scan_reference(js, f32(pts[b]), f32(xy[b]),
                                            f32(yaw[b]))
        mn_j = np.asarray(mn_j)
        np.testing.assert_allclose(mn[b].numpy(), mn_j, atol=1e-5, rtol=0)
        f_j = _jax_matrix(js, pts[b], xy[b], yaw[b])
        at_split = np.take_along_axis(f_j, ar[b].numpy()[:, None], 1)[:, 0]
        np.testing.assert_allclose(at_split, mn_j, atol=1e-5, rtol=0)


def test_grid_setup_and_svsdf_grid_match_the_jax_bench():
    """bench.py::bench_grid_queries' trajectory and field, on a 24 x 20
    grid at K=64 with 3 refinement rounds, float32 on both sides."""
    g = grid_setup(grid=24, device="cpu")
    n = 6
    head = jnp.zeros((3, 3), jnp.float32)
    tail = jnp.asarray([[10.0, 0.0, 1.0], [0.0] * 3, [0.0] * 3], jnp.float32)
    frac = np.linspace(0, 1, n + 1)[1:-1]
    wps = jnp.asarray(np.stack([10 * frac, np.sin(5 * frac), frac], -1),
                      jnp.float32)
    jtraj = jminco.solve(jnp.full((n,), 1.5, jnp.float32), head, tail, wps)
    np.testing.assert_allclose(g.traj.coeffs[0].numpy(),
                               np.asarray(jtraj.coeffs), rtol=1e-4,
                               atol=1e-4)
    cfg = dict(coarse_n=64, refine_rounds=3)
    field = sv.svsdf_grid(g.shape, g.traj, g.xs, g.ys[:20],
                          sv.SVSDFConfig(**cfg))
    assert field.shape == (1, 24, 20) and bool(torch.isfinite(field).all())
    gx, gy = np.meshgrid(g.xs.numpy(), g.ys[:20].numpy(), indexing="ij")
    pts = jnp.asarray(np.stack([gx.ravel(), gy.ravel()], -1))
    want = jsv.svsdf_query(jshapes.make_shape("sdHeart"), jtraj, pts,
                           jsv.SVSDFConfig(**cfg), with_inside=False).sdf
    np.testing.assert_allclose(field[0].numpy().ravel(), np.asarray(want),
                               atol=1e-4, rtol=0)
