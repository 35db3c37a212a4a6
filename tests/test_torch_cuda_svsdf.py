"""Port parity: the batched coarse scan (ops/cuda_svsdf.py).

  * the plain PyTorch scan against the JAX package's
    ``coarse_scan_reference`` and its Pallas ``coarse_scan`` (interpret
    mode), on the cases of tests/test_pallas_svsdf.py for every shape
    body, float32 at atol 1e-5; argmins may differ only where two poses
    tie within that (the Pallas kernel refuses Polygon);
  * the batched form against the JAX oracle vmapped over plans;
  * the neighbour values f[argmin -/+ 1] against the JAX package's
    ``take_along_axis`` on the (M, K) table scan (ops/svsdf.py), float64.

The kernel itself is held against the plain version on a card by
tests/test_torch_cuda_kernel.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svsdf_tpu.models import shapes as jshapes
from svsdf_tpu.ops import pallas_svsdf as jps
from svsdf_tpu.ops import svsdf as jsv
from svsdf_tpu_torch import convert
from svsdf_tpu_torch.ops import cuda_svsdf as cs

torch.set_num_threads(1)

#: every body the kernel has: the 17 analytic shapes and Polygon (the
#: fallback thin rectangle)
_SHAPES = list(jshapes.shape_names()) + ["Polygon"]


def _case(m, k, seed=0, b=None):
    """tests/test_pallas_svsdf.py::_case (b=None), or b plans with a
    per-plan phase of the same wiggly pose path."""
    rng = np.random.default_rng(seed)
    if b is None:
        pts = rng.uniform(-6, 6, (m, 2))
        t = np.linspace(0.0, 1.0, k)
        xy = np.stack([8 * t - 4, 2 * np.sin(5 * t)], -1)
        yaw = 2.0 * np.sin(3 * t)
        return pts, xy, yaw
    pts = rng.uniform(-6, 6, (b, m, 2))
    t = np.linspace(0.0, 1.0, k)[None]
    ph = rng.uniform(0, 2, (b, 1))
    xy = np.stack([8 * t - 4 + ph, 2 * np.sin(5 * t + ph)], -1)
    yaw = 2.0 * np.sin(3 * t + ph)
    return pts, xy, yaw


def _plain(shape, pts, xy, yaw, dtype=torch.float32):
    """Port's plain scan on (B, ...) numpy inputs; cos/sin in ``dtype``."""
    f = lambda a: torch.as_tensor(a, dtype=dtype)
    yaw_t = f(yaw)
    return cs.coarse_scan_reference(shape, f(pts), f(xy), torch.cos(yaw_t),
                                    torch.sin(yaw_t))


def _assert_scan_close(mn, ar, mn_j, ar_j, atol):
    np.testing.assert_allclose(mn, mn_j, atol=atol, rtol=0)
    diff = ar != ar_j
    if diff.any():
        assert np.abs(mn - mn_j)[diff].max() < atol


@pytest.fixture()
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("SVSDF_PALLAS_INTERPRET", "1")


@pytest.mark.usefixtures("_pallas_interpret")
@pytest.mark.parametrize("shape_name", _SHAPES)
@pytest.mark.parametrize("m", [7, 1024, 2000])
def test_plain_scan_matches_jax_reference_and_pallas(shape_name, m):
    pts, xy, yaw = _case(m, 37)
    js = jshapes.make_shape(shape_name)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    mn_r, ar_r = jps.coarse_scan_reference(js, f32(pts), f32(xy), f32(yaw))
    mn, ar, _, _ = _plain(convert.shape_from_spec(shape_name), pts[None],
                          xy[None], yaw[None])
    mn, ar = mn[0].numpy(), ar[0].numpy()
    _assert_scan_close(mn, ar, np.asarray(mn_r), np.asarray(ar_r), 1e-5)
    if shape_name == "Polygon":
        # the Pallas kernel has no Polygon body: pallas_call refuses the
        # vertex array its sdf_xy captures as a constant
        with pytest.raises(ValueError, match="captures constants"):
            jps.coarse_scan(js, f32(pts), f32(xy), f32(yaw))
        return
    mn_p, ar_p = jps.coarse_scan(js, f32(pts), f32(xy), f32(yaw))
    _assert_scan_close(mn, ar, np.asarray(mn_p), np.asarray(ar_p), 1e-5)


@pytest.mark.parametrize("shape_name", _SHAPES)
def test_batched_scan_matches_vmapped_jax(shape_name):
    pre = (0.3, -0.2, 25.0)
    pts, xy, yaw = _case(300, 37, seed=3, b=4)
    js = jshapes.make_shape(shape_name, poly_params=pre)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    mn_j, ar_j = jax.vmap(
        lambda p, c, y: jps.coarse_scan_reference(js, p, c, y))(
            f32(pts), f32(xy), f32(yaw))
    mn, ar, _, _ = _plain(convert.shape_from_spec(shape_name,
                                                  poly_params=pre),
                          pts, xy, yaw)
    _assert_scan_close(mn.numpy(), ar.numpy(), np.asarray(mn_j),
                       np.asarray(ar_j), 1e-5)


@pytest.mark.parametrize("k", [2, 5, 32, 96])
@pytest.mark.parametrize("shape_name", _SHAPES)
def test_neighbour_values_match_jax_take_along_axis(shape_name, k):
    pts, xy, yaw = _case(200, k, seed=k, b=3)
    js = jshapes.make_shape(shape_name)
    mn, ar, fm, fp = _plain(convert.shape_from_spec(shape_name), pts, xy,
                            yaw, dtype=torch.float64)
    for b in range(3):
        table = jsv.PoseTable(jnp.linspace(0.0, 1.0, k), jnp.asarray(xy[b]),
                              jnp.cos(jnp.asarray(yaw[b])),
                              jnp.sin(jnp.asarray(yaw[b])))
        d = jsv._sdf_from_table(js, table, jnp.asarray(pts[b]))
        i = jnp.argmin(d, axis=1)
        im = jnp.clip(i - 1, 0, k - 1)
        ip = jnp.clip(i + 1, 0, k - 1)
        np.testing.assert_array_equal(ar[b].numpy(), np.asarray(i))
        np.testing.assert_allclose(mn[b].numpy(),
                                   np.asarray(jnp.min(d, axis=1)),
                                   atol=1e-12, rtol=0)
        np.testing.assert_allclose(
            fm[b].numpy(),
            np.asarray(jnp.take_along_axis(d, im[:, None], 1)[:, 0]),
            atol=1e-12, rtol=0)
        np.testing.assert_allclose(
            fp[b].numpy(),
            np.asarray(jnp.take_along_axis(d, ip[:, None], 1)[:, 0]),
            atol=1e-12, rtol=0)


def test_scan_dtype_casts_like_the_table_scan():
    """scan_dtype="bfloat16": values come back in the points' dtype and
    agree with the JAX table scan in bfloat16 to its resolution."""
    k = 48
    pts, xy, yaw = _case(256, k, seed=5, b=2)
    heart = convert.shape_from_spec("sdHeart")
    f = lambda a: torch.as_tensor(a, dtype=torch.float32)
    yaw_t = f(yaw)
    mn, ar, fm, fp = cs.coarse_scan_reference(
        heart, f(pts), f(xy), torch.cos(yaw_t), torch.sin(yaw_t),
        scan_dtype="bfloat16")
    assert mn.dtype == fm.dtype == fp.dtype == torch.float32
    js = jshapes.make_shape("sdHeart")
    for b in range(2):
        y = jnp.asarray(yaw[b], jnp.float32)
        table = jsv.PoseTable(jnp.linspace(0.0, 1.0, k, dtype=jnp.float32),
                              jnp.asarray(xy[b], jnp.float32), jnp.cos(y),
                              jnp.sin(y))
        d = jsv._sdf_from_table(js, table, jnp.asarray(pts[b], jnp.float32),
                                dtype="bfloat16")
        # one bfloat16 ulp at |sdf| <= 16
        np.testing.assert_allclose(
            mn[b].numpy(), np.asarray(jnp.min(d, axis=1), np.float32),
            atol=0.0625, rtol=0)
