"""The coarse-scan CUDA kernel (svsdf_tpu_torch/csrc/coarse_scan.cu)
against its plain PyTorch version.

Tests marked ``cuda`` need an NVIDIA card and skip without one: the
kernel has no CPU mode. This file imports neither JAX nor the JAX
package, so on a card whose installation has no JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernel.py

The other tests hold the wrapper's argument checks, which run before
anything touches the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from svsdf_tpu_torch.models import shapes
from svsdf_tpu_torch.ops import cuda_svsdf as cs

torch.set_num_threads(1)


def _inputs(b, m, k, seed, device):
    """Points in [-6, 6]^2 and a wiggly pose path per plan."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-6, 6, (b, m, 2))
    t = np.linspace(0.0, 1.0, k)[None]
    ph = rng.uniform(0, 2, (b, 1))
    xy = np.stack([8 * t - 4 + ph, 2 * np.sin(5 * t + ph)], -1)
    yaw = 2.0 * np.sin(3 * t + ph)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    yaw_t = f(yaw)
    return f(pts), f(xy), torch.cos(yaw_t), torch.sin(yaw_t)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    ("sdHeart", (0.0, 0.0, 0.0), 512, 64, 96),
    ("sdHeart", (0.0, 0.0, 0.0), 512, 64, 128),
    ("sdHeart", (0.0, 0.0, 0.0), 512, 108, 32),
    ("sdHeart", (0.3, -0.2, 25.0), 1, 4096, 64),
    ("Circle", (0.3, -0.2, 25.0), 1, 2000, 37),
    ("sdArc", (0.3, -0.2, 25.0), 3, 1000, 37),
    ("sdTrapezoid", (0.3, -0.2, 25.0), 3, 1000, 37),
    ("sdRoundedX", (0.3, -0.2, 25.0), 3, 1000, 37),
    ("bigX", (0.0, 0.0, 0.0), 3, 1000, 37),
    ("sdMoon", (0.3, -0.2, 25.0), 3, 1000, 37),
    ("Polygon", (0.0, 0.0, 0.0), 3, 1000, 37),
    ("Polygon", (0.3, -0.2, 25.0), 512, 48, 192),
    ("sdUnevenCapsule", (0.3, -0.2, 25.0), 3, 1000, 37),
    ("star", (0.3, -0.2, 25.0), 3, 1000, 37),
    ("sdTunnel", (0.3, -0.2, 25.0), 3, 1000, 37),
    ("sdCutDisk", (0.3, -0.2, 25.0), 3, 1000, 37),
    ("sdRhombus", (0.3, -0.2, 25.0), 3, 1000, 37),
    ("sdHorseshoe", (0.3, -0.2, 25.0), 3, 1000, 37),
    ("sdRoundedCross", (0.3, -0.2, 25.0), 3, 1000, 37),
    ("sdOrientedVesica", (0.3, -0.2, 25.0), 3, 1000, 37),
    ("sdPie", (0.3, -0.2, 25.0), 3, 1000, 37),
    ("sdPie2", (0.0, 0.0, 0.0), 3, 1000, 37),
    ("star", (0.0, 0.0, 0.0), 32, 768, 128),
    ("sdRhombus", (0.0, 0.0, 0.0), 1, 2048, 128),
], ids=lambda c: f"{c[0]}-{c[2]}x{c[3]}x{c[4]}")
def test_kernel_matches_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    name, pre, b, m, k = case
    # Polygon: the fallback thin rectangle
    shape = shapes.make_shape(name, poly_params=pre)
    inp = _inputs(b, m, k, seed=k, device="cuda")
    before = cs.coarse_scan.launches
    got = cs.coarse_scan(shape, *inp)
    want = cs.coarse_scan_reference(shape, *inp)
    torch.cuda.synchronize()
    assert cs.coarse_scan.launches == before + 1
    mn, ar, fm, fp = (v.cpu().numpy() for v in got)
    mn_r, ar_r, fm_r, fp_r = (v.cpu().numpy() for v in want)
    # built with -fmad=false in the plain version's operation order:
    # the two agree to the bit
    np.testing.assert_array_equal(mn, mn_r)
    np.testing.assert_array_equal(ar, ar_r)
    np.testing.assert_array_equal(fm, fm_r)
    np.testing.assert_array_equal(fp, fp_r)


@pytest.mark.cuda
def test_kernel_reads_strided_pose_columns():
    """The planner passes xy as the (x, y) columns of (B, K, 3) pose
    samples; the kernel reads them through their strides."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    heart = shapes.make_shape("sdHeart", poly_params=(0.3, -0.2, 25.0))
    pts, xy, c, s = _inputs(4, 300, 40, seed=3, device="cuda")
    xyz = torch.cat([xy, torch.zeros_like(xy[..., :1])], -1)
    strided = xyz[..., :2]
    assert not strided.is_contiguous()
    got = cs.coarse_scan(heart, pts, strided, c, s)
    want = cs.coarse_scan_reference(heart, pts, xy, c, s)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_polygon_with_own_vertices():
    """A Polygon with its own vertex list: a concave pentagon."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    verts = [(2.0, 0.0), (0.5, 0.4), (-1.5, 1.5), (-1.0, -1.2), (0.6, -0.3)]
    shape = shapes.make_shape("Polygon", vertices=verts)
    inp = _inputs(4, 700, 50, seed=5, device="cuda")
    for a, b in zip(cs.coarse_scan(shape, *inp),
                    cs.coarse_scan_reference(shape, *inp)):
        assert torch.equal(a, b)


def _tie_inputs(b, m, k, seed, device):
    """Inputs built to tie: every pose appears twice in a row (so each
    value does too and the first argmin is the earlier copy), a third of
    the points lie by the first pose (argmin 0) and a third by the last
    (argmin K-1), the rest anywhere."""
    pts, xy, c, s = _inputs(b, m, k, seed, "cpu")
    half = lambda a: a[:, np.arange(k) // 2]
    xy, c, s = half(xy), half(c), half(s)
    third = m // 3
    rng = np.random.default_rng(seed)
    near = lambda i, n: xy[:, i:i + 1] + torch.as_tensor(
        rng.uniform(-0.3, 0.3, (b, n, 2)), dtype=torch.float32)
    pts = torch.cat([near(0, third), near(k - 1, third), pts[:, 2 * third:]],
                    1)
    return tuple(t.contiguous().to(device) for t in (pts, xy, c, s))


def _assert_kernel_equals_plain(shape, inp, lanes=None):
    """The wrapper's launch, or with ``lanes`` the kernel at that S and
    its ``block_shape``, bit for bit against the plain version."""
    before = cs.coarse_scan.launches
    if lanes is None:
        got = cs.coarse_scan(shape, *inp)
    else:
        b, m = inp[0].shape[:2]
        got = cs.launch(shape, *inp, lanes, *cs.block_shape(b, m, lanes))
    want = cs.coarse_scan_reference(shape, *inp)
    torch.cuda.synchronize()
    assert cs.coarse_scan.launches == before + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("name", ["sdHeart", "Circle", "Polygon", "sdPie"])
def test_kernel_ties_at_every_lane_count(name, lanes):
    """Duplicated poses, minima at k=0 and K-1, K not a multiple of S and
    K < S, each S forced: bit for bit against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    shape = shapes.make_shape(name, poly_params=(0.3, -0.2, 25.0))
    for k in (1, 3, 37, 64):
        _assert_kernel_equals_plain(
            shape, _tie_inputs(3, 301, k, seed=k, device="cuda"), lanes)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 768, 65536])
@pytest.mark.parametrize("k", [5, 128, 256])
def test_kernel_single_plan(m, k):
    """B=1, the single plan's and the grid query's widths."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    _assert_kernel_equals_plain(shapes.make_shape("sdHeart"),
                                _inputs(1, m, k, seed=m + k, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3])
def test_kernel_fewer_poses_than_lanes(k):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    heart = shapes.make_shape("sdHeart", poly_params=(0.3, -0.2, 25.0))
    for lanes in (None, 4, 32):
        _assert_kernel_equals_plain(
            heart, _tie_inputs(2, 500, k, seed=k, device="cuda"), lanes)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(1, (4, 100, 5)), (2, (1, 65536, 256)),
                                  (4, (512, 64, 96)), (8, (512, 12, 32)),
                                  (16, (32, 64, 96)), (32, (1, 768, 128))],
                         ids=lambda c: f"S{c[0]}")
def test_kernel_at_each_lane_count_the_geometry_chooses(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    lanes, (b, m, k) = case
    assert cs.launch_geometry(b, m, k)[0] == lanes
    _assert_kernel_equals_plain(shapes.make_shape("sdHeart"),
                                _inputs(b, m, k, seed=lanes, device="cuda"))


@pytest.mark.cuda
def test_kernel_refuses_a_pose_table_past_shared_memory():
    """3073 float4 pose records pass the block's 48 KB: the C entry point
    refuses the launch and the wrapper raises, counting nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    before = cs.coarse_scan.launches
    with pytest.raises(RuntimeError, match="cudaError"):
        cs.coarse_scan(shapes.make_shape("sdHeart"),
                       *_inputs(1, 64, 3073, seed=0, device="cuda"))
    assert cs.coarse_scan.launches == before


#: the breathing scale schedules of utils/fixtures.py's deformable
#: scenarios, by body
_SCALES = {"sdHeart": (0.25, 0.8), "sdRhombus": (0.2, 0.8),
           "star": (0.35, 0.9)}


def _scaled(name, pre=(0.0, 0.0, 0.0)):
    amp, w = _SCALES.get(name, (0.3, 0.9))
    return shapes.make_scaled_shape(name, shapes.breathing_scale(amp, w),
                                    poly_params=pre)


def _times(b, k, device, horizon=12.0):
    """Pose times 0..horizon per plan, as the pose table's linspace."""
    return torch.linspace(0.0, horizon, k, device=device).expand(
        b, k).contiguous()


def _assert_form_equals_plain(shape, inp, scan_dtype, ts=None):
    """The wrapper's launch of one form bit for bit against the plain
    version at the same scan dtype and pose times."""
    before = cs.coarse_scan.launches
    got = cs.coarse_scan(shape, *inp, scan_dtype=scan_dtype, ts=ts)
    want = cs.coarse_scan_reference(shape, *inp, scan_dtype=scan_dtype,
                                    ts=ts)
    torch.cuda.synchronize()
    assert cs.coarse_scan.launches == before + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(cs.SHAPE_IDS))
@pytest.mark.parametrize("pre", [(0.0, 0.0, 0.0), (0.3, -0.2, 25.0)],
                         ids=["pre0", "pre"])
def test_bf16_form_matches_plain_on_card(name, pre):
    """scan_dtype="bfloat16": every body, ties included (duplicated
    poses), at a main-path shape and the single plan's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    shape = shapes.make_shape(name, poly_params=pre)
    for b, m, k in ((3, 1000, 37), (1, 768, 128)):
        _assert_form_equals_plain(
            shape, _tie_inputs(b, m, k, seed=k, device="cuda"), "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("scan_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("name", ["sdHeart", "sdRhombus", "star", "Polygon",
                                  "Circle"])
def test_scaled_form_matches_plain_on_card(name, scan_dtype):
    """A deformable robot (ScaledShape): each pose at its own scale, in
    float32 and in bfloat16, at the lane counts of three path shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    shape = _scaled(name, pre=(0.3, -0.2, 25.0))
    for b, m, k in ((512, 64, 96), (1, 768, 128), (4, 301, 37)):
        _assert_form_equals_plain(
            shape, _tie_inputs(b, m, k, seed=k, device="cuda"), scan_dtype,
            ts=_times(b, k, "cuda"))


@pytest.mark.cuda
def test_scaled_table_past_shared_memory():
    """3000 poses: 16 bytes a record fit the block's 48 KB, 20 with the
    scale do not. The rigid scan runs; the scaled one is refused by the
    C entry point and the wrapper raises, counting nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    inp = _inputs(1, 64, 3000, seed=0, device="cuda")
    _assert_kernel_equals_plain(shapes.make_shape("sdHeart"), inp)
    before = cs.coarse_scan.launches
    with pytest.raises(RuntimeError, match="cudaError"):
        cs.coarse_scan(_scaled("sdHeart"), *inp, ts=_times(1, 3000, "cuda"))
    assert cs.coarse_scan.launches == before


@pytest.mark.cuda
def test_unsupported_scan_dtype_raises_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    before = cs.coarse_scan.launches
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        cs.coarse_scan(shapes.make_shape("sdHeart"),
                       *_inputs(1, 64, 32, seed=0, device="cuda"),
                       scan_dtype="float16")
    assert cs.coarse_scan.launches == before


def _cpu_inputs():
    return _inputs(2, 5, 9, seed=0, device="cpu")


def test_wrapper_refuses_other_shapes_and_bfloat16():
    """Every analytic shape and Polygon has a body, in float32 and in
    bfloat16, rigid or scaled; a scan dtype the kernel has no form for
    (float16, float64), a shape without a body and a time-varying shape
    without its pose times raise before anything touches the card."""
    assert set(shapes.shape_names()) | {"Polygon"} == set(cs.SHAPE_IDS)
    assert cs.KERNEL_SCAN_TYPES == (None, torch.float32, torch.bfloat16)
    pts, xy, c, s = _cpu_inputs()
    for dt in ("float16", torch.float64):
        with pytest.raises(NotImplementedError):
            cs._launch(shapes.make_shape("star"), pts, xy, c, s, dt)
    nobody = dataclasses.replace(shapes.make_shape("sdHeart"), name="mesh")
    with pytest.raises(NotImplementedError):
        cs._launch(nobody, pts, xy, c, s, "bfloat16")
    with pytest.raises(ValueError, match="pose times"):
        cs._launch(_scaled("sdHeart"), pts, xy, c, s, "bfloat16")


def test_wrapper_checks_types_and_shapes():
    heart = shapes.make_shape("sdHeart")
    pts, xy, c, s = _cpu_inputs()
    with pytest.raises(TypeError):
        cs._launch(heart, pts.double(), xy, c, s, None)
    with pytest.raises(ValueError):
        cs._launch(heart, pts, xy[:, :-1], c, s, None)
    with pytest.raises(ValueError):
        cs._launch(heart, pts[..., :1], xy, c, s, None)


def test_cpu_tensors_take_the_plain_version():
    heart = shapes.make_shape("sdHeart")
    inp = _cpu_inputs()
    before = cs.coarse_scan.launches
    for a, b in zip(cs.coarse_scan(heart, *inp),
                    cs.coarse_scan_reference(heart, *inp)):
        assert torch.equal(a, b)
    ts = _times(2, 9, "cpu")
    for dt in (None, "bfloat16"):
        for a, b in zip(cs.coarse_scan(_scaled("star"), *inp, dt, ts),
                        cs.coarse_scan_reference(_scaled("star"), *inp, dt,
                                                 ts)):
            assert torch.equal(a, b)
    assert cs.coarse_scan.launches == before


def test_scaled_table_and_wider_record_on_the_host():
    """The (B, K) scale table the kernel takes is the plain version's
    scale_fn at the pose times in the scan dtype, float32; the split model
    evaluated at it equals the plain version bit for bit."""
    shape = _scaled("sdRhombus")
    ts = _times(2, 9, "cpu")
    scl = cs.pose_scale(shape, ts, "bfloat16")
    assert scl.dtype == torch.float32 and scl.shape == (2, 9)
    want = shape.scale_fn(ts.to(torch.bfloat16)).float()
    assert torch.equal(scl, want)
    inp = _cpu_inputs()
    for a, b in zip(cs.coarse_scan_split_reference(shape, *inp, 4,
                                                   "bfloat16", ts),
                    cs.coarse_scan_reference(shape, *inp, "bfloat16", ts)):
        assert torch.equal(a, b)
