"""The coarse-scan CUDA kernel (svsdf_tpu_torch/csrc/coarse_scan.cu)
against its plain PyTorch version.

Tests marked ``cuda`` need an NVIDIA card and skip without one: the
kernel has no CPU mode. This file imports neither JAX nor the JAX
package, so on a card whose installation has no JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernel.py

Beside the float32 form's parity cases, the card tests hold both
packed bfloat16 forms on every body and lane count, ties, signed zeros,
NaN and subnormals, the grid body of mesh robots in both forms (every
lane count, the bfloat16 clamp zone and a clip past the last cell, grids
past 48 KB and past 227 KB, its square roots at every positive input,
wrong corner records refused), and force three paths on the card (GSIP
at K = 64, certify-refine re-solves in a replan, the retry ladder's
fine-yaw rungs), holding every launch they make. The other tests hold the
wrapper's argument checks, which run before anything touches the card.
"""

import dataclasses
import math
from unittest import mock

import numpy as np
import pytest
import torch

from svsdf_tpu_torch.bench import grid_setup, write_prism_obj
from svsdf_tpu_torch.models import mesh_sdf, shapes
from svsdf_tpu_torch.ops import cuda_svsdf as cs
from svsdf_tpu_torch.ops.svsdf import SVSDFConfig, svsdf_query
from svsdf_tpu_torch.parallel import batch as pb
from svsdf_tpu_torch.planner.online import OnlineReplanner
from svsdf_tpu_torch.planner.pipeline import Planner
from svsdf_tpu_torch.utils import fixtures
from svsdf_tpu_torch.utils import trajectory as trj

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
    """3000 poses: 16 bytes a record fit the block's 48 KB, 24 with the
    scale record (the scale and its reciprocal) do not. The rigid scan
    runs; the scaled one is refused by the C entry point and the wrapper
    raises, counting nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    inp = _inputs(1, 64, 3000, seed=0, device="cuda")
    _assert_kernel_equals_plain(shapes.make_shape("sdHeart"), inp)
    before = cs.coarse_scan.launches
    with pytest.raises(RuntimeError, match="cudaError"):
        cs.coarse_scan(_scaled("sdHeart"), *inp, ts=_times(1, 3000, "cuda"))
    assert cs.coarse_scan.launches == before


# -- the deformable float32 form: scale records, held neighbours ----------

#: the deformable scenarios' robots (utils/fixtures.py), by body
_ROBOTS = {"sdHeart": "deformable_heart", "sdRhombus": "deformable_rhombus",
           "star": "deformable_star"}


@pytest.mark.cuda
def test_scale_division_is_exact():
    """The form's quotients q / s (one reciprocal a pose, two fused
    multiply-adds a quotient) equal the card's IEEE division at every
    float32 dividend of the deformable schedules' divisors, the range
    ends and subnormal scales, and at every pair of significands."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    assert cs.div_mismatches("cuda") == 0
    assert cs.div_pair_mismatches("cuda") == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_ROBOTS))
def test_scaled_float32_at_path_shapes(name):
    """Each deformable scenario's robot at the single plan's shapes
    (1x768x128, 1x512x128: 4 poses a lane, neighbours by shuffle) and at
    512x64x96 (neighbours recomputed), on inputs built to tie, at the
    scenario's own schedule over a 40 s plan: bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    shape = fixtures.deformable_scenario(_ROBOTS[name]).shape
    for b, m, k in ((1, 768, 128), (1, 512, 128), (512, 64, 96)):
        _assert_form_equals_plain(
            shape, _tie_inputs(b, m, k, seed=m + k, device="cuda"), None,
            ts=_times(b, k, "cuda", horizon=40.0))


@pytest.mark.cuda
@pytest.mark.parametrize("name", [*_ROBOTS, "Polygon", "Circle"])
def test_scaled_float32_every_lane_count(name):
    """Each S forced, K from 1 to 128: ceil(K / S) <= 4 (held neighbours)
    and above (recomputed), K < S included; ties at lane boundaries,
    argmin 0 and K-1; bit for bit against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    shape = _scaled(name, pre=(0.3, -0.2, 25.0))
    for lanes in (1, 2, 4, 8, 16, 32):
        for k in (1, 3, 37, 64, 128):
            inp = _tie_inputs(3, 301, k, seed=k, device="cuda")
            ts = _times(3, k, "cuda")
            got = cs.launch(shape, *inp, lanes, *cs.block_shape(3, 301, lanes),
                            scale=cs.pose_scale(shape, ts))
            want = cs.coarse_scan_reference(shape, *inp, ts=ts)
            _assert_bits_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(cs.SHAPE_IDS))
def test_scaled_float32_range_ends_and_subnormal_scales(name):
    """Scales that leave the reciprocal's range (just outside 2^-6 and 2^6,
    subnormal, tiny) and that sit on its ends, and tiny cos and sin (the
    dividends near zero and subnormal): the IEEE division's branch and
    its edge, bit for bit against the plain model of the kernel's
    algorithm (a tiny scale makes values overflow to NaN, which the
    kernel's strict `<` never takes and torch.min would return)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    lo, hi = cs.FAST_SCALES
    ends = [float(torch.nextafter(torch.tensor(v), torch.tensor(t)))
            for v in (lo, hi) for t in (0.0, math.inf)] + [lo, hi]
    schedules = [lambda t: 2.0 ** -130 * (1.0 + 0.5 * torch.sin(t)),
                 lambda t: 2.0 ** -100 * (1.0 + 0.5 * torch.sin(t))]
    schedules += [lambda t, v=v: torch.full_like(t, v) for v in ends]
    for i, fn in enumerate(schedules):
        shape = shapes.make_scaled_shape(name, fn)
        for scale in (1.0, 2.0 ** -66, 2.0 ** -128):
            inp = _tiny_inputs(2, 256, 40, scale, "cuda")
            ts = _times(2, 40, "cuda")
            for lanes in (cs.launch_geometry(2, 256, 40)[0], 16):
                got = cs.launch(shape, *inp, lanes,
                                *cs.block_shape(2, 256, lanes),
                                scale=cs.pose_scale(shape, ts))
                want = cs.coarse_scan_split_reference(shape, *inp, lanes,
                                                      ts=ts)
                _assert_bits_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [*_ROBOTS, "Polygon"])
def test_scaled_float32_signed_zeros_and_nan(name):
    """-0.0 and NaN dividends (points on the pose centres, NaN coordinates)
    through the IEEE division's branch, at S = 1, the geometry's S and 32:
    bit for bit against the plain model of the kernel's algorithm."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    shape = _scaled(name)
    inp = _signed_zero_nan_inputs("cuda")
    b, m = inp[0].shape[:2]
    k = inp[1].shape[1]
    ts = _times(b, k, "cuda")
    for lanes in sorted({1, cs.launch_geometry(b, m, k)[0], 32}):
        got = cs.launch(shape, *inp, lanes, *cs.block_shape(b, m, lanes),
                        scale=cs.pose_scale(shape, ts))
        want = cs.coarse_scan_split_reference(shape, *inp, lanes, ts=ts)
        _assert_bits_equal(got, want)


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


# -- the packed bfloat16 forms (bfloat16x2: two poses an evaluation) -------

def _assert_bits_equal(got, want):
    """Outputs bit for bit, -0.0 told from +0.0; a NaN matches a NaN (its
    payload is not compared)."""
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        a, b = a.cpu(), b.cpu()
        if a.dtype != torch.float32:
            assert torch.equal(a, b)
            continue
        nan = torch.isnan(a)
        assert torch.equal(nan, torch.isnan(b))
        zero = torch.zeros_like(a)
        assert torch.equal(torch.where(nan, zero, a).view(torch.int32),
                           torch.where(nan, zero, b).view(torch.int32))


def _packed_launch(shape, inp, lanes, ts=None):
    """The bfloat16 form at S lanes and its block_shape; a deformable
    robot at the scale table of its pose times."""
    b, m = inp[0].shape[:2]
    scale = None if ts is None else cs.pose_scale(shape, ts, "bfloat16")
    return cs.launch(shape, *inp, lanes, *cs.block_shape(b, m, lanes),
                     bf16=True, scale=scale)


@pytest.mark.cuda
@pytest.mark.parametrize("name, form", [
    *((name, "bfloat16") for name in cs.SHAPE_IDS),
    *((name, "scaled_bfloat16")
      for name in ("sdHeart", "sdRhombus", "star", "Polygon"))])
def test_packed_form_every_lane_count(name, form):
    """Both packed forms: every body, and the deformable form on the
    deformable scenarios' bodies and Polygon. Each S forced, K = 1 and 3
    (K < S from S = 4 up), 37 (lanes with odd and even pose counts: a
    dead half in the last pair) and 64 (even counts), on inputs built to
    tie; bit for bit against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    scaled = form == "scaled_bfloat16"
    pre = (0.3, -0.2, 25.0)
    shape = _scaled(name, pre) if scaled else shapes.make_shape(
        name, poly_params=pre)
    for lanes in (1, 2, 4, 8, 16, 32):
        for k in (1, 3, 37, 64):
            inp = _tie_inputs(3, 301, k, seed=k, device="cuda")
            ts = _times(3, k, "cuda") if scaled else None
            before = cs.coarse_scan.launches
            got = _packed_launch(shape, inp, lanes, ts)
            want = cs.coarse_scan_reference(shape, *inp,
                                            scan_dtype="bfloat16", ts=ts)
            torch.cuda.synchronize()
            assert cs.coarse_scan.launches == before + 1
            _assert_bits_equal(got, want)


def _tiny_inputs(b, m, k, scale, device):
    """cos and sin times ``scale``: the pose transform's products and the
    bodies' squares land at bfloat16's smallest normal (2^-126) and among
    its subnormals, where an instruction that flushed them would show."""
    pts, xy, c, s = _inputs(b, m, k, seed=11, device="cpu")
    # half the points a little off the pose path, so p - c is small too
    near = xy[:, torch.arange(m // 2) % k] + 0.01 * pts[:, : m // 2]
    pts = torch.cat([near, pts[:, m // 2:]], 1)
    return tuple(t.contiguous().to(device)
                 for t in (pts, xy, c * scale, s * scale))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(cs.SHAPE_IDS))
def test_packed_form_smallest_normal_and_subnormal(name):
    """Values at and below bfloat16's smallest normal: rigid bodies with
    tiny cos and sin, and a deformable robot whose scales are subnormal
    too, so s * body(q / s) is; bit for bit against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    shape = shapes.make_shape(name)
    tiny = shapes.make_scaled_shape(name, lambda t: 2.0 ** -130 * (
        1.0 + 0.5 * torch.sin(t)))
    subnormal = 0
    for scale in (2.0 ** -60, 2.0 ** -63, 2.0 ** -66, 2.0 ** -70,
                  2.0 ** -128):
        inp = _tiny_inputs(2, 256, 40, scale, "cuda")
        ts = _times(2, 40, "cuda")
        for sh, t in ((shape, None), (tiny, ts)):
            got = cs.coarse_scan(sh, *inp, scan_dtype="bfloat16", ts=t)
            want = cs.coarse_scan_reference(sh, *inp, scan_dtype="bfloat16",
                                            ts=t)
            _assert_bits_equal(got, want)
            v = torch.stack([got[0], got[2], got[3]]).abs()
            subnormal += int(((v > 0) & (v < 2.0 ** -126)).sum())
    assert subnormal > 0            # subnormal values reached the outputs


def _signed_zero_nan_inputs(device):
    """Signed zeros and NaN where the bodies take min, max, abs and their
    selects: points on the pose centres (p - c = +-0), poses at yaw
    multiples of pi/2 with signed-zero cos and sin, points and a pose with
    a NaN coordinate."""
    b, m, k = 2, 96, 37
    pts, xy, c, s = (t.clone() for t in _inputs(b, m, k, seed=13,
                                                device="cpu"))
    axes = torch.tensor([[1.0, 0.0], [-0.0, 1.0], [-1.0, -0.0],
                         [0.0, -1.0], [-0.0, -1.0], [1.0, -0.0]])
    c[:, ::2] = axes[torch.arange(0, k, 2) % 6, 0]
    s[:, ::2] = axes[torch.arange(0, k, 2) % 6, 1]
    xy[:, ::3] = torch.tensor([[0.0, -0.0], [-0.0, 0.0]])[
        torch.arange(0, k, 3) % 2]
    pts[:, :40] = xy[:, torch.arange(40) % k]
    pts[:, 40:48] = torch.tensor([[-0.0, 0.0], [0.0, -0.0], [-0.0, -0.0],
                                  [0.0, 0.0]])[torch.arange(8) % 4]
    pts[:, 48:52, 0] = float("nan")
    pts[:, 52:56, 1] = float("nan")
    xy[1, 5, 0] = float("nan")
    c[1, 7] = float("nan")
    return tuple(t.contiguous().to(device) for t in (pts, xy, c, s))


@pytest.mark.cuda
@pytest.mark.parametrize("scan_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("name", list(cs.SHAPE_IDS))
def test_signed_zeros_and_nan(name, scan_dtype):
    """-0.0 and NaN through the bodies' min, max and selects, in float32
    and bfloat16, at S = 1, the geometry's S and 32: bit for bit (signs
    of zero told apart) against the plain model of the kernel's
    algorithm on the card, which takes the plain version's values and
    the kernel's rule that a NaN never wins (torch.min would return
    it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    shape = shapes.make_shape(name)
    inp = _signed_zero_nan_inputs("cuda")
    b, m = inp[0].shape[:2]
    k = inp[1].shape[1]
    bf16 = scan_dtype is not None
    for lanes in sorted({1, cs.launch_geometry(b, m, k)[0], 32}):
        got = cs.launch(shape, *inp, lanes, *cs.block_shape(b, m, lanes),
                        bf16=bf16)
        want = cs.coarse_scan_split_reference(shape, *inp, lanes,
                                              scan_dtype)
        _assert_bits_equal(got, want)


@pytest.mark.cuda
def test_packed_table_counts_pair_records():
    """The bfloat16 form stages 16 bytes a pair of poses: 3073 poses,
    past the float form's 48 KB, fit; 6200 (S=1: 3100 records, 49,600
    bytes) do not, and the wrapper raises, counting nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    heart = shapes.make_shape("sdHeart")
    _assert_form_equals_plain(heart, _inputs(1, 64, 3073, seed=0,
                                             device="cuda"), "bfloat16")
    before = cs.coarse_scan.launches
    with pytest.raises(RuntimeError, match="cudaError"):
        _packed_launch(heart, _inputs(1, 64, 6200, seed=0, device="cuda"), 1)
    assert cs.coarse_scan.launches == before


# -- paths the card had not run: each forced, the kernel then held against
# -- the plain scan on the inputs of every launch it made

#: scripts/run_scenarios.py's SVSDF settings (GSIP at K = 64)
RUN_SCENARIOS_SVS = dict(coarse_n=128, refine_rounds=2, gsip_iters=6,
                         gsip_coarse_n=64, gsip_refine_rounds=1,
                         gsip_topk=16, refine_interp_n=512)


class _LaunchLog:
    """Keeps the inputs of every kernel launch while active (wrapping the
    wrapper's launch function); ``check`` then holds the kernel against
    the plain version on each, bit for bit."""

    def __enter__(self):
        self.calls, self._orig = [], cs._launch

        def logged(shape, points, xy, cos, sin, scan_dtype=None, ts=None):
            self.calls.append((shape, (points.clone(), xy.clone(),
                                       cos.clone(), sin.clone()),
                               scan_dtype, None if ts is None else ts.clone()))
            return self._orig(shape, points, xy, cos, sin, scan_dtype, ts)
        cs._launch = logged
        return self

    def __exit__(self, *exc):
        cs._launch = self._orig

    def ks(self):
        return {c[1][1].shape[1] for c in self.calls}

    def check(self):
        assert self.calls
        for shape, inp, scan_dtype, ts in self.calls:
            _assert_form_equals_plain(shape, inp, scan_dtype, ts)


@pytest.mark.cuda
@pytest.mark.parametrize("scan_dtype", [None, "bfloat16"])
def test_gsip_at_k64_on_card(scan_dtype):
    """svsdf_query at run_scenarios.py's settings on points inside the
    swept volume of the grid query's trajectory: GSIP's boundary scans
    run at K = 64; every launch bit for bit, and the query the same with
    the plain scan."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    gq = grid_setup(device="cuda")
    t = torch.linspace(0.5, 8.5, 48, device="cuda")[None]
    rng = np.random.default_rng(0)
    off = torch.as_tensor(rng.uniform(-0.6, 0.6, (1, 48, 2)),
                          dtype=torch.float32, device="cuda")
    far = torch.as_tensor(rng.uniform(-4, 14, (1, 16, 2)),
                          dtype=torch.float32, device="cuda")
    pts = torch.cat([trj.pos(gq.traj, t)[..., :2] + off, far], 1)
    cfg = SVSDFConfig(**RUN_SCENARIOS_SVS, scan_dtype=scan_dtype)
    with _LaunchLog() as log:
        got = svsdf_query(gq.shape, gq.traj, pts, cfg)
    assert 64 in log.ks()
    assert bool((got.sdf < 0).any())
    log.check()
    with mock.patch.object(cs, "coarse_scan", cs.coarse_scan_reference):
        want = svsdf_query(gq.shape, gq.traj, pts, cfg)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_replan_certify_refine_resolves_on_card():
    """A replan at the replanner's default (bfloat16) stages with a
    certificate margin above any certificate the gate map allows: both
    certify-refine rounds re-solve. Every launch bit for bit, and the
    replan the same with the plain scan."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    sc = fixtures.synthetic_scenario("sdMoon")
    rp = OnlineReplanner(sc.config, sc.map_points, cert_margin=10.0)
    with _LaunchLog() as log, mock.patch.object(
            pb.lbfgs, "minimize", wraps=pb.lbfgs.minimize) as solves:
        r = rp.replan(sc.start[:2], sc.goal[:2])
    assert r.success
    assert solves.call_count > len(rp.stages)       # re-solves ran
    log.check()
    with mock.patch.object(cs, "coarse_scan", cs.coarse_scan_reference):
        p = rp.replan(sc.start[:2], sc.goal[:2])
    assert (r.cost, r.cert_min) == (p.cost, p.cert_min)


@pytest.mark.cuda
def test_planner_tight_gate_reaches_refine_and_fine_yaw_on_card():
    """Planner.plan on synthetic_Circle with a certificate gate 1.5 m
    tighter than the map's (no trajectory passes it): the attempt's
    certify-refine re-solves, then the retry ladder's fine-yaw rungs x2
    and x4. Every launch bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    sc = fixtures.synthetic_scenario("Circle")
    pl = Planner(sc.config, sc.map_points,
                 svs_cfg=SVSDFConfig(**RUN_SCENARIOS_SVS))
    certify = Planner.certify

    def tight(self, traj):
        pts, sdf = certify(self, traj)
        return pts, sdf - 1.5

    with mock.patch.object(Planner, "certify", tight), _LaunchLog() as log:
        res = pl.plan(sc.start, sc.goal, mid_iters=20, back_iters=20,
                      certify_rounds=1, certify_retries=0)
    rungs = res.timings["attempt_log"]
    assert [a["rung"] for a in rungs] == [0, "fine_yaw_x2", "fine_yaw_x4"]
    assert rungs[0]["refine_rounds"] >= 1
    assert res.success and not res.certified
    log.check()


# -- the grid body: mesh robots (models/mesh_sdf.py GridSDF2D) ------------

@pytest.fixture(scope="module")
def mesh_robots(tmp_path_factory):
    """The sdHeart prism (a 178 x 170 grid, 121 KB: past the 48 KB table)
    under a pre-transform; the same prism at resolution 0.02 (an 801-cell
    odd axis, 2.4 MB) and the r = 1.0 cylinder at resolution 0.01 (a
    601 x 601 grid, 1.4 MB), both past the 227 KB a block's shared memory
    could hold; and a 604 x 131 grid of seeded values at origin (0, 0),
    whose bfloat16 clip bound rounds past the last cell (604.0) and where
    a -0.0 body-frame coordinate reaches the clip as -0.0."""
    d = tmp_path_factory.mktemp("mesh")
    heart_obj = write_prism_obj("sdHeart", str(d / "heart_prism.obj"))
    heart = mesh_sdf.shape_from_mesh(heart_obj,
                                     poly_params=(0.3, -0.2, 25.0))
    fine = mesh_sdf.shape_from_mesh(heart_obj, resolution=0.02)
    cyl = mesh_sdf.shape_from_mesh(
        write_prism_obj("Circle", str(d / "cylinder.obj"), extent=2.0),
        resolution=0.01)
    vals = np.random.default_rng(5).uniform(-2, 2, 604 * 131)
    origin = mesh_sdf.mesh_shape(
        "origin", mesh_sdf.GridSDF2D(vals, 0.0, 0.0, 0.02, 604, 131))
    assert heart.grid.field.nbytes > 48 * 1024
    for big in (fine, cyl):
        assert big.grid.field.nbytes > 227 * 1024
    assert fine.grid.nx % 2 == 1 and origin.grid.ny % 2 == 1
    assert origin.grid.record_cells()[0] > origin.grid.nx
    return {"heart": heart, "heart_fine": fine, "cylinder": cyl,
            "origin": origin}


def _edge_inputs(shape, b, m, k, seed, device):
    """Points whose body-frame coordinates lie in the grid's last cells
    (where the bfloat16 clip reaches n - 1 and the corner past it is read
    clamped), by its first cells and past the grid; poses near the
    identity (small shifts and turns) so the pre-transform alone moves
    them."""
    g = shape.grid
    rng = np.random.default_rng(seed)
    lo = np.asarray([g.x0, g.y0])
    hi = lo + g.step * (np.asarray([g.nx, g.ny]) - 1)
    q = rng.uniform(lo, hi, (b, m, 2))
    band = lambda n: rng.uniform(0.0, 2.5 * g.step, (b, n))
    n4 = m // 5
    q[:, :n4, 0] = hi[0] - band(n4)
    q[:, n4:2 * n4, 1] = hi[1] - band(n4)
    q[:, 2 * n4:3 * n4, 0] = lo[0] + band(n4)
    q[:, 3 * n4:4 * n4] = rng.uniform(lo - 4, hi + 4, (b, n4, 2))
    # undo the pre-transform, so q is the body-frame point at the identity
    c, s = np.cos(shape.yaw0), np.sin(shape.yaw0)
    pts = np.stack([c * q[..., 0] - s * q[..., 1] + shape.tx,
                    s * q[..., 0] + c * q[..., 1] + shape.ty], -1)
    xy = rng.uniform(-0.05, 0.05, (b, k, 2))
    yaw = rng.uniform(-0.01, 0.01, (b, k))
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    yaw_t = f(yaw)
    return f(pts), f(xy), torch.cos(yaw_t), torch.sin(yaw_t)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
def test_grid_body_every_lane_count(mesh_robots, lanes, bf16):
    """The grid body in both forms, each S forced, K = 1, 3, 37 and 64, on
    inputs built to tie (every pose twice in a row: ties within a lane
    and, for S > 1, across lanes) and on the grid's edges (the bfloat16
    clamp case), for the prism and the grid whose bfloat16 clip passes
    its last cell, at B = 3 and 2 (tiles that do not divide M):
    bit for bit against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    dt = "bfloat16" if bf16 else None
    for robot in ("heart", "origin"):
        shape = mesh_robots[robot]
        for k in (1, 3, 37, 64):
            for inp in (_tie_inputs(3, 301, k, seed=k, device="cuda"),
                        _edge_inputs(shape, 2, 300, k, seed=k,
                                     device="cuda")):
                b, m = inp[0].shape[:2]
                before = cs.coarse_scan.launches
                got = cs.launch(shape, *inp, lanes,
                                *cs.block_shape(b, m, lanes), bf16=bf16)
                want = cs.coarse_scan_reference(shape, *inp, scan_dtype=dt)
                torch.cuda.synchronize()
                assert cs.coarse_scan.launches == before + 1
                _assert_bits_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("scan_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("robot", ["heart", "heart_fine", "cylinder",
                                   "origin"])
def test_grid_body_matches_plain_on_card(mesh_robots, robot, scan_dtype):
    """The wrapper's launch at the geometry it picks, at M = 4096, K = 64,
    at the prism batch's 512 x 64 x 96 and 512 x 64 x 128, at 37 plans
    (a B that no block count divides) and, for the prism, at the grid
    query's 1 x 65536 x 256; for a grid past the 48 KB table, grids past
    227 KB and one whose bfloat16 clip passes its last cell: bit for bit,
    and the kernel's plain model (``grid_body_reference``) is the plain
    body on the card too."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    shape = mesh_robots[robot]
    sizes = [(1, 4096, 64), (512, 64, 96), (512, 64, 128), (37, 100, 96)]
    if robot == "heart":
        sizes.append((1, 65536, 256))
    for b, m, k in sizes:
        _assert_form_equals_plain(
            shape, _inputs(b, m, k, seed=m + k, device="cuda"), scan_dtype)
    g = shape.grid
    pts = _edge_inputs(shape, 1, 4096, 1, seed=3, device="cuda")[0][0]
    for dt in (torch.float32, torch.bfloat16):
        px, py = (pts[:, a].to(dt) for a in range(2))
        _assert_bits_equal([cs.grid_body_reference(g, px, py)],
                           [g.sdf_xy(px, py)])


@pytest.mark.cuda
@pytest.mark.parametrize("scan_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("robot", ["heart", "origin"])
def test_grid_body_signed_zeros_and_nan(mesh_robots, robot, scan_dtype):
    """-0.0 and NaN through the grid body at S = 1, the geometry's S and
    32, against the plain model of the kernel's algorithm (a NaN never
    wins): bit for bit, signs of zero told apart. On the grid at origin
    (0, 0) a point on a pose centre reaches the clip as -0.0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    shape = mesh_robots[robot]
    inp = _signed_zero_nan_inputs("cuda")
    b, m = inp[0].shape[:2]
    k = inp[1].shape[1]
    for lanes in sorted({1, cs.launch_geometry(b, m, k)[0], 32}):
        got = cs.launch(shape, *inp, lanes, *cs.block_shape(b, m, lanes),
                        bf16=scan_dtype is not None)
        want = cs.coarse_scan_split_reference(shape, *inp, lanes,
                                              scan_dtype)
        _assert_bits_equal(got, want)


@pytest.mark.cuda
def test_grid_body_roots_are_exact():
    """The grid body's branch-free square roots (csrc/coarse_scan.cu
    root_rn) equal the correctly rounded root at every positive float32
    and bfloat16 input on this card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    assert cs.root_mismatches("cuda") == (0, 0)


@pytest.mark.cuda
def test_grid_body_refuses_a_wrong_grid(mesh_robots):
    """Corner records that are not float32, not contiguous, of another
    size or on another device raise before the launch, counting nothing;
    records too few for the clip bound are refused by the C entry point
    (a cudaError, before any launch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    shape = mesh_robots["heart"]
    g = shape.grid
    inp = _inputs(1, 64, 32, seed=0, device="cuda")
    rec = g.corner_records("cuda")
    before = cs.coarse_scan.launches
    for bad in (rec.double(), rec.transpose(0, 1).contiguous().transpose(0, 1),
                rec[:-1].contiguous(), rec.cpu()):
        with mock.patch.object(g, "corner_records", lambda *a, **k: bad):
            with pytest.raises(TypeError, match="grid"):
                cs.coarse_scan(shape, *inp)
    short = rec[:int(g.scan_constants(torch.float32)[3])].contiguous()
    with mock.patch.object(g, "corner_records", lambda *a, **k: short), \
            mock.patch.object(g, "record_cells",
                              lambda: tuple(short.shape[:2])):
        with pytest.raises(RuntimeError, match="launch failed"):
            cs.coarse_scan(shape, *inp)
    assert cs.coarse_scan.launches == before
    for a, b in zip(cs.coarse_scan(shape, *inp),
                    cs.coarse_scan_reference(shape, *inp)):
        assert torch.equal(a, b)


def test_wrapper_body_of_a_mesh_robot(tmp_path):
    """A mesh robot runs the grid body; a mesh-named shape without a grid
    has none; the grid's constants reach the kernel rounded to the scan
    type (bfloat16's clip bound of a 141-cell axis is 140); a CPU tensor
    takes the plain version."""
    shape = mesh_sdf.shape_from_mesh(
        write_prism_obj("Circle", str(tmp_path / "c.obj"), extent=2.0),
        resolution=0.05)
    assert cs.body_id(shape) == cs.GRID_BODY_ID
    assert cs.GRID_BODY_ID not in cs.SHAPE_IDS.values()
    nogrid = dataclasses.replace(shapes.make_shape("sdHeart"),
                                 name="mesh:heart")
    pts, xy, c, s = _cpu_inputs()
    for dt in (None, "bfloat16"):
        with pytest.raises(NotImplementedError):
            cs._launch(nogrid, pts, xy, c, s, dt)
    g = shape.grid
    assert g.nx == 121
    x0, y0, step, hix, hiy = g.scan_constants(torch.bfloat16)
    assert (hix, hiy) == (120.0, 120.0)
    assert (x0, step) == tuple(float(torch.tensor(v, dtype=torch.bfloat16))
                               for v in (g.x0, g.step))
    assert g.scan_constants(torch.float32)[3] == float(np.float32(119.999))
    before = cs.coarse_scan.launches
    for dt in (None, "bfloat16"):
        for a, b in zip(cs.coarse_scan(shape, pts, xy, c, s, dt),
                        cs.coarse_scan_reference(shape, pts, xy, c, s, dt)):
            assert torch.equal(a, b)
    assert cs.coarse_scan.launches == before
