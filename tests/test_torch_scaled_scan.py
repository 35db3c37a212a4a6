"""The deformable float32 form of the coarse-scan kernel on the CPU.

The form (csrc/coarse_scan.cu, ``kScaled`` in float) divides each point's
pre-transformed coordinates by a pose's scale with one reciprocal a pose
and two fused multiply-adds a quotient, and, where each lane scans at
most four poses, takes the argmin's neighbours from the lanes that hold
them (a shuffle) instead of evaluating them again. Here:

  * the split model with the held neighbours (``coarse_scan_split_reference``
    with ``neighbours="held"``, the shuffle's rule) equals the recomputed
    neighbours and the plain version bit for bit at every S <= 32 and
    ceil(K / S) <= 4, on the three deformable robots and the rigid sdHeart,
    with ties at the lane boundaries, argmin 0 and argmin K-1;
  * the deformable float32 scan against the JAX package's table scan
    (``_sdf_from_table``) on the same numpy inputs at the single plan's
    shapes, at 1e-5 (XLA's CPU compile may contract to fused multiply-adds
    and its sine differs by ulps, so not bit for bit);
  * a host emulation of the division's fast path (exact float64 steps, one
    rounding each) against numpy's IEEE quotient on the divisors where the
    reciprocal's error is largest, and the divisor set the card check
    tries every dividend at.

The card tests (tests/test_torch_cuda_kernel.py) hold the kernel itself:
its quotients against the card's IEEE ones at every dividend and pair of
significands, and the form bit for bit against the plain version.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svsdf_tpu.ops import svsdf as jsv
from svsdf_tpu.utils import fixtures as jfixtures
from svsdf_tpu_torch.models import shapes
from svsdf_tpu_torch.ops import cuda_svsdf as cs
from svsdf_tpu_torch.utils import fixtures

torch.set_num_threads(1)

LANES = [1, 2, 4, 8, 16, 32]
ROBOTS = ["deformable_heart", "deformable_rhombus", "deformable_star"]


def _tie_case(b, m, k, seed):
    """Numpy inputs built to tie: every pose twice in a row (so a value
    and its copy lie on neighbouring lanes), a third of the points by the
    first pose (argmin 0), a third by the last (argmin K-1), the rest in
    [-6, 6]^2; pose times over 0..12 s."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, k)[np.arange(k) // 2][None]
    ph = rng.uniform(0, 2, (b, 1))
    xy = np.stack([8 * t - 4 + ph, 2 * np.sin(5 * t + ph)], -1)
    yaw = 2.0 * np.sin(3 * t + ph)
    third = m // 3
    near = lambda i: xy[:, i:i + 1] + rng.uniform(-0.3, 0.3, (b, third, 2))
    pts = np.concatenate([near(0), near(k - 1),
                          rng.uniform(-6, 6, (b, m - 2 * third, 2))], 1)
    ts = np.broadcast_to(12.0 * t, (b, k))
    return pts, xy, yaw, ts


def _torch(pts, xy, yaw, ts):
    f = lambda a: torch.tensor(np.array(a), dtype=torch.float32)
    yaw_t = f(yaw)
    return (f(pts), f(xy), torch.cos(yaw_t), torch.sin(yaw_t)), f(ts)


def _bits(t):
    return t.contiguous().view(torch.int32) if t.is_floating_point() else t


def _held_ks(s):
    """Pose counts with ceil(K / S) <= 4: one pose, K < S, and 1 to 4
    poses a lane, the last lane short or full."""
    return sorted({k for k in (1, 3, s, 2 * s + 1, 3 * s + 1, 4 * s - 1,
                               4 * s) if 1 <= k <= 4 * s})


@pytest.mark.parametrize("s", LANES)
@pytest.mark.parametrize("robot", ROBOTS + ["sdHeart"])
def test_held_neighbours_equal_recomputed(robot, s):
    """The shuffle's rule: the neighbour values from the lanes' held
    slots equal the ones evaluated again, and the plain version's, bit for
    bit; the cases reach argmin 0, argmin K-1 and ties across lanes."""
    shape = (fixtures.deformable_scenario(robot).shape
             if robot.startswith("deformable") else shapes.make_shape(robot))
    reached = {"first": 0, "last": 0, "tie_across_lanes": 0}
    for k in _held_ks(s):
        inp, ts = _torch(*_tie_case(3, 301, k, seed=k + s))
        held = cs.coarse_scan_split_reference(shape, *inp, s, ts=ts,
                                              neighbours="held")
        again = cs.coarse_scan_split_reference(shape, *inp, s, ts=ts,
                                               neighbours="recomputed")
        plain = cs.coarse_scan_reference(shape, *inp, ts=ts)
        for a, b, c in zip(held, again, plain):
            assert torch.equal(_bits(a), _bits(b))
            assert torch.equal(_bits(a), _bits(c))
        arg, best, fp = held[1], held[0], held[3]
        reached["first"] += int((arg == 0).sum())
        reached["last"] += int((arg == k - 1).sum()) if k > 1 else 0
        # the minimum's copy on the next pose, held by the next lane
        nxt = torch.clamp(arg + 1, max=k - 1)
        reached["tie_across_lanes"] += int(
            ((nxt != arg) & (fp == best) & (nxt % s != arg % s)).sum())
    assert reached["first"] > 0 and reached["last"] > 0
    if s > 1:
        assert reached["tie_across_lanes"] > 0


def test_kernel_rule_holds_neighbours_only_in_the_scaled_float32_form():
    heart = shapes.make_shape("sdHeart")
    robot = fixtures.deformable_scenario("deformable_star").shape
    assert cs.held_neighbours(robot, 128, 32)
    assert cs.held_neighbours(robot, 128, 32, torch.float32)
    assert not cs.held_neighbours(robot, 129, 32)
    assert not cs.held_neighbours(robot, 128, 32, "bfloat16")
    assert not cs.held_neighbours(heart, 128, 32)
    # the launch geometry gives the single plan's shapes 4 poses a lane
    for m in (768, 512):
        s = cs.launch_geometry(1, m, 128)[0]
        assert cs.held_neighbours(robot, 128, s)
    inp, ts = _torch(*_tie_case(1, 10, 129, seed=0))
    with pytest.raises(ValueError, match="at most 4"):
        cs.coarse_scan_split_reference(robot, *inp, 32, ts=ts,
                                       neighbours="held")


@pytest.mark.parametrize("m", [768, 512])
@pytest.mark.parametrize("robot", ROBOTS)
def test_scaled_float32_scan_matches_jax_table_scan(robot, m):
    """The single plan's shape (1 x M x 128): min, first argmin (but at
    ties within the tolerance) and both neighbour values against JAX's
    table scan of the same deformable robot, float32, at 1e-5."""
    k = 128
    rng = np.random.default_rng(m + len(robot))
    pts = rng.uniform(-6, 6, (m, 2)).astype(np.float32)
    u = np.linspace(0.0, 1.0, k)
    ts = (20.0 * u).astype(np.float32)
    xy = np.stack([8 * u - 4, 2 * np.sin(5 * u)], -1).astype(np.float32)
    yaw = (2.0 * np.sin(3 * u)).astype(np.float32)
    c, s = np.cos(yaw), np.sin(yaw)
    jshape = jfixtures.deformable_scenario(robot).shape
    table = jsv.PoseTable(*(jnp.asarray(a) for a in (ts, xy, c, s)))
    d = np.asarray(jsv._sdf_from_table(jshape, table, jnp.asarray(pts)),
                   np.float64)                                   # (M, K)
    shape = fixtures.deformable_scenario(robot).shape
    f = lambda a: torch.as_tensor(a)[None]
    mn, ar, fm, fp = (v[0].numpy() for v in cs.coarse_scan(
        shape, f(pts), f(xy), f(c), f(s), ts=f(ts)))
    rows = np.arange(m)
    np.testing.assert_allclose(mn, d.min(1), atol=1e-5, rtol=0)
    # the port's argmin is a minimum of JAX's row within the tolerance
    np.testing.assert_allclose(d[rows, ar], d.min(1), atol=1e-5, rtol=0)
    np.testing.assert_allclose(fm, d[rows, np.clip(ar - 1, 0, k - 1)],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(fp, d[rows, np.clip(ar + 1, 0, k - 1)],
                               atol=1e-5, rtol=0)
    assert (ar == d.argmin(1)).mean() > 0.99


# -- the division's fast path, emulated on the host ------------------------

def _rn32_sum(x, p):
    """RN32(x + p) of float64 x, p whose exact sum float64 may round: the
    sum, its exact error (TwoSum), and the one case where rounding twice
    differs from rounding once (the float64 sum on a float32 midpoint)
    settled by the error's sign."""
    s = x + p
    bb = s - x
    err = (x - (s - bb)) + (p - bb)
    t = s.astype(np.float32)
    lo = np.where(t.astype(np.float64) > s,
                  np.nextafter(t, np.float32(-np.inf)), t)
    hi = np.nextafter(lo, np.float32(np.inf))
    mid = (lo.astype(np.float64) + hi.astype(np.float64)) / 2
    return np.where((s == mid) & (err != 0), np.where(err > 0, hi, lo), t)


def _fast_quotient(q, s, r):
    """csrc/coarse_scan.cu div_by_scale's fast path in float32 on the host:
    y0 = RN(q r), e = RN(q - s y0), y1 = RN(y0 + e r), every step from its
    exact value (s y0 and e r are exact in float64, q - s y0 too)."""
    y0 = q * r
    e = (q.astype(np.float64) - s.astype(np.float64)
         * y0.astype(np.float64)).astype(np.float32)
    return _rn32_sum(y0.astype(np.float64),
                     e.astype(np.float64) * r.astype(np.float64))


def _worst_divisors(n, rng):
    """Significands S in [1, 2) whose reciprocal RN(1/S) lies farthest from
    1/S (near half an ulp), where the first estimate RN(Q r) strays most."""
    b = rng.uniform(1, 2, 400000).astype(np.float32)
    r = np.float32(1) / b
    off = np.abs(r.astype(np.float64) - 1 / b.astype(np.float64)) \
        / np.spacing(r).astype(np.float64)
    return b[np.argsort(-off)[:n]]


def test_division_fast_path_is_ieee_on_the_host():
    """On the divisors with the worst reciprocals and dividends below and
    above them (where y0 is and is not faithful), the fast path's quotient
    is numpy's IEEE float32 quotient, though the first estimate y0 alone
    is not (so the comparison can fail)."""
    rng = np.random.default_rng(0)
    lo, hi = cs.FAST_SCALES
    q_all, s_all = [], []
    for b in _worst_divisors(48, rng):
        q = rng.uniform(1, 2, 20000).astype(np.float32)
        near = (b * rng.uniform(0.98, 1.0, 20000)).astype(np.float32)
        q_all.append(np.concatenate([q, near]))
        s_all.append(np.full(40000, b, np.float32))
    q, s = np.concatenate(q_all), np.concatenate(s_all)
    # the same significands at other exponents in the fast range
    scale_q = np.float32(2.0) ** rng.integers(-60, 60, q.size).astype(
        np.float32)
    scale_s = np.float32(2.0) ** rng.integers(
        int(math.log2(lo)), int(math.log2(hi)), q.size).astype(np.float32)
    for qq, ss in ((q, s), (q * scale_q, s * scale_s), (-q, s)):
        r = np.float32(1) / ss
        want = qq / ss
        y0 = qq * r
        assert (y0 != want).any()
        np.testing.assert_array_equal(_fast_quotient(qq, ss, r), want)


def test_division_divisors():
    """The card check's divisors: 4096 float32 values holding the three
    schedules' scales, both ends of the fast range and their neighbours,
    subnormal scales, and random ones inside the range."""
    d = cs.division_divisors("cpu")
    assert d.dtype == torch.float32 and d.shape == (4096,)
    lo, hi = cs.FAST_SCALES
    for e in (lo, hi):
        v = torch.tensor(e, dtype=torch.float32)
        for w in (torch.nextafter(v, torch.tensor(0.0)), v,
                  torch.nextafter(v, torch.tensor(math.inf))):
            assert bool((d == w).any())
    assert int(((d > 0) & (d < 2.0 ** -126)).sum()) >= 40
    t = torch.linspace(0.0, 64.0, 1000)
    for name in ROBOTS:
        want = fixtures.deformable_scenario(name).shape.scale_fn(t)
        assert bool(torch.isin(want, d).all())
    inside = (d >= lo) & (d <= hi)
    assert int(inside.sum()) > 4000
