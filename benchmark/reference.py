"""The benchmark's plain reference: what a cell's answers must be.

Plain PyTorch, independent of the program under test (it imports
neither ``svsdf_tpu_torch`` nor JAX). It works out again, from the
benchmark's own inputs, what the program derives: MINCO trajectories
from decision vectors, the back-end cost, the swept-volume SDF (the
oracle), and a mesh robot's SDF grid from its .obj file.

Precision. ``Prec.reference()`` computes in float64 where the
configuration states float32, and scans in bfloat16 where the
configuration states bfloat16 scans (each operation rounded to bfloat16,
as the configuration's scan defines the oracle's coarse minimum).
``Prec.control()`` is the same code in float32 with every contraction
taking TF32 operands (10-bit mantissas, float32 sums): the precision
below the configuration's float32-with-TF32-off, the control that the
limits must fail.

Robots. A configuration's ``robot.body`` names an analytic body, a file
``bodies/<name>.py`` (its plain formula ``sdf(px, py)`` and its
operation counts, ``roofline.py``), or ``"mesh"``, a closed .obj read as
``MeshBody``. An optional ``robot.scale`` makes the robot deformable: at
trajectory time t its SDF is s(t) f(q / s(t)) (``Scaled``). Every body
is called ``body(px, py, t)``, with the times of the poses; rigid bodies
ignore t, and without t a deformable body takes its kernel scale (the
front end's stencils).

The oracle follows the configuration's definition (``SVSDFConfig``
fields as the configuration file states them): a coarse scan of the
robot SDF at K evenly spaced trajectory times, ``refine_rounds`` wide
rounds of ``refine_n`` exact samples around the coarse argmin, and for
points inside the swept volume (``use_inside``) the expanding-disk
interior distance (GSIP) of the ``gsip_topk`` most interior points.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import math
import os
import re

import numpy as np
import torch

PI = math.pi


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Prec:
    work: torch.dtype            # the working type
    tf32: bool = False           # contractions take TF32 operands

    @staticmethod
    def reference() -> "Prec":
        return Prec(torch.float64)

    @staticmethod
    def control() -> "Prec":
        return Prec(torch.float32, tf32=True)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa, to nearest (ties away),
    as the tensor cores round their operands."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _op(prec: Prec, x):
    return tf32_round(x) if prec.tf32 else x


def mul(prec: Prec, a, b):
    """A product inside a contraction: TF32 operands under the control."""
    return _op(prec, a) * _op(prec, b)


# ---------------------------------------------------------------------------
# decision vector, MINCO, trajectory
# ---------------------------------------------------------------------------

def forward_t(tau):
    """tau -> piece duration T > 0 (the planner's time transform)."""
    pos = (0.5 * tau + 1.0) * tau + 1.0
    neg = 1.0 / ((0.5 * tau - 1.0) * tau + 1.0)
    return torch.where(tau > 0.0, pos, neg)


def _solve(prec: Prec, a, b):
    """Batched Gaussian elimination with partial pivoting: a (B, n, n),
    b (B, n, D) -> x (B, n, D); the row updates are contractions."""
    a, b = a.clone(), b.clone()
    nb, n = a.shape[:2]
    rows = torch.arange(nb, device=a.device)
    for k in range(n):
        piv = k + torch.argmax(a[:, k:, k].abs(), dim=1)
        for t in (a, b):
            top, low = t[rows, k].clone(), t[rows, piv].clone()
            t[rows, k], t[rows, piv] = low, top
        f = a[:, k + 1:, k] / a[:, k, k][:, None]
        a[:, k + 1:] -= mul(prec, f[..., None], a[:, k, None, :])
        b[:, k + 1:] -= mul(prec, f[..., None], b[:, k, None, :])
    x = torch.zeros_like(b)
    for k in range(n - 1, -1, -1):
        s = b[:, k] - (mul(prec, a[:, k, k + 1:, None], x[:, k + 1:])
                       .sum(dim=1) if k + 1 < n else 0.0)
        x[:, k] = s / a[:, k, k][:, None]
    return x


def _basis_row(s, order: int):
    """d^order/ds^order of (1, s, ..., s^5): (..., 6)."""
    out = []
    for k in range(6):
        if k < order:
            out.append(torch.zeros_like(s))
        else:
            out.append(math.perm(k, order) * s ** (k - order))
    return torch.stack(out, dim=-1)


def minco(prec: Prec, times, head, tail, wps):
    """Minimum-jerk (MINCO s = 3) quintic coefficients: times (B, N),
    head / tail (B, 3, D) (position, velocity, acceleration), waypoints
    (B, N-1, D) -> (B, N, 6, D) ascending powers in each piece's local
    time. The 6N x 6N system: head and tail states, each inner waypoint,
    and continuity of derivatives 0..4 at each inner knot."""
    nb, n = times.shape
    d = head.shape[-1]
    m = torch.zeros((nb, 6 * n, 6 * n), dtype=times.dtype,
                    device=times.device)
    r = torch.zeros((nb, 6 * n, d), dtype=times.dtype, device=times.device)
    zero = torch.zeros_like(times[:, 0])
    for o in range(3):
        m[:, o, 0:6] = _basis_row(zero, o)
        r[:, o] = head[:, o]
    for i in range(n - 1):
        row = 3 + 6 * i
        end = _basis_row(times[:, i], 0)
        m[:, row, 6 * i:6 * i + 6] = end
        r[:, row] = wps[:, i]
        for o in range(5):
            m[:, row + 1 + o, 6 * i:6 * i + 6] = _basis_row(times[:, i], o)
            m[:, row + 1 + o, 6 * i + 6:6 * i + 12] = -_basis_row(zero, o)
    for o in range(3):
        m[:, 6 * n - 3 + o, 6 * (n - 1):] = _basis_row(times[:, -1], o)
        r[:, 6 * n - 3 + o] = tail[:, o]
    return _solve(prec, m, r).reshape(nb, n, 6, d)


def decision_to_traj(prec: Prec, x, head, tail, n: int):
    """x (B, 4N-3) = (tau (N), waypoints (N-1, 3)) -> (coeffs, durations)."""
    times = forward_t(x[:, :n])
    wps = x[:, n:].reshape(x.shape[0], n - 1, 3)
    return minco(prec, times, head, tail, wps), times


def eval_traj(prec: Prec, coeffs, durations, t, order: int = 0):
    """The order-th derivative at times t (B, ...) -> (B, ..., D); times
    outside [0, total] clamp to the ends."""
    nb, n = durations.shape
    shape = t.shape
    tq = t.reshape(nb, -1)
    cum = torch.cumsum(durations, dim=1)
    idx = torch.clamp(torch.searchsorted(cum, tq.contiguous(), right=True),
                      0, n - 1)
    start = torch.gather(torch.cat([torch.zeros_like(cum[:, :1]), cum], 1),
                         1, idx)
    s = torch.minimum(torch.clamp_min(tq - start, 0.0),
                      torch.gather(durations, 1, idx))
    d = coeffs.shape[-1]
    c = torch.gather(coeffs, 1, idx[..., None, None].expand(-1, -1, 6, d))
    beta = _basis_row(s, order)                            # (B, Q, 6)
    out = mul(prec, beta[..., None], c).sum(dim=2)         # (B, Q, D)
    return out.reshape(shape + (d,))


def energy(prec: Prec, coeffs, durations):
    """Integral of the squared jerk, per plan: (B,)."""
    a0 = 6.0 * coeffs[:, :, 3]
    a1 = 24.0 * coeffs[:, :, 4]
    a2 = 60.0 * coeffs[:, :, 5]
    t = durations[..., None]
    dot = lambda u, v: mul(prec, u, v)
    per = (dot(a0, a0) * t + dot(a0, a1) * t ** 2
           + (dot(a1, a1) + 2.0 * dot(a0, a2)) * t ** 3 / 3.0
           + dot(a1, a2) * t ** 4 / 2.0 + dot(a2, a2) * t ** 5 / 5.0)
    return per.sum(dim=(1, 2))


def smoothed_l1(x, mu):
    """C^2 hinge: 0 for x <= 0, a cubic blend on (0, mu], x - mu/2 beyond."""
    r = x / mu
    blend = (mu - 0.5 * x) * r * r * r
    return torch.where(x <= 0.0, torch.zeros_like(x),
                       torch.where(x > mu, x - 0.5 * mu, blend))


# ---------------------------------------------------------------------------
# robot bodies
# ---------------------------------------------------------------------------

def const(v, ref):
    """A constant as it meets ``ref``: rounded to bfloat16 when ``ref`` is
    bfloat16 (a scan in bfloat16 rounds every number it holds)."""
    if ref.dtype == torch.bfloat16:
        return float(torch.tensor(v, dtype=torch.bfloat16))
    return v


def sqrt0(x):
    return torch.sqrt(torch.clamp_min(x, 0.0))


def read_obj(path: str):
    """(V (n, 3) float64, triangles (m, 3) int) of a Wavefront .obj."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            w = line.split()
            if not w:
                continue
            if w[0] == "v":
                verts.append([float(v) for v in w[1:4]])
            elif w[0] == "f":
                idx = [int(v.split("/")[0]) - 1 for v in w[1:]]
                faces += [[idx[0], idx[k], idx[k + 1]]
                          for k in range(1, len(idx) - 1)]
    return np.asarray(verts, float), np.asarray(faces, int)


def z0_contour(verts, faces):
    """The mesh's cross-section at z = 0 as segments (S, 2, 2)."""
    segs = []
    for tri in verts[faces]:
        pts = []
        for a, b in ((0, 1), (1, 2), (2, 0)):
            za, zb = tri[a, 2], tri[b, 2]
            if (za > 0) != (zb > 0):
                u = za / (za - zb)
                pts.append(tri[a, :2] + u * (tri[b, :2] - tri[a, :2]))
        if len(pts) == 2:
            segs.append(pts)
    return np.asarray(segs, float)


def contour_sdf(points, segs):
    """Signed distance of points (P, 2) to a closed contour: the least
    distance to its segments, negative inside (even-odd rule)."""
    a, b = segs[:, 0], segs[:, 1]
    ab = b - a
    ap = points[:, None] - a[None]
    h = np.clip((ap * ab).sum(-1) / np.maximum((ab * ab).sum(-1), 1e-300),
                0.0, 1.0)
    dist = np.sqrt(((ap - h[..., None] * ab) ** 2).sum(-1).min(axis=1))
    py = points[:, 1:2]
    crosses = (a[None, :, 1] > py) != (b[None, :, 1] > py)
    dy = np.where(crosses, (b[:, 1] - a[:, 1])[None], 1.0)
    xhit = a[None, :, 0] + (py - a[None, :, 1]) / dy * ab[None, :, 0]
    inside = (crosses & (xhit > points[:, :1])).sum(axis=1) % 2 == 1
    return np.where(inside, -dist, dist)


class MeshBody:
    """A mesh robot's body SDF: the exact signed distance to the .obj's
    z = 0 cross-section sampled at the nodes of a grid of step ``step``
    over the cross-section's box grown by ``margin``, read by bilinear
    interpolation, and past the grid's edge the edge value plus the
    distance to the grid (the reference robot's self-map of resolution
    ``selfmapresu``)."""

    def __init__(self, obj_path: str, step: float, margin: float):
        verts, faces = read_obj(obj_path)
        lo = verts.min(axis=0)[:2] - margin
        hi = verts.max(axis=0)[:2] + margin
        self.n = [int(np.ceil((hi[k] - lo[k]) / step)) + 1 for k in (0, 1)]
        self.lo, self.step = lo, float(step)
        gx, gy = np.meshgrid(*(lo[k] + np.arange(self.n[k]) * step
                               for k in (0, 1)), indexing="ij")
        pts = np.stack([gx.ravel(), gy.ravel()], -1)
        segs = z0_contour(verts, faces)
        vals = np.concatenate([contour_sdf(pts[i:i + 4096], segs)
                               for i in range(0, len(pts), 4096)])
        self.values = vals.reshape(self.n)
        self._tables = {}

    def _table(self, ref):
        """The grid values as they meet coordinates like ``ref``: float32
        (the grid's stored type) under bfloat16 or float32 coordinates."""
        dt = torch.float64 if ref.dtype == torch.float64 else torch.float32
        key = (ref.device, dt)
        if key not in self._tables:
            self._tables[key] = torch.as_tensor(self.values, dtype=dt,
                                                device=ref.device)
        return self._tables[key]

    def __call__(self, px, py, t=None):
        """Coordinates, weights and the outside term in the coordinates'
        type; the products with the grid values and their sum in the
        grid's. A mesh robot is rigid: t is not read."""
        f = self._table(px)
        g, gc, idx, frac = [], [], [], []
        for p, lo, n in ((px, self.lo[0], self.n[0]),
                         (py, self.lo[1], self.n[1])):
            gp = (p - const(lo, p)) / const(self.step, p)
            c = torch.clamp(gp, 0.0, const(n - 1.001, p))
            i = torch.floor(c).long()
            g.append(gp)
            gc.append(c)
            idx.append(i)
            frac.append(c - i.to(c.dtype))
        (ix, iy), (fx, fy) = idx, frac
        ix1 = torch.clamp(ix + 1, max=self.n[0] - 1)
        iy1 = torch.clamp(iy + 1, max=self.n[1] - 1)
        v = ((1 - fx) * (1 - fy) * f[ix, iy] + fx * (1 - fy) * f[ix1, iy]
             + (1 - fx) * fy * f[ix, iy1] + fx * fy * f[ix1, iy1])
        d2 = 0.0
        for over in (g[0] - gc[0], g[1] - gc[1], -g[0], -g[1]):
            m = torch.clamp_min(over, 0.0)
            d2 = d2 + m * m
        return v + const(self.step, d2) * sqrt0(d2)


#: the analytic bodies' files
BODIES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bodies")
_BODY_FILES: dict = {}


def body_file(name: str):
    """The module ``bodies/<name>.py`` of the analytic body ``name``: its
    ``sdf(px, py)``, ``OPS`` and ``OPS_F32_IN_BF16`` (``roofline.py``)."""
    if name not in _BODY_FILES:
        path = os.path.join(BODIES, f"{name}.py")
        if not re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.-]*", name) \
                or not os.path.isfile(path):
            raise ValueError(f"robot body {name!r}: no file {path}")
        spec = importlib.util.spec_from_file_location(
            f"benchmark.bodies.{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _BODY_FILES[name] = mod
    return _BODY_FILES[name]


@dataclasses.dataclass(frozen=True)
class Breathing:
    """The scale schedule s(t) = 1 + amp sin(rate t) (``robot.scale``'s
    ``"breathing"``; upstream's getScale hook, sw_manager.hpp:495-518).
    Its constants meet t in t's type: a bfloat16 scan rounds them, and
    every step, to bfloat16, as it computes the scales of its poses."""
    amp: float
    rate: float

    def __call__(self, t):
        c = lambda v: const(v, t)
        return c(1.0) + c(self.amp) * torch.sin(c(self.rate) * t)


class Scaled:
    """A deformable robot: s(t) f(px / s(t), py / s(t)) at the times t of
    the poses, and at ``kernel_scale`` without them."""

    def __init__(self, sdf, scale, kernel_scale: float):
        self.sdf, self.scale, self.kernel_scale = sdf, scale, kernel_scale

    def __call__(self, px, py, t=None):
        s = const(self.kernel_scale, px) if t is None else self.scale(t)
        return s * self.sdf(px / s, py / s)


def make_body(cfg: dict, obj_path: str | None = None):
    """The body SDF ``body(px, py, t)`` a configuration's ``robot`` entry
    names; an unknown body or schedule raises, naming what is missing."""
    robot = cfg["robot"]
    if robot["body"] == "mesh":
        return MeshBody(obj_path, robot["selfmapresu"], robot["grid_margin"])
    sdf = body_file(robot["body"]).sdf
    scale = robot.get("scale")
    if scale is None:
        return lambda px, py, t=None: sdf(px, py)
    if scale["schedule"] != "breathing":
        raise ValueError(f"unknown scale schedule {scale['schedule']!r}")
    return Scaled(sdf, Breathing(scale["amp"], scale["rate"]),
                  scale["kernel_scale"])


# ---------------------------------------------------------------------------
# the oracle: the swept-volume SDF of points along a trajectory
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Oracle:
    """One oracle setting, as the configuration states it."""
    coarse_n: int
    refine_rounds: int
    refine_n: int
    scan_bf16: bool = False
    use_inside: bool = False
    gsip_iters: int = 0
    gsip_coarse_n: int = 96
    gsip_refine_rounds: int = 0
    gsip_topk: int = 0
    gsip_r0: float = 10.0
    gsip_tol: float = 0.1
    gsip_max_samples: int = 21


class Traj:
    """A batch of trajectories whose third channel is yaw."""

    def __init__(self, prec: Prec, coeffs, durations):
        self.prec, self.coeffs, self.durations = prec, coeffs, durations
        self.total = durations.sum(dim=1)

    def pose(self, t):
        p = eval_traj(self.prec, self.coeffs, self.durations, t)
        return p[..., :2], p[..., 2]

    def vel(self, t):
        return eval_traj(self.prec, self.coeffs, self.durations, t, 1)


def _times(total, n: int):
    """n evenly spaced times over [0, total] per plan, exact endpoint."""
    u = torch.arange(n - 1, dtype=total.dtype, device=total.device) / (n - 1)
    return torch.cat([total[:, None] * u, total[:, None]], dim=1)


def _body_frame(points, xy, yaw):
    """R(yaw)^T (p - c): points (B, M, 2) against poses (B, M, S) or, with
    a pose axis (B, 1, K), every point at every pose."""
    d0 = points[..., 0, None] - xy[..., 0]
    d1 = points[..., 1, None] - xy[..., 1]
    c, s = torch.cos(yaw), torch.sin(yaw)
    return c * d0 + s * d1, -s * d0 + c * d1


def _coarse(body, traj: Traj, points, k: int, bf16: bool):
    """Coarse scan at k shared times: (min (B, M), argmin (B, M))."""
    ts = _times(traj.total, k)
    xy, yaw = traj.pose(ts)
    c, s = torch.cos(yaw), torch.sin(yaw)
    pts = points
    if bf16:
        xy, c, s, pts, ts = (v.to(torch.bfloat16)
                             for v in (xy, c, s, points, ts))
    d0 = pts[:, :, None, 0] - xy[:, None, :, 0]
    d1 = pts[:, :, None, 1] - xy[:, None, :, 1]
    c, s = c[:, None], s[:, None]
    f = body(c * d0 + s * d1, -s * d0 + c * d1, ts[:, None])
    best, arg = torch.min(f, dim=-1)
    return best.to(points.dtype), arg


def _exact(body, traj: Traj, points, t):
    """Body SDF of each point at its own times t (B, M, S)."""
    xy, yaw = traj.pose(t)
    return body(*_body_frame(points, xy, yaw), t)


def tstar(body, traj: Traj, points, o: Oracle, k: int | None = None,
          rounds: int | None = None, rn: int | None = None):
    """(min over time of the body SDF (B, M), its time (B, M)): the coarse
    scan, then wide rounds of exact samples around the argmin."""
    k = o.coarse_n if k is None else k
    rounds = o.refine_rounds if rounds is None else rounds
    if rounds < 1:
        raise ValueError("the reference refines in wide rounds only")
    rn = max(o.refine_n if rn is None else rn, 4)
    best, i = _coarse(body, traj, points, k, o.scan_bf16)
    tot = traj.total[:, None]
    dt = tot / (k - 1)
    t_star = i.to(points.dtype) * dt
    lo = torch.clamp(t_star - dt, min=torch.zeros_like(tot), max=tot)
    hi = torch.clamp(t_star + dt, min=torch.zeros_like(tot), max=tot)
    u = torch.arange(rn, dtype=points.dtype, device=points.device) / (rn - 1)
    for _ in range(max(1, rounds)):
        cand = lo[..., None] + (hi - lo)[..., None] * u
        f = _exact(body, traj, points, cand)
        fj, j = torch.min(f, dim=-1)
        tj = torch.gather(cand, -1, j[..., None])[..., 0]
        t_star = torch.where(fj < best, tj, t_star)
        best = torch.minimum(fj, best)
        h = (hi - lo) / (rn - 1)
        lo = torch.minimum(torch.clamp_min(tj - h, 0.0), tot)
        hi = torch.minimum(torch.clamp_min(tj + h, 0.0), tot)
    return best, t_star


#: GSIP's angular step schedule: pi + 0.1, divided by 3 each expansion,
#: never below 0.3
def _theta_res(k: int) -> float:
    r = PI + 0.1
    for _ in range(k):
        r = max(0.3, r / 3.0)
    return r


def _gsip_velocity(traj: Traj, t):
    """The velocity at t; where it is under 0.01 m/s near an end, the
    first one that is not, stepping 0.1 s inward up to 16 times."""
    v = traj.vel(t)[..., :2]
    deg = v.norm(dim=-1) < 0.01
    tot = traj.total[:, None]
    sign = torch.where(t < 0.1, 1.0, torch.where(t > tot - 0.1, -1.0, 0.0))
    sign = sign.to(t.dtype)
    steps = torch.arange(1, 17, dtype=t.dtype, device=t.device)
    cand = torch.minimum(torch.clamp_min(
        t[..., None] + (sign * 0.1)[..., None] * steps, 0.0), tot[..., None])
    cv = traj.vel(cand)[..., :2]
    ok = cv.norm(dim=-1) >= 0.01
    first = torch.argmax(ok.int(), dim=-1)
    found = ok.any(dim=-1) & (sign != 0.0)
    vf = torch.gather(cv, -2, first[..., None, None].expand(
        *first.shape, 1, 2))[..., 0, :]
    return torch.where((deg & found)[..., None], vf, v)


def _gsip(body, traj: Traj, p, t0, o: Oracle):
    """Interior distance of points p (B, P, 2) inside the swept volume:
    the radius of the largest disk about p inside it, by expanding-disk
    iterations; returns -radius."""
    nb, npt = t0.shape
    v = _gsip_velocity(traj, t0)
    theta0 = torch.atan2(v[..., 0], -v[..., 1])
    r = torch.full_like(t0, o.gsip_r0)
    done = torch.zeros_like(t0, dtype=torch.bool)
    for k in range(o.gsip_iters):
        res = _theta_res(k)
        ns = min(int(math.ceil(2.0 * PI / res)), o.gsip_max_samples)
        th = theta0[..., None] + res * torch.arange(ns, dtype=p.dtype,
                                                    device=p.device)
        ys = p[:, :, None] + r[..., None, None] * torch.stack(
            [torch.cos(th), torch.sin(th)], -1)
        g, _ = tstar(body, traj, ys.reshape(nb, npt * ns, 2), o,
                     k=o.gsip_coarse_n, rounds=o.gsip_refine_rounds,
                     rn=min(o.refine_n, 16))
        g = g.reshape(nb, npt, ns)
        j = torch.argmax(g, dim=-1, keepdim=True)
        gmax = torch.gather(g, -1, j)[..., 0]
        r = torch.where(done, r, r - gmax)
        theta0 = torch.where(done, theta0, torch.gather(th, -1, j)[..., 0])
        done = done | (gmax.abs() < o.gsip_tol)
    return -r


def svsdf(body, traj: Traj, points, o: Oracle):
    """The swept-volume SDF of points (B, M, 2): (B, M)."""
    sdf, t = tstar(body, traj, points, o)
    if not o.use_inside:
        return sdf
    inside = sdf < 0.0
    m = points.shape[1]
    k = o.gsip_topk if 0 < o.gsip_topk < m else m
    idx = torch.sort(-sdf, dim=1, descending=True, stable=True).indices[:, :k]
    p_k = torch.gather(points, 1, idx[..., None].expand(-1, -1, 2))
    t_k = torch.gather(t, 1, idx)
    g = _gsip(body, traj, p_k, t_k, o)
    ins_k = torch.gather(inside, 1, idx)
    return sdf.scatter(1, idx, torch.where(ins_k, g, torch.gather(sdf, 1,
                                                                  idx)))


# ---------------------------------------------------------------------------
# the back-end cost
# ---------------------------------------------------------------------------

def plan_cost(prec: Prec, body, x, head, tail, obstacles, n: int,
              cost_cfg: dict, o: Oracle):
    """The back-end cost of decision vectors x (B, 4N-3): the jerk
    energy, rho times the total time, and weight_p times the smoothed
    hinge of (safety_hor - swept SDF) summed over the obstacle points.
    Returns (cost (B,), coeffs (B, N, 6, 3), durations (B, N))."""
    coeffs, times = decision_to_traj(prec, x, head, tail, n)
    sdf = svsdf(body, Traj(prec, coeffs, times), obstacles, o)
    pen = smoothed_l1(cost_cfg["safety_hor"] - sdf, cost_cfg["mu"])
    cost = (energy(prec, coeffs, times) + cost_cfg["weight_p"] * pen.sum(1)
            + cost_cfg["rho"] * times.sum(1))
    return cost, coeffs, times
