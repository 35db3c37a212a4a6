"""Analytic 2D signed-distance shape library (svsdf_tpu/models/shapes.py).

Every robot shape is a branchless torch function ``body_sdf(px, py)``
over coordinate planes of any shape, differentiable by autograd. The
arithmetic follows the JAX package operation by operation, and the
reference's constants are kept bit for bit (including its radian
constants cos(20.5), cos(43), sin(20)).

Three details keep autograd equal to ``jax.grad``:
  * ``jnp.maximum``/``jnp.minimum``/``jnp.clip`` become
    ``torch.maximum``/``torch.minimum`` on tensors, which split the
    gradient evenly at ties exactly as JAX does (``torch.clamp`` would
    not);
  * ``_abs`` has gradient +1 at 0, as ``jnp.abs`` does;
  * every ``sqrt`` goes through ``_safe_sqrt`` so that unselected
    branches never produce a NaN gradient.

In a bfloat16 scan every body follows JAX's weak typing: a Python
constant is rounded to bfloat16 where it meets a bfloat16 plane
(``_k``), as JAX rounds it before the operation, where PyTorch would
keep it in float32. A Polygon promotes against its float32 vertices as
JAX does, so it computes and returns float32.

``ScaledShape`` is a deformable robot: sdf_s(p, t) = s(t) * sdf(p / s(t))
for a torch-traceable scale schedule s.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

PI = math.pi


# ---------------------------------------------------------------------------
# numerics helpers (plane form)
# ---------------------------------------------------------------------------

def _as_t(v, ref):
    return v if torch.is_tensor(v) else ref.new_full((), v)


#: dtypes in which a Python constant is rounded before it meets a plane
_LOW = (torch.bfloat16, torch.float16)

#: the name prefix of a mesh robot, "mesh:<obj stem>" (models/mesh_sdf.py)
MESH_PREFIX = "mesh:"


def _k(v, ref):
    """The Python constant ``v`` as it meets the plane ``ref``: rounded to
    ref's dtype first when that is bfloat16 (JAX's weak typing rounds a
    Python scalar to the array's dtype; PyTorch would keep it in float32
    opmath). float32 and float64 take it unchanged, which PyTorch rounds
    as JAX does."""
    if ref.dtype in _LOW:
        return float(torch.tensor(v, dtype=ref.dtype))
    return v


def _maximum(a, b):
    ref = a if torch.is_tensor(a) else b
    return torch.maximum(_as_t(a, ref), _as_t(b, ref))


def _minimum(a, b):
    ref = a if torch.is_tensor(a) else b
    return torch.minimum(_as_t(a, ref), _as_t(b, ref))


def _clip(x, lo, hi):
    """jnp.clip: minimum(hi, maximum(lo, x))."""
    return _minimum(_maximum(x, lo), hi)


def _where(cond, a, b, ref):
    """jnp.where with scalar branches taken in ref's dtype."""
    return torch.where(cond, _as_t(a, ref), _as_t(b, ref))


def _abs(x):
    """|x| with JAX's gradient convention: +1 at x == 0 (torch.abs
    gives 0 there)."""
    return torch.where(x >= 0.0, x, -x)


def _safe_sqrt(x):
    """sqrt with zero (not NaN) gradient at x == 0."""
    pos = x > 0.0
    safe = torch.where(pos, x, torch.ones_like(x))
    return torch.where(pos, torch.sqrt(safe), torch.zeros_like(x))


def _norm2(x, y):
    return _safe_sqrt(x * x + y * y)


def _dot22(x, y):
    return x * x + y * y


def _sign_pm(x):
    """copysign(1, x) as the reference uses it (negative -> -1)."""
    return _where(x < 0.0, -1.0, 1.0, x)


# ---------------------------------------------------------------------------
# body-frame SDFs
# ---------------------------------------------------------------------------

def sd_circle(px, py, r=1.0):
    return _norm2(px, py) - _k(r, px)


def sd_uneven_capsule(px, py, r1=2.0, r2=1.0, h=5.0):
    c = lambda v: _k(v, px)
    px = _abs(px)
    b = (r1 - r2) / h
    a = math.sqrt(1.0 - b * b)
    k = c(-b) * px + c(a) * py
    d_low = _norm2(px, py) - c(r1)
    d_high = _norm2(px, py - c(h)) - c(r2)
    d_mid = c(a) * px + c(b) * py - c(r1)
    return torch.where(k < 0.0, d_low,
                       torch.where(k > c(a * h), d_high, d_mid))


def sd_star5(px, py, r=2.8, rf=0.6):
    k1x, k1y = 0.809016994375, -0.587785252292
    k2x, k2y = -k1x, k1y
    c = lambda v: _k(v, px)
    px = _abs(px)
    d1 = 2.0 * _maximum(c(k1x) * px + c(k1y) * py, 0.0)
    px, py = px - d1 * c(k1x), py - d1 * c(k1y)
    d2 = 2.0 * _maximum(c(k2x) * px + c(k2y) * py, 0.0)
    px, py = px - d2 * c(k2x), py - d2 * c(k2y)
    px = _abs(px)
    py = py - c(r)
    bax, bay = rf * (-k1y), rf * k1x - 1.0
    h = _clip((px * c(bax) + py * c(bay)) / c(bax * bax + bay * bay),
              0.0, r)
    d = _norm2(px - c(bax) * h, py - c(bay) * h)
    return d * _sign_pm(py * c(bax) - px * c(bay))


def sd_tunnel(px, py, wx=2.5, wy=1.5):
    c = lambda v: _k(v, px)
    px = _abs(px)
    py = -py
    qx = px - c(wx)
    qy = py - c(wy)
    mx = _maximum(qx, 0.0)
    d1 = mx * mx + qy * qy
    qx2 = torch.where(py > 0.0, qx, _norm2(px, py) - c(wx))
    my = _maximum(qy, 0.0)
    d2 = qx2 * qx2 + my * my
    d = _safe_sqrt(_minimum(d1, d2))
    return torch.where(_maximum(qx2, qy) < 0.0, -d, d)


def sd_cut_disk(px, py, r=5.0, h=2.0):
    w = math.sqrt(r * r - h * h)
    c = lambda v: _k(v, px)
    px = _abs(px)
    s = _maximum(c(h - r) * px * px + c(w * w) * (c(h + r) - 2.0 * py),
                 c(h) * px - c(w) * py)
    return torch.where(
        s < 0.0, _norm2(px, py) - c(r),
        torch.where(px < c(w), c(h) - py, _norm2(px - c(w), py - c(h))))


def sd_trapezoid(px, py, r1=1.0, r2=3.0, he=2.0):
    k1x, k1y = r2, he
    k2x, k2y = r2 - r1, 2.0 * he
    c = lambda v: _k(v, px)
    px = _abs(px)
    cax = _maximum(0.0, px - _where(py < 0.0, r1, r2, px))
    cay = _abs(py) - c(he)
    t = _clip(((c(k1x) - px) * c(k2x) + (c(k1y) - py) * c(k2y))
              / c(k2x * k2x + k2y * k2y), 0.0, 1.0)
    cbx = px - c(k1x) + c(k2x) * t
    cby = py - c(k1y) + c(k2y) * t
    s = _where((cbx < 0.0) & (cay < 0.0), -1.0, 1.0, px)
    return s * _safe_sqrt(_minimum(cax * cax + cay * cay,
                                   _dot22(cbx, cby)))


def sd_rhombus(px, py, bx=1.0, by=4.5):
    c = lambda v: _k(v, px)
    px = _abs(px)
    py = _abs(py)
    h = _clip(((c(bx) - 2.0 * px) * c(bx) - (c(by) - 2.0 * py) * c(by)) /
              c(bx * bx + by * by), -1.0, 1.0)
    d = _norm2(px - c(0.5 * bx) * (1.0 - h), py - c(0.5 * by) * (1.0 + h))
    return d * _where(px * c(by) + py * c(bx) - c(bx * by) < 0.0, -1.0, 1.0,
                      px)


def sd_horseshoe(px, py, r=1.5, cx=math.cos(20.5), cy=math.sin(20.5),
                 wx=1.55, wy=0.20):
    c = lambda v: _k(v, px)
    px = _abs(px)
    l = _norm2(px, py)
    rx = c(-cx) * px + c(cy) * py
    ry = c(cy) * px + c(cx) * py
    sgn = math.copysign(1.0, -cx)
    x1 = torch.where((rx <= 0.0) & (ry <= 0.0), l * c(sgn), rx)
    y1 = torch.where(rx <= 0.0, l, ry)
    x2 = x1 - c(wx)
    y2 = _abs(y1 - c(r)) - c(wy)
    return (_norm2(_maximum(x2, 0.0), _maximum(y2, 0.0))
            + _minimum(0.0, _maximum(x2, y2)))


def sd_heart(px, py, scale=4.0):
    c = lambda v: _k(v, px)
    px = _abs(px) / c(scale)
    py = py / c(scale)
    top = _norm2(px - 0.25, py - 0.75) - c(math.sqrt(2.0) / 4.0)
    v1 = _dot22(px, py - 1.0)
    m = _maximum(px + py, 0.0)
    v2 = _dot22(px - 0.5 * m, py - 0.5 * m)
    bottom = _safe_sqrt(_minimum(v1, v2)) * _sign_pm(px - py)
    return c(scale) * torch.where(px + py > 1.0, top, bottom)


def sd_rounded_x(px, py, w=3.0, r=0.25):
    c = lambda v: _k(v, px)
    ax = _abs(px)
    ay = _abs(py)
    m = torch.where(ax + ay > c(w), _as_t(0.5 * w, ax), 0.5 * (ax + ay))
    return _norm2(ax - m, ay - m) - c(r)


def sd_big_x(px, py, w=5.0, r=0.25):
    return sd_rounded_x(px, py, w=w, r=r)


def sd_rounded_cross(px, py, h=1.0, scale=2.0):
    k = 0.5 * (h + 1.0 / h)
    c = lambda v: _k(v, px)
    ax = _abs(px) / c(scale)
    ay = _abs(py) / c(scale)
    inner = c(k) - _norm2(ax - 1.0, ay - c(k))
    outer = _safe_sqrt(_minimum(_dot22(ax, ay - c(h)),
                                _dot22(ax - 1.0, ay)))
    cond = (ax < 1.0) & (ay < ax * c(k - h) + c(h))
    return c(scale) * torch.where(cond, inner, outer)


def sd_oriented_vesica(px, py, ax=2.0, ay=4.0, bx=-2.0, by=-4.0, w=0.8):
    r = 0.5 * math.hypot(bx - ax, by - ay)
    d = 0.5 * (r * r - w * w) / w
    vx, vy = (bx - ax) / r, (by - ay) / r
    cx, cy = 0.5 * (bx + ax), 0.5 * (by + ay)
    c = lambda v: _k(v, px)
    px = px - c(cx)
    py = py - c(cy)
    qx = 0.5 * _abs(c(vy) * px + c(vx) * py)
    qy = 0.5 * _abs(c(-vx) * px + c(vy) * py)
    cond = c(r) * qx < c(d) * (qy - c(r))
    hx = _where(cond, 0.0, -d, px)
    hy = _where(cond, r, 0.0, px)
    hz = _where(cond, 0.0, d + w, px)
    return _norm2(qx - hx, qy - hy) - hz


def sd_moon(px, py, d=0.8, ra=3.0, rb=2.4):
    c = lambda v: _k(v, px)
    qx = px
    qy = _abs(py)
    a = (ra * ra - rb * rb + d * d) / (2.0 * d)
    b = math.sqrt(max(ra * ra - a * a, 0.0))
    cond = c(d) * (qx * c(b) - qy * c(a)) > c(d * d) * _maximum(c(b) - qy,
                                                                0.0)
    d1 = _norm2(qx - c(a), qy - c(b))
    d2 = _maximum(_norm2(qx, qy) - c(ra), -(_norm2(qx - c(d), qy) - c(rb)))
    return torch.where(cond, d1, d2)


def sd_pie(px, py, cx=math.cos(43.0), cy=math.sin(43.0), r=3.0):
    c = lambda v: _k(v, px)
    px = _abs(px)
    l = _norm2(px, py) - c(r)
    t = _clip(px * c(cx) + py * c(cy), 0.0, r)
    m = _norm2(px - c(cx) * t, py - c(cy) * t)
    return _maximum(l, m * _sign_pm(c(cy) * px - c(cx) * py))


def sd_pie2(px, py, r=3.0):
    return sd_pie(px, py, cx=math.cos(1.0), cy=math.sin(1.0), r=r)


def sd_arc(px, py, scx=math.sin(20.0), scy=math.cos(20.0), ra=2.3333,
           rb=0.5):
    c = lambda v: _k(v, px)
    px = _abs(px)
    cond = c(scy) * px > c(scx) * py
    d1 = _norm2(px - c(scx * ra), py - c(scy * ra))
    d2 = _abs(_norm2(px, py) - c(ra))
    return torch.where(cond, d1, d2) - c(rb)


def sd_polygon(px, py, verts):
    """Simple-polygon SDF: exact distance by per-edge point-segment
    distance, sign by the even-odd crossing rule.

    ``verts`` (E, 2) is rounded to float32 as the JAX package stores
    it; the per-edge constants stay float32 scalars (numpy), so mixed
    arithmetic with float64 planes promotes exactly as JAX does, and
    bfloat16 planes promote to float32 (JAX: bf16 with f32 -> f32)."""
    if px.dtype in _LOW:
        px, py = px.float(), py.float()
    verts = np.asarray(verts, np.float32)
    e = verts.shape[0]
    eps = np.float32(1e-30)
    d2_min = None
    flips = 0
    for i in range(e):
        vix, viy = verts[i, 0], verts[i, 1]
        vjx, vjy = verts[i - 1, 0], verts[i - 1, 1]
        ex, ey = vjx - vix, vjy - viy
        wx, wy = px - float(vix), py - float(viy)
        t = _clip((wx * float(ex) + wy * float(ey))
                  / float(np.maximum(ex * ex + ey * ey, eps)), 0.0, 1.0)
        bx_, by_ = wx - float(ex) * t, wy - float(ey) * t
        d2 = _dot22(bx_, by_)
        d2_min = d2 if d2_min is None else _minimum(d2_min, d2)
        c1 = py >= float(viy)
        c2 = py < float(vjy)
        c3 = float(ex) * wy > float(ey) * wx
        flip = (c1 & c2 & c3) | (~c1 & ~c2 & ~c3)
        flips = flips + flip.to(torch.int32)
    s = 1.0 - 2.0 * (flips % 2).to(px.dtype)
    return s * _safe_sqrt(d2_min)


# ---------------------------------------------------------------------------
# Shape container with config pre-transform
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Shape2D:
    """A robot shape: body SDF + the config poly_params pre-transform
    q = R0^T (p - t0) applied before the body SDF."""

    name: str
    body_sdf: Callable = dataclasses.field(repr=False)
    tx: float = 0.0
    ty: float = 0.0
    yaw0: float = 0.0  # radians
    #: vertex list of a Polygon shape (None for analytic shapes)
    vertices: Optional[tuple] = dataclasses.field(default=None,
                                                  repr=False)
    #: the SDF grid of a mesh robot (models/mesh_sdf.py GridSDF2D, whose
    #: ``sdf_xy`` is body_sdf), None for the other bodies
    grid: Optional[object] = dataclasses.field(default=None, repr=False,
                                               compare=False)
    time_varying: bool = dataclasses.field(default=False, repr=False)

    def _pre(self, px, py):
        px = px - _k(self.tx, px)
        py = py - _k(self.ty, py)
        if self.yaw0 == 0.0:
            return px, py
        c, s = math.cos(self.yaw0), math.sin(self.yaw0)
        return (_k(c, px) * px + _k(s, py) * py,
                _k(-s, px) * px + _k(c, py) * py)

    def sdf_xy(self, px, py):
        return self.body_sdf(*self._pre(px, py))

    def sdf(self, p):
        return self.sdf_xy(p[..., 0], p[..., 1])

    def sdf_grad(self, p):
        """(sdf, dsdf/dp) at robot-frame points p (..., 2), by autograd."""
        with torch.enable_grad():
            q = p.detach().requires_grad_(True)
            val = self.sdf(q)
            (grad,) = torch.autograd.grad(val.sum(), q)
        return val.detach(), grad

    def sdf_xy_t(self, px, py, t):
        """SDF at trajectory time(s) t (rigid shapes ignore t)."""
        del t
        return self.sdf_xy(px, py)

    def sdf_t(self, p, t):
        return self.sdf_xy_t(p[..., 0], p[..., 1], t)


@dataclasses.dataclass(frozen=True)
class ScaledShape(Shape2D):
    """Deformable (uniformly time-scaled) robot shape: the reference's
    getScale / getDotScale hook (sw_manager.hpp:495-518). A uniform scale
    s(t) transforms the SDF exactly, sdf_s(p, t) = s(t) * sdf(p / s(t)),
    with the pre-transform applied before the division.

    ``scale_fn`` is a torch callable t -> s(t) > 0 (elementwise, so the
    scan can evaluate it once per pose); ``dot_scale`` is its autograd
    derivative. The time-free ``sdf_xy`` / ``sdf`` (the front end's
    kernel rasterization) evaluate at ``kernel_scale``: set it to the
    largest s(t) over the horizon for conservative kernels."""

    scale_fn: Callable = dataclasses.field(
        default=lambda t: torch.ones_like(t), repr=False)
    kernel_scale: float = 1.0
    time_varying: bool = dataclasses.field(default=True, repr=False)

    def scale(self, t):
        return self.scale_fn(t)

    def dot_scale(self, t):
        """ds/dt at t, by autograd (JAX: jax.grad of scale_fn)."""
        t = torch.as_tensor(t)
        if not t.is_floating_point():
            t = t.to(torch.get_default_dtype())
        with torch.enable_grad():
            u = t.detach().requires_grad_(True)
            (ds,) = torch.autograd.grad(self.scale_fn(u).sum(), u)
        return ds

    def sdf_xy_s(self, px, py, s):
        """SDF at the scale value(s) s: s * body(pre(p) / s)."""
        qx, qy = self._pre(px, py)
        return s * self.body_sdf(qx / s, qy / s)

    def sdf_xy_t(self, px, py, t):
        return self.sdf_xy_s(px, py, self.scale_fn(t))

    def sdf_xy(self, px, py):
        return self.sdf_xy_s(px, py, _k(self.kernel_scale, px))


def breathing_scale(amp: float, rate: float) -> Callable:
    """The schedule t -> 1 + amp * sin(rate * t) of the deformable
    scenarios, its constants rounded to a bfloat16 t first as JAX's weak
    typing rounds them (``_k``), so a bfloat16 scan sees the scales the
    JAX package's does."""
    def scale_fn(t):
        return _k(1.0, t) + _k(amp, t) * torch.sin(_k(rate, t) * t)
    return scale_fn


def make_scaled_shape(name: str, scale_fn: Callable,
                      poly_params: Sequence[float] = (0.0, 0.0, 0.0),
                      vertices: Optional[Sequence] = None,
                      kernel_scale: float = 1.0) -> ScaledShape:
    """Deformable variant of make_shape: the same factory with a
    torch-traceable uniform scale schedule s(t)."""
    base = make_shape(name, poly_params=poly_params, vertices=vertices)
    return ScaledShape(name=base.name, body_sdf=base.body_sdf, tx=base.tx,
                       ty=base.ty, yaw0=base.yaw0, vertices=base.vertices,
                       scale_fn=scale_fn, kernel_scale=kernel_scale)


_REGISTRY: dict = {
    "Circle": sd_circle,
    "sdUnevenCapsule": sd_uneven_capsule,
    "star": sd_star5,
    "sdTunnel": sd_tunnel,
    "sdCutDisk": sd_cut_disk,
    "sdTrapezoid": sd_trapezoid,
    "sdRhombus": sd_rhombus,
    "sdHorseshoe": sd_horseshoe,
    "sdHeart": sd_heart,
    "sdRoundedX": sd_rounded_x,
    "bigX": sd_big_x,
    "sdRoundedCross": sd_rounded_cross,
    "sdOrientedVesica": sd_oriented_vesica,
    "sdMoon": sd_moon,
    "sdPie": sd_pie,
    "sdPie2": sd_pie2,
    "sdArc": sd_arc,
}

#: default fallback rectangle (thin-rectangle Polygon)
_FALLBACK_RECT = [(6.0, -0.1), (6.0, 0.1), (-6.0, 0.1), (-6.0, -0.1)]


def shape_names() -> Sequence[str]:
    return tuple(_REGISTRY.keys())


def make_shape(name: str,
               poly_params: Sequence[float] = (0.0, 0.0, 0.0),
               vertices: Optional[Sequence] = None) -> Shape2D:
    """Build a Shape2D by reference shape name; unknown names fall back
    to a thin-rectangle Polygon. ``poly_params`` is (x, y, yaw_degrees).
    """
    tx, ty, yaw_deg = (list(poly_params) + [0.0, 0.0, 0.0])[:3]
    if name == "Polygon" or name not in _REGISTRY:
        vv = np.asarray(vertices if vertices is not None else _FALLBACK_RECT,
                        np.float32)
        body = lambda px, py: sd_polygon(px, py, vv)
        return Shape2D(name="Polygon", body_sdf=body, tx=tx, ty=ty,
                       yaw0=yaw_deg * PI / 180.0,
                       vertices=tuple(map(tuple, vv.tolist())))
    return Shape2D(name=name, body_sdf=_REGISTRY[name], tx=tx, ty=ty,
                   yaw0=yaw_deg * PI / 180.0)


def shape_from_objpath(objpath: str,
                       poly_params: Sequence[float] = (0.0, 0.0, 0.0)
                       ) -> Shape2D:
    """Select the shape from the config ``inputdata`` obj path
    (initShapeByString, sw_manager.hpp:350-373): a known analytic stem
    wins; an existing ``.obj`` of another name is a mesh robot
    (models/mesh_sdf.py ``shape_from_mesh``, the reference's BasicShape
    mesh SDF, Shape.hpp:332-340); a missing file falls back to the
    thin-rectangle Polygon."""
    stem = objpath.rsplit("/", 1)[-1]
    stem = stem[:-4] if stem.endswith(".obj") else stem
    if stem not in _REGISTRY and os.path.isfile(objpath):
        from svsdf_tpu_torch.models.mesh_sdf import shape_from_mesh
        return shape_from_mesh(objpath, poly_params=poly_params)
    return make_shape(stem, poly_params=poly_params)
