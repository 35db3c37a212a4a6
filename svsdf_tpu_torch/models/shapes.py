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

``ScaledShape`` (time-varying robots) is not ported yet.
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
    return _norm2(px, py) - r


def sd_uneven_capsule(px, py, r1=2.0, r2=1.0, h=5.0):
    px = _abs(px)
    b = (r1 - r2) / h
    a = math.sqrt(1.0 - b * b)
    k = -b * px + a * py
    d_low = _norm2(px, py) - r1
    d_high = _norm2(px, py - h) - r2
    d_mid = a * px + b * py - r1
    return torch.where(k < 0.0, d_low,
                       torch.where(k > a * h, d_high, d_mid))


def sd_star5(px, py, r=2.8, rf=0.6):
    k1x, k1y = 0.809016994375, -0.587785252292
    k2x, k2y = -k1x, k1y
    px = _abs(px)
    d1 = 2.0 * _maximum(k1x * px + k1y * py, 0.0)
    px, py = px - d1 * k1x, py - d1 * k1y
    d2 = 2.0 * _maximum(k2x * px + k2y * py, 0.0)
    px, py = px - d2 * k2x, py - d2 * k2y
    px = _abs(px)
    py = py - r
    bax, bay = rf * (-k1y), rf * k1x - 1.0
    h = _clip((px * bax + py * bay) / (bax * bax + bay * bay), 0.0, r)
    d = _norm2(px - bax * h, py - bay * h)
    return d * _sign_pm(py * bax - px * bay)


def sd_tunnel(px, py, wx=2.5, wy=1.5):
    px = _abs(px)
    py = -py
    qx = px - wx
    qy = py - wy
    mx = _maximum(qx, 0.0)
    d1 = mx * mx + qy * qy
    qx2 = torch.where(py > 0.0, qx, _norm2(px, py) - wx)
    my = _maximum(qy, 0.0)
    d2 = qx2 * qx2 + my * my
    d = _safe_sqrt(_minimum(d1, d2))
    return torch.where(_maximum(qx2, qy) < 0.0, -d, d)


def sd_cut_disk(px, py, r=5.0, h=2.0):
    w = math.sqrt(r * r - h * h)
    px = _abs(px)
    s = _maximum((h - r) * px * px + w * w * (h + r - 2.0 * py),
                 h * px - w * py)
    return torch.where(
        s < 0.0, _norm2(px, py) - r,
        torch.where(px < w, h - py, _norm2(px - w, py - h)))


def sd_trapezoid(px, py, r1=1.0, r2=3.0, he=2.0):
    k1x, k1y = r2, he
    k2x, k2y = r2 - r1, 2.0 * he
    px = _abs(px)
    cax = _maximum(0.0, px - _where(py < 0.0, r1, r2, px))
    cay = _abs(py) - he
    t = _clip(((k1x - px) * k2x + (k1y - py) * k2y)
              / (k2x * k2x + k2y * k2y), 0.0, 1.0)
    cbx = px - k1x + k2x * t
    cby = py - k1y + k2y * t
    s = _where((cbx < 0.0) & (cay < 0.0), -1.0, 1.0, px)
    return s * _safe_sqrt(_minimum(cax * cax + cay * cay,
                                   _dot22(cbx, cby)))


def sd_rhombus(px, py, bx=1.0, by=4.5):
    px = _abs(px)
    py = _abs(py)
    h = _clip(((bx - 2.0 * px) * bx - (by - 2.0 * py) * by) /
              (bx * bx + by * by), -1.0, 1.0)
    d = _norm2(px - 0.5 * bx * (1.0 - h), py - 0.5 * by * (1.0 + h))
    return d * _where(px * by + py * bx - bx * by < 0.0, -1.0, 1.0, px)


def sd_horseshoe(px, py, r=1.5, cx=math.cos(20.5), cy=math.sin(20.5),
                 wx=1.55, wy=0.20):
    px = _abs(px)
    l = _norm2(px, py)
    rx = -cx * px + cy * py
    ry = cy * px + cx * py
    sgn = math.copysign(1.0, -cx)
    x1 = torch.where((rx <= 0.0) & (ry <= 0.0), l * sgn, rx)
    y1 = torch.where(rx <= 0.0, l, ry)
    x2 = x1 - wx
    y2 = _abs(y1 - r) - wy
    return (_norm2(_maximum(x2, 0.0), _maximum(y2, 0.0))
            + _minimum(0.0, _maximum(x2, y2)))


def sd_heart(px, py, scale=4.0):
    px = _abs(px) / scale
    py = py / scale
    top = _norm2(px - 0.25, py - 0.75) - math.sqrt(2.0) / 4.0
    v1 = _dot22(px, py - 1.0)
    m = _maximum(px + py, 0.0)
    v2 = _dot22(px - 0.5 * m, py - 0.5 * m)
    bottom = _safe_sqrt(_minimum(v1, v2)) * _sign_pm(px - py)
    return scale * torch.where(px + py > 1.0, top, bottom)


def sd_rounded_x(px, py, w=3.0, r=0.25):
    ax = _abs(px)
    ay = _abs(py)
    m = torch.where(ax + ay > w, _as_t(0.5 * w, ax), 0.5 * (ax + ay))
    return _norm2(ax - m, ay - m) - r


def sd_big_x(px, py, w=5.0, r=0.25):
    return sd_rounded_x(px, py, w=w, r=r)


def sd_rounded_cross(px, py, h=1.0, scale=2.0):
    k = 0.5 * (h + 1.0 / h)
    ax = _abs(px) / scale
    ay = _abs(py) / scale
    inner = k - _norm2(ax - 1.0, ay - k)
    outer = _safe_sqrt(_minimum(_dot22(ax, ay - h),
                                _dot22(ax - 1.0, ay)))
    cond = (ax < 1.0) & (ay < ax * (k - h) + h)
    return scale * torch.where(cond, inner, outer)


def sd_oriented_vesica(px, py, ax=2.0, ay=4.0, bx=-2.0, by=-4.0, w=0.8):
    r = 0.5 * math.hypot(bx - ax, by - ay)
    d = 0.5 * (r * r - w * w) / w
    vx, vy = (bx - ax) / r, (by - ay) / r
    cx, cy = 0.5 * (bx + ax), 0.5 * (by + ay)
    px = px - cx
    py = py - cy
    qx = 0.5 * _abs(vy * px + vx * py)
    qy = 0.5 * _abs(-vx * px + vy * py)
    cond = r * qx < d * (qy - r)
    hx = _where(cond, 0.0, -d, px)
    hy = _where(cond, r, 0.0, px)
    hz = _where(cond, 0.0, d + w, px)
    return _norm2(qx - hx, qy - hy) - hz


def sd_moon(px, py, d=0.8, ra=3.0, rb=2.4):
    qx = px
    qy = _abs(py)
    a = (ra * ra - rb * rb + d * d) / (2.0 * d)
    b = math.sqrt(max(ra * ra - a * a, 0.0))
    cond = d * (qx * b - qy * a) > d * d * _maximum(b - qy, 0.0)
    d1 = _norm2(qx - a, qy - b)
    d2 = _maximum(_norm2(qx, qy) - ra, -(_norm2(qx - d, qy) - rb))
    return torch.where(cond, d1, d2)


def sd_pie(px, py, cx=math.cos(43.0), cy=math.sin(43.0), r=3.0):
    px = _abs(px)
    l = _norm2(px, py) - r
    t = _clip(px * cx + py * cy, 0.0, r)
    m = _norm2(px - cx * t, py - cy * t)
    return _maximum(l, m * _sign_pm(cy * px - cx * py))


def sd_pie2(px, py, r=3.0):
    return sd_pie(px, py, cx=math.cos(1.0), cy=math.sin(1.0), r=r)


def sd_arc(px, py, scx=math.sin(20.0), scy=math.cos(20.0), ra=2.3333,
           rb=0.5):
    px = _abs(px)
    cond = scy * px > scx * py
    d1 = _norm2(px - scx * ra, py - scy * ra)
    d2 = _abs(_norm2(px, py) - ra)
    return torch.where(cond, d1, d2) - rb


def sd_polygon(px, py, verts):
    """Simple-polygon SDF: exact distance by per-edge point-segment
    distance, sign by the even-odd crossing rule.

    ``verts`` (E, 2) is rounded to float32 as the JAX package stores
    it; the per-edge constants stay float32 scalars (numpy), so mixed
    arithmetic with float64 planes promotes exactly as JAX does."""
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
    time_varying: bool = dataclasses.field(default=False, repr=False)

    def _pre(self, px, py):
        px = px - self.tx
        py = py - self.ty
        if self.yaw0 == 0.0:
            return px, py
        c, s = math.cos(self.yaw0), math.sin(self.yaw0)
        return c * px + s * py, -s * px + c * py

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
    wins; a missing file falls back to the thin-rectangle Polygon. An
    existing ``.obj`` of an unknown name needs the mesh SDF, which is
    not ported yet, and raises."""
    stem = objpath.rsplit("/", 1)[-1]
    stem = stem[:-4] if stem.endswith(".obj") else stem
    if stem not in _REGISTRY and os.path.isfile(objpath):
        raise NotImplementedError(
            f"mesh-SDF shapes are not ported yet: {objpath!r}")
    return make_shape(stem, poly_params=poly_params)
