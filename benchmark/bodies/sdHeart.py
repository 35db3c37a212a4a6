"""The upstream sdHeart robot: Inigo Quilez's heart SDF scaled by 4
(Shape.hpp's sdHeart), in plain torch at the caller's dtype."""

import math

import torch

from benchmark.reference import const, sqrt0

#: operations per pose-point of the coarse-scan kernel, counted from
#: csrc/coarse_scan.cu (Heart) on roofline.py's basis: the body 31, the
#: pose transform 11 and the running-min compare 1
OPS = 43
#: of them, those its bfloat16 form computes in float32
OPS_F32_IN_BF16 = 0


def sdf(px, py, scale: float = 4.0):
    c = lambda v: const(v, px)
    px = px.abs() / c(scale)
    py = py / c(scale)
    top = sqrt0((px - 0.25) * (px - 0.25) + (py - 0.75) * (py - 0.75)) \
        - c(math.sqrt(2.0) / 4.0)
    v1 = px * px + (py - 1.0) * (py - 1.0)
    m = torch.clamp_min(px + py, 0.0)
    v2 = (px - 0.5 * m) * (px - 0.5 * m) + (py - 0.5 * m) * (py - 0.5 * m)
    sign = torch.where(px - py < 0.0, -1.0, 1.0).to(px.dtype)
    bottom = sqrt0(torch.minimum(v1, v2)) * sign
    return c(scale) * torch.where(px + py > 1.0, top, bottom)
