"""The upstream sdRhombus robot (Shape.hpp:786): Inigo Quilez's rhombus
of half-diagonals b = (1.0, 4.5), in plain torch at the caller's dtype;
on the boundary line the sign is +1."""

import torch

from benchmark.reference import const, sqrt0

#: operations per pose-point of the coarse-scan kernel, counted from
#: csrc/coarse_scan.cu (Rhombus) on roofline.py's basis: the body 31, the
#: pose transform 11 and the running-min compare 1
OPS = 43
#: of them, those its bfloat16 form computes in float32
OPS_F32_IN_BF16 = 0


def sdf(px, py, bx: float = 1.0, by: float = 4.5):
    c = lambda v: const(v, px)
    px, py = px.abs(), py.abs()
    h = torch.clamp(((c(bx) - 2.0 * px) * c(bx) - (c(by) - 2.0 * py) * c(by))
                    / c(bx * bx + by * by), -1.0, 1.0)
    dx = px - c(0.5 * bx) * (1.0 - h)
    dy = py - c(0.5 * by) * (1.0 + h)
    sign = torch.where(px * c(by) + py * c(bx) - c(bx * by) < 0.0, -1.0,
                       1.0).to(px.dtype)
    return sqrt0(dx * dx + dy * dy) * sign
