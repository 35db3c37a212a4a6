"""Port parity: shape stencils, feasibility and transition maps, ESDF.

Stencils are computed in float64 on both sides (the JAX package's tests
run x64), so the thresholded SDF agrees cell for cell: the yaw stencils
and the feasibility correlations are held equal as booleans.

The transition stencils of sdHeart and sdTrapezoid are the exception,
and it is the JAX side's: XLA compiles the whole (bin, delta, direction,
t) sweep into fused loops and contracts a*b + c into fused multiply-adds
there, so a cell whose centre lies exactly on the shape boundary at an
axis-aligned yaw (the SDF is 0 in exact arithmetic, |sdf| ~ 1e-16 after
rounding) can come out on either side. For those two shapes the test
holds the JAX stencil between the port's stencils at margins of -1e-9
and +1e-9 m, and every cell outside that band equal; Circle and Polygon
are held equal outright. Feasibility correlations are held equal on the
same stencils. The ESDF agrees at 1e-12.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svsdf_tpu.models import shapes as jshapes
from svsdf_tpu.ops import esdf as jesdf
from svsdf_tpu.ops import kernels as jk
from svsdf_tpu_torch.models import shapes
from svsdf_tpu_torch.ops import esdf
from svsdf_tpu_torch.ops import kernels as tk
from svsdf_tpu_torch.utils import mapgen
from svsdf_tpu_torch.utils.gridmap import GridMap

torch.set_num_threads(1)

F64 = dict(device="cpu", dtype=torch.float64)
#: (shape, kernel_size, yaw bins) as the synthetic scenarios size them
SHAPES = [("Circle", 7, 4), ("sdHeart", 15, 8), ("sdTrapezoid", 11, 12),
          ("Polygon", 15, 18)]


def _corridor():
    pts = [(x + 0.5, 7.2, z + 0.5) for x in range(24) for z in range(2)
           if not 10 <= x <= 13]
    pts += [(0.05, 0.05, 0.05), (23.9, 15.9, 1.9)]
    return GridMap.from_points(np.asarray(pts), 1.0, 1)


def _forest():
    return GridMap.from_points(mapgen.map_forest(res=0.5, seed=3,
                                                 n_trees=14), 1.0, 1)


@pytest.mark.parametrize("sub", [1, 3])
@pytest.mark.parametrize("name,ks,yaw_num", SHAPES)
def test_shape_stencils_and_feasibility_equal(name, ks, yaw_num, sub):
    jker = np.asarray(jk.rasterize_shape_kernels(
        jshapes.make_shape(name), ks, yaw_num, 1.0, 0.5, yaw_substeps=sub))
    ker = tk.rasterize_shape_kernels(shapes.make_shape(name), ks, yaw_num,
                                     1.0, 0.5, yaw_substeps=sub, **F64)
    assert ker.shape == (yaw_num, ks, ks) and ker.dtype == torch.bool
    np.testing.assert_array_equal(ker.numpy(), jker)
    for grid in (_corridor(), _forest()):
        jf = np.asarray(jk.feasibility_maps(jnp.asarray(grid.occ2d), jker))
        f = tk.feasibility_maps(grid.occ2d.copy(), ker, device="cpu")
        np.testing.assert_array_equal(f.numpy(), jf)
        assert 0 < int(f.sum()) < f.numel()


def _offset(shape, eps):
    body = shape.body_sdf
    return dataclasses.replace(shape,
                               body_sdf=lambda px, py: body(px, py) + eps)


@pytest.mark.parametrize("name,ks,yaw_num", SHAPES)
def test_transition_stencils_and_feasibility(name, ks, yaw_num):
    guard = (ks // 2 + 2) * 1.0
    shape = shapes.make_shape(name)
    js = np.asarray(jk.transition_stencils(jshapes.make_shape(name),
                                           yaw_num, 1.0, guard, n_deltas=5))
    ts = tk.transition_stencils(shape, yaw_num, 1.0, guard, n_deltas=5,
                                **F64).numpy()
    assert ts.shape == js.shape == (yaw_num, 5, 8, 2 * (ks // 2 + 2) + 1,
                                    2 * (ks // 2 + 2) + 1)
    if name in ("Circle", "Polygon"):
        np.testing.assert_array_equal(ts, js)
    else:
        # within 1e-9 m of the boundary either answer is JAX's rounding
        inner = tk.transition_stencils(_offset(shape, 1e-9), yaw_num, 1.0,
                                       guard, n_deltas=5, **F64).numpy()
        outer = tk.transition_stencils(_offset(shape, -1e-9), yaw_num, 1.0,
                                       guard, n_deltas=5, **F64).numpy()
        assert not (inner & ~js).any() and not (js & ~outer).any()
        band = inner != outer
        np.testing.assert_array_equal(ts[~band], js[~band])
        assert band.mean() < 0.05
    grid = _forest()
    jt = np.asarray(jk.transition_feasibility(jnp.asarray(grid.occ2d), js))
    tt = tk.transition_feasibility(grid.occ2d.copy(), js.copy(),
                                   device="cpu")
    assert tt.dtype == torch.bool
    np.testing.assert_array_equal(tt.numpy(), jt)


def test_esdf_matches():
    grid = _forest()
    for occ in (grid.occ2d, grid.occ[:20, :24, :6]):
        want = np.asarray(jesdf.esdf(jnp.asarray(occ), 1.0))
        got = esdf.esdf(occ.copy(), 1.0, **F64).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        assert (got < 0).any() and (got > 0).any()
    f, g = esdf.esdf_with_grad(grid.occ2d.copy(), 0.5, **F64)
    jf, jg = jesdf.esdf_with_grad(jnp.asarray(grid.occ2d), 0.5)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-12)
    occ = np.zeros((5, 6, 4), np.uint8)
    occ[2, 3, 1] = 1
    np.testing.assert_allclose(
        esdf.distance_transform_sq(occ, **F64).numpy(),
        np.asarray(jesdf.distance_transform_sq(jnp.asarray(occ))),
        rtol=0, atol=1e-12)
