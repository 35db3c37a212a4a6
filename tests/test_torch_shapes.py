"""Port parity: svsdf_tpu_torch.models.shapes against svsdf_tpu's shapes.

All 17 analytic shapes plus Polygon, with and without the poly_params
pre-transform: values and autograd gradients against JAX
``Shape2D.sdf_grad`` at atol 1e-10 (float64), on random points and on
points that sit exactly on branch boundaries (axes, the origin, the
diagonal), where both gradients must also be finite.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svsdf_tpu.models import shapes as jshapes
from svsdf_tpu_torch import convert
from svsdf_tpu_torch.models import shapes

torch.set_num_threads(1)

_BOUNDARY = [(0.0, 0.0), (0.0, 1.0), (1.0, 0.0), (0.0, -1.0), (-2.0, 0.0),
             (0.5, 0.5), (2.0, 2.0), (-1.5, 1.5), (0.0, 4.0), (3.0, 0.0),
             (2.5, -1.5), (0.0, 0.75), (0.25, 0.75), (1.0, 1.0)]

_VERTS = [(1.0, 0.0), (0.3, 0.9), (-0.8, 0.6), (-0.7, -0.7), (0.4, -0.8)]

_NAMES = list(jshapes.shape_names()) + ["Polygon"]


def _points(seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-6.0, 6.0, (64, 2)),
                           np.asarray(_BOUNDARY)], axis=0)


def test_registry_is_complete():
    assert tuple(shapes.shape_names()) == tuple(jshapes.shape_names())


@pytest.mark.parametrize("pre", [(0.0, 0.0, 0.0), (0.3, -0.2, 25.0)])
@pytest.mark.parametrize("name", _NAMES)
def test_sdf_and_grad_match_jax(name, pre):
    verts = _VERTS if name == "Polygon" else None
    js = jshapes.make_shape(name, poly_params=pre, vertices=verts)
    ts = convert.shape_from_spec(name, poly_params=pre, vertices=verts)
    p = _points(len(name))
    jv, jg = js.sdf_grad(jnp.asarray(p))
    tv, tg = ts.sdf_grad(torch.as_tensor(p, dtype=torch.float64))
    jv, jg = np.asarray(jv), np.asarray(jg)
    assert np.isfinite(jg).all() and torch.isfinite(tg).all()
    np.testing.assert_allclose(tv.numpy(), jv, atol=1e-10, rtol=0)
    np.testing.assert_allclose(tg.numpy(), jg, atol=1e-10, rtol=0)


def test_sdf_xy_matches_packed_form():
    s = shapes.make_shape("sdHeart", poly_params=(0.1, 0.2, 10.0))
    p = torch.as_tensor(_points(3), dtype=torch.float64)
    torch.testing.assert_close(s.sdf(p), s.sdf_xy(p[:, 0], p[:, 1]),
                               rtol=0, atol=0)
