"""Port parity: the swept-surface export (svsdf_tpu_torch/viz/swept_surface.py)
against the JAX package's (svsdf_tpu/viz/swept_surface.py), on the cases of
tests/test_swept3d.py and test_planner_e2e.py::test_swept_surface_circle_line.

  * marching squares and marching tetrahedra are numpy on both sides: the
    same field gives the same segments and the same mesh, to the bit (each
    side's Python loop, its path where its native library is absent; the
    native routes are held in tests/test_torch_native.py);
  * the 2-D SVSDF field of the Circle sweep in float64 (JAX with x64)
    within 1e-9 m, and the port's contour of it equal to JAX's marching
    squares of the same field;
  * the 3-D swept field of a cube mesh: the volumetric grid equal to the
    bit, the running minimum over the poses within 1e-6 m (float32
    fields; the pose times are a linspace that XLA may round another way
    by an ulp), and its surface watertight with the JAX surface's
    bounding box within one grid step;
  * both OBJ writers write the same text.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svsdf_tpu import native
from svsdf_tpu.models import mesh_sdf as jmesh
from svsdf_tpu.models import shapes as jshapes
from svsdf_tpu.ops import minco as jminco
from svsdf_tpu.viz import swept_surface as jsw
from svsdf_tpu_torch import convert
from svsdf_tpu_torch import native as port_native
from svsdf_tpu_torch.models import mesh_sdf
from svsdf_tpu_torch.viz import swept_surface as sw
from tests.test_swept3d import _unit_cube_mesh, _watertight

torch.set_num_threads(1)


@pytest.fixture
def python_marching_squares(monkeypatch):
    """The Python marching-squares loops of both packages (each one's
    fallback where its native runtime is absent)."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(port_native, "available", lambda: False)


def _to_port(jtraj):
    return convert.trajectory_from_numpy(np.asarray(jtraj.coeffs),
                                         np.asarray(jtraj.durations),
                                         device="cpu", dtype=torch.float64)


def _circle_line():
    head = jnp.zeros((3, 3))
    tail = jnp.zeros((3, 3)).at[0, 0].set(6.0)
    wps = jnp.asarray([[2.0, 0.0, 0.0], [4.0, 0.0, 0.0]])
    return jminco.solve(jnp.ones(3) * 2.0, head, tail, wps)


def test_marching_squares_matches_jax(python_marching_squares):
    xs = np.arange(-2.0, 2.0 + 0.1, 0.1)
    ys = np.arange(-1.5, 1.5 + 0.1, 0.1)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    # two blobs, so saddle cells occur between them
    field = np.minimum(np.hypot(gx - 0.6, gy) - 0.55,
                       np.hypot(gx + 0.6, gy) - 0.55)
    want = jsw.marching_squares(xs, ys, field, level=0.05)
    got = sw.marching_squares(xs, ys, field, level=0.05)
    assert len(got) == len(want) > 20
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_swept_boundary_circle_line_matches_jax(python_marching_squares):
    jtraj = _circle_line()
    bounds, eps = (-3, 9, -3, 3), 0.25
    xs, ys, want = jsw.svsdf_field(jshapes.make_shape("Circle"), jtraj,
                                   bounds, eps)
    from svsdf_tpu_torch.models import shapes
    circle = shapes.make_shape("Circle")
    pxs, pys, got = sw.svsdf_field(circle, _to_port(jtraj), bounds, eps)
    np.testing.assert_array_equal(pxs, xs)
    np.testing.assert_array_equal(pys, ys)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    # grid points such as (-1, 0) lie on the level set, where the two
    # fields' signs may differ by rounding: the contour is compared on the
    # port's field
    segs = sw.extract_swept_boundary(circle, _to_port(jtraj), bounds, eps)
    jsegs = jsw.marching_squares(xs, ys, got)
    assert len(segs) == len(jsegs) > 20
    for (a, b), (c, d) in zip(segs, jsegs):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    # the stadium: every boundary point ~1 m from the segment [0, 6] x {0}
    for (a, b) in segs[::5]:
        for p in (a, b):
            assert abs(np.hypot(p[0] - min(max(p[0], 0.0), 6.0), p[1])
                       - 1.0) < 0.15


def test_obj_writers_match_jax(tmp_path):
    segs = [(np.array([0.0, 0.0]), np.array([1.0, 0.0])),
            (np.array([1.0, 0.0]), np.array([1.0, 1.0]))]
    assert sw.write_swept_obj(segs, str(tmp_path / "a.obj")) == \
        jsw.write_swept_obj(segs, str(tmp_path / "b.obj")) == (8, 4)
    assert (tmp_path / "a.obj").read_text() == \
        (tmp_path / "b.obj").read_text()
    V, F = _unit_cube_mesh()
    assert sw.write_trimesh_obj(V, F, str(tmp_path / "c.obj")) == \
        jsw.write_trimesh_obj(V, F, str(tmp_path / "d.obj"))
    assert (tmp_path / "c.obj").read_text() == \
        (tmp_path / "d.obj").read_text()


@pytest.mark.parametrize("case", ["sphere", "empty"])
def test_marching_tetrahedra_matches_jax(case):
    eps = 0.125 if case == "sphere" else 0.25
    ax = np.arange(-1.6, 1.6 + eps, eps) if case == "sphere" else \
        np.arange(0.0, 1.0, eps)
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    field = (np.sqrt(gx**2 + gy**2 + gz**2) - 1.0 if case == "sphere"
             else np.ones(gx.shape))
    V, F = sw.marching_tetrahedra(ax, ax, ax, field)
    Vj, Fj = jsw.marching_tetrahedra(ax, ax, ax, field)
    np.testing.assert_array_equal(V, Vj)
    np.testing.assert_array_equal(F, Fj)
    if case == "sphere":
        assert len(F) > 100 and _watertight(V, F) and sw.is_watertight(F)
    else:
        assert len(F) == 0 and not sw.is_watertight(F)


def test_swept_volume_3d_cube_matches_jax():
    """A unit cube swept 2 m along +x (tests/test_swept3d.py): the grid,
    the swept field and its watertight surface against the JAX sweep."""
    V, F = _unit_cube_mesh()
    jg = jmesh.grid_sdf_3d(V, F, resolution=0.1, margin=0.6)
    g = mesh_sdf.grid_sdf_3d(V, F, resolution=0.1, margin=0.6)
    assert (g.nx, g.ny, g.nz) == (jg.nx, jg.ny, jg.nz)
    np.testing.assert_array_equal(g.values,
                                  np.asarray(jg.values, np.float32))
    head = jnp.zeros((3, 3))
    tail = jnp.zeros((3, 3)).at[0, 0].set(2.0)
    wps = jnp.asarray([[0.7, 0.0, 0.0], [1.4, 0.0, 0.0]])
    jtraj = jminco.solve(jnp.asarray([1.0, 1.0, 1.0]), head, tail, wps)
    bounds, eps = (-1.2, 3.2, -1.2, 1.2, -1.2, 1.2), 0.125
    xs, ys, zs, want = jsw.swept_field_3d(jg.sdf_xyz, jtraj, bounds, eps,
                                          n_t=96)
    pxs, pys, pzs, got = sw.swept_field_3d(g.sdf_xyz, _to_port(jtraj),
                                           bounds, eps, n_t=96)
    for a, b in ((pxs, xs), (pys, ys), (pzs, zs)):
        np.testing.assert_array_equal(a, b)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    Vs, Fs = sw.extract_swept_volume_3d(g.sdf_xyz, _to_port(jtraj), bounds,
                                        eps, n_t=96)
    Vj, _ = jsw.marching_tetrahedra(xs, ys, zs, want)
    assert sw.is_watertight(Fs)
    np.testing.assert_allclose(Vs.min(0), Vj.min(0), atol=eps)
    np.testing.assert_allclose(Vs.max(0), Vj.max(0), atol=eps)
    np.testing.assert_allclose(Vs.min(0), [-0.5, -0.5, -0.5], atol=2 * eps)
    np.testing.assert_allclose(Vs.max(0), [2.5, 0.5, 0.5], atol=2 * eps)

