"""Port parity: procedural maps, the occupancy grid and the shape loader.

``svsdf_tpu_torch/utils/mapgen.py`` and ``utils/gridmap.py`` are the
port's own numpy copies; the same seeds must give the same clouds, and
the same clouds the same grids (each package voxelizes through its
native library when it is built, else through numpy). All comparisons
are exact.
"""

import numpy as np
import pytest
import torch

from svsdf_tpu.models import shapes as jshapes
from svsdf_tpu.utils import mapgen as jmapgen
from svsdf_tpu.utils.gridmap import GridMap as JGridMap
from svsdf_tpu_torch import convert
from svsdf_tpu_torch.bench import write_prism_obj
from svsdf_tpu_torch.models import shapes
from svsdf_tpu_torch.utils import mapgen
from svsdf_tpu_torch.utils.gridmap import GridMap

torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(jmapgen.GENERATORS))
def test_generators_match(name):
    a = mapgen.generate(name, res=0.5, seed=3)
    b = jmapgen.generate(name, res=0.5, seed=3)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("res,thr", [(1.0, 1), (0.5, 2)])
def test_gridmap_matches(res, thr):
    pts = mapgen.map_forest(res=0.5, seed=3, n_trees=14)
    g, jg = GridMap.from_points(pts, res, thr), JGridMap.from_points(
        pts, res, thr)
    assert g.size == jg.size
    np.testing.assert_array_equal(g.occ, jg.occ)
    np.testing.assert_array_equal(g.xyz_min, jg.xyz_min)
    np.testing.assert_array_equal(g.occ2d, jg.occ2d)
    probes = np.asarray([[3.3, 7.9, 0.2], [-5.0, 100.0, 1.0],
                         [30.0, 30.0, 30.0]])
    for p in probes:
        np.testing.assert_array_equal(g.grid_index(p), jg.grid_index(p))
        assert g.in_map(p) == jg.in_map(p)
    np.testing.assert_array_equal(g.cube_center((4, 5, 1)),
                                  jg.cube_center((4, 5, 1)))
    np.testing.assert_array_equal(
        g.points_in_aabb((20.0, 20.0, 1.0), (4.0, 4.0, 1.0)),
        jg.points_in_aabb((20.0, 20.0, 1.0), (4.0, 4.0, 1.0)))
    centers = np.asarray([[10.0, 12.0, 0.3], [25.0, 30.0, -0.5]])
    np.testing.assert_array_equal(g.harvest_along_path(centers, 3.0),
                                  jg.harvest_along_path(centers, 3.0))
    assert g.is_occupied_idx(-1, 0, 0) and jg.is_occupied_idx(-1, 0, 0)
    carried = convert.gridmap_from_numpy(jg.resolution, jg.xyz_min, jg.occ)
    np.testing.assert_array_equal(carried.occupied_centers_2d(),
                                  g.occupied_centers_2d())


def test_occupied_centers_are_the_e2e_obstacle_set():
    """The port's helper gives bench.py's occupied-cell centres."""
    g = GridMap.from_points(mapgen.map_forest(res=0.5, seed=3, n_trees=14),
                            1.0, 1)
    ii, jj = np.nonzero(g.occ2d)
    want = np.stack([g.xyz_min[0] + (ii + 0.5) * g.resolution,
                     g.xyz_min[1] + (jj + 0.5) * g.resolution],
                    -1).astype(np.float32)
    got = g.occupied_centers_2d()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_gridmap_rejects_empty_cloud():
    with pytest.raises(ValueError):
        GridMap.from_points(np.zeros((0, 3)), 1.0)


def test_shape_from_objpath(tmp_path):
    # a known analytic stem wins, with the pre-transform
    s = shapes.shape_from_objpath("shapes/sdMoon.obj", (0.5, 0.0, 10.0))
    js = jshapes.shape_from_objpath("shapes/sdMoon.obj", (0.5, 0.0, 10.0))
    assert (s.name, s.tx, s.ty, s.yaw0) == (js.name, js.tx, js.ty, js.yaw0)
    # a missing file falls back to the thin-rectangle Polygon
    s = shapes.shape_from_objpath(str(tmp_path / "nothere.obj"))
    js = jshapes.shape_from_objpath(str(tmp_path / "nothere.obj"))
    assert s.name == js.name == "Polygon"
    p = np.random.default_rng(0).uniform(-7, 7, (50, 2))
    np.testing.assert_allclose(
        s.sdf(torch.as_tensor(p)).numpy(),
        np.asarray(js.sdf(p)), rtol=0, atol=1e-6)
    # an existing .obj of an unknown name is a mesh robot, as in JAX; a
    # file without faces fails in both packages' mesh precompute
    mesh = tmp_path / "robot.obj"
    mesh.write_text("v 0 0 0\n")
    for factory in (shapes.shape_from_objpath, jshapes.shape_from_objpath):
        with pytest.raises(IndexError):
            factory(str(mesh))
    write_prism_obj("Circle", str(mesh), extent=2.0)
    s = shapes.shape_from_objpath(str(mesh))
    js = jshapes.shape_from_objpath(str(mesh))
    assert s.name == js.name == "mesh:robot" and s.grid is not None
