"""Port parity: the SE(2) A* front end (planner/astar.py).

Both packages search the same feasibility and transition maps: the JAX
package's, carried across as numpy (XLA's FMA contraction can flip
boundary cells of the JAX transition stencils, ROADMAP C, so the maps
are not recomputed). The port's search returns the same path, yaw bins
and expansion count as JAX ``astar.search`` with its Python loop and
with its C++ runtime, on the Circle corridor of tests/test_planner_e2e.py,
``synthetic_Polygon`` and the forest map with sdHeart, and fails the
same way for a goal outside the map and an unreachable goal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svsdf_tpu import native
from svsdf_tpu.models import shapes as jshapes
from svsdf_tpu.ops import kernels as jkops
from svsdf_tpu.planner import astar as jastar
from svsdf_tpu.utils import fixtures as jfixtures
from svsdf_tpu.utils import mapgen as jmapgen
from svsdf_tpu.utils.gridmap import GridMap as JGridMap
from svsdf_tpu_torch import convert
from svsdf_tpu_torch.planner import astar

torch.set_num_threads(1)


def _corridor_points():
    pts = []
    for x in range(24):
        for z in range(2):
            if not (10 <= x <= 13):
                pts.append((x + 0.5, 7.2, z + 0.5))
    pts += [(0.05, 0.05, 0.05), (23.9, 15.9, 1.9)]
    return np.asarray(pts)


def _maps(name, map_points, ksize, yaw_num, res):
    """The JAX package's grid, yaw feasibility and full-guard transition
    feasibility of one (map, shape), as the JAX Planner builds them."""
    grid = JGridMap.from_points(map_points, res, 1)
    shape = jshapes.make_shape(name)
    occ = jnp.asarray(grid.occ2d)
    kern = jkops.rasterize_shape_kernels(shape, ksize, yaw_num, res,
                                         max(0.0, res / 2.0))
    feas = np.asarray(jkops.feasibility_maps(occ, kern))
    guard = (ksize // 2 + 2) * res
    trans = np.asarray(jkops.transition_feasibility(
        occ, jkops.transition_stencils(shape, yaw_num, res,
                                       guard_half_world=guard)))
    return grid, feas, trans


@pytest.fixture(scope="module")
def cases():
    out = {}
    grid, feas, trans = _maps("Circle", _corridor_points(), 7, 4, 1.0)
    out["corridor"] = (grid, feas, trans, 4, (3.5, 3.5, 0.0),
                       (20.5, 12.5, 0.0))
    sc = jfixtures.synthetic_scenario("Polygon")
    grid, feas, trans = _maps("Polygon", sc.map_points, 15, 18, 1.0)
    out["synthetic_Polygon"] = (grid, feas, trans, 18, sc.start, sc.goal)
    forest = jmapgen.map_forest(res=0.5, seed=3, n_trees=14)
    grid, feas, trans = _maps("sdHeart", forest, 15, 8, 1.0)
    free = np.argwhere(feas.any(0))
    start = grid.cube_center((*free[0], 0))
    goal = grid.cube_center((*free[-1], 0))
    out["forest_sdHeart"] = (grid, feas, trans, 8, start, goal)
    return out


def _port_search(grid, feas, trans, yaw_num, start, goal):
    pgrid = convert.gridmap_from_numpy(grid.resolution, grid.xyz_min,
                                       grid.occ)
    return astar.search(pgrid, feas, trans, np.asarray(start),
                        np.asarray(goal), yaw_num)


def _assert_same(res, jres):
    assert res.success == jres.success
    assert res.expansions == jres.expansions
    np.testing.assert_array_equal(res.path, np.asarray(jres.path))
    np.testing.assert_array_equal(res.yaw_bins, np.asarray(jres.yaw_bins))


@pytest.mark.parametrize("native_loop", [False, True],
                         ids=["python", "native"])
@pytest.mark.parametrize("case", ["corridor", "synthetic_Polygon",
                                  "forest_sdHeart"])
def test_search_matches_jax(cases, case, native_loop):
    if native_loop:
        assert native.available()
    grid, feas, trans, yaw_num, start, goal = cases[case]
    res = _port_search(grid, feas, trans, yaw_num, start, goal)
    jres = jastar.search(grid, feas, trans, np.asarray(start),
                         np.asarray(goal), yaw_num, use_native=native_loop)
    assert res.success and len(res.path) > 10
    _assert_same(res, jres)
    # without the transition veto as well
    _assert_same(_port_search(grid, feas, None, yaw_num, start, goal),
                 jastar.search(grid, feas, None, np.asarray(start),
                               np.asarray(goal), yaw_num,
                               use_native=native_loop))


@pytest.mark.parametrize("native_loop", [False, True],
                         ids=["python", "native"])
def test_failures_match_jax(cases, native_loop):
    grid, feas, trans, yaw_num, start, _ = cases["corridor"]
    # a goal outside the map
    out = (40.0, 3.5, 0.0)
    res = _port_search(grid, feas, trans, yaw_num, start, out)
    jres = jastar.search(grid, feas, trans, np.asarray(start),
                         np.asarray(out), yaw_num, use_native=native_loop)
    assert not res.success and res.expansions == 0
    _assert_same(res, jres)
    # an unreachable goal: its cell fits no yaw bin
    goal = (20.5, 12.5, 0.0)
    gi = grid.grid_index(np.asarray(goal))
    blocked = feas.copy()
    blocked[:, gi[0], gi[1]] = False
    res = _port_search(grid, blocked, trans, yaw_num, start, goal)
    jres = jastar.search(grid, blocked, trans, np.asarray(start),
                         np.asarray(goal), yaw_num, use_native=native_loop)
    assert not res.success and res.expansions > 100
    _assert_same(res, jres)
