"""Carry the JAX package's state across to the port.

This system has no learned weights: its parameters are the problem,
the trajectory, the configurations, and the map with the front end's
feasibility tensors. Each function here takes numpy
arrays or plain dicts (``dataclasses.asdict`` of a JAX-side config) and
returns the port's form, so one set of inputs feeds both packages.
Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from svsdf_tpu_torch import resolve_device
from svsdf_tpu_torch.models import shapes
from svsdf_tpu_torch.ops.svsdf import SVSDFConfig
from svsdf_tpu_torch.planner.astar import AstarResult
from svsdf_tpu_torch.planner.back_end import BackEndProblem
from svsdf_tpu_torch.utils.config import PlannerConfig
from svsdf_tpu_torch.utils.fixtures import Scenario
from svsdf_tpu_torch.utils.gridmap import GridMap
from svsdf_tpu_torch.utils.trajectory import Trajectory


def _tensor(a, device, dtype):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def problem_from_numpy(head, tail, obstacles, x0, device=None,
                       dtype=torch.float32):
    """(B, 3, 3) head/tail, (B, M, >=2) obstacles, (B, 4N-3) x0 ->
    (BackEndProblem, x0 tensor). Obstacle z is dropped, as the JAX
    back end does."""
    dev = resolve_device(device)
    obs = np.asarray(obstacles)[..., :2]
    prob = BackEndProblem(_tensor(head, dev, dtype), _tensor(tail, dev, dtype),
                          _tensor(obs, dev, dtype))
    return prob, _tensor(x0, dev, dtype)


def trajectory_from_numpy(coeffs, durations, device=None,
                          dtype=torch.float32) -> Trajectory:
    """(N, 6, D) / (N,) of one plan, or (B, N, 6, D) / (B, N) of a
    batch -> a batched Trajectory."""
    dev = resolve_device(device)
    c = np.asarray(coeffs)
    d = np.asarray(durations)
    if c.ndim == 3:
        c, d = c[None], d[None]
    return Trajectory(_tensor(c, dev, dtype), _tensor(d, dev, dtype))


def _from_dict(cls, d: dict):
    known = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in known})


def svsdf_config_from_dict(d: dict) -> SVSDFConfig:
    """An SVSDFConfig from ``dataclasses.asdict`` of the JAX side's (e.g.
    scripts/run_scenarios.py's, ``gsip_fori`` included)."""
    return _from_dict(SVSDFConfig, d)


def planner_config_from_dict(d: dict) -> PlannerConfig:
    return _from_dict(PlannerConfig, d)


def shape_from_spec(name: str,
                    poly_params: Sequence[float] = (0.0, 0.0, 0.0),
                    vertices: Optional[Sequence] = None) -> shapes.Shape2D:
    return shapes.make_shape(name, poly_params=poly_params,
                             vertices=vertices)


def scaled_shape_from_fields(name: str, scale_fn, tx: float = 0.0,
                             ty: float = 0.0, yaw0: float = 0.0,
                             kernel_scale: float = 1.0,
                             vertices: Optional[Sequence] = None
                             ) -> shapes.ScaledShape:
    """A deformable robot from another package's ScaledShape fields (name,
    pre-transform tx, ty and yaw0 in radians, kernel_scale, a Polygon's
    vertices). ``scale_fn`` is the torch form of its scale schedule: a
    callable does not cross between packages, so the caller writes the
    same formula with torch operations."""
    base = shapes.make_scaled_shape(name, scale_fn, vertices=vertices,
                                    kernel_scale=kernel_scale)
    return dataclasses.replace(base, tx=float(tx), ty=float(ty),
                               yaw0=float(yaw0))


def mesh_shape_from_fields(values, x0: float, y0: float, step: float,
                           nx: int, ny: int, tx: float = 0.0,
                           ty: float = 0.0, yaw0: float = 0.0,
                           name: str = "mesh:robot") -> shapes.Shape2D:
    """A mesh robot from another package's grid fields (a GridSDF2D's
    values, origin, step and size, the robot's pre-transform tx, ty and
    yaw0 in radians, and its name "mesh:<stem>"): the grid is the mesh
    robot's "weights". The values are kept as float32, as the JAX package
    keeps them."""
    from svsdf_tpu_torch.models.mesh_sdf import GridSDF2D
    grid = GridSDF2D(np.asarray(values, np.float32), x0, y0, step, nx, ny)
    return shapes.Shape2D(name=name, body_sdf=grid.sdf_xy, tx=float(tx),
                          ty=float(ty), yaw0=float(yaw0), grid=grid)


def gridmap_from_numpy(resolution: float, xyz_min, occ) -> GridMap:
    """A GridMap from another package's grid fields (resolution, (3,)
    origin, (X, Y, Z) occupancy)."""
    return GridMap(resolution=float(resolution),
                   xyz_min=np.asarray(xyz_min, np.float64),
                   occ=np.asarray(occ, np.uint8))


def scenario_from_numpy(name: str, config: dict, map_points, start,
                        goal) -> Scenario:
    """A Scenario from a config dict (``dataclasses.asdict`` of the JAX
    side's) and numpy arrays."""
    return Scenario(name=name, config=planner_config_from_dict(config),
                    map_points=np.asarray(map_points, np.float64),
                    start=np.asarray(start, np.float64),
                    goal=np.asarray(goal, np.float64))


def front_end_maps_from_numpy(feas, occ_pts, trans_feas=None,
                              cell_cost=None, device=None):
    """The map tensors plan_batch_e2e takes, from numpy: feas (K, X, Y)
    bool, occ_pts (M, 2) float32, trans_feas (K, D, 8, X, Y) bool and
    cell_cost (X, Y) float32 (None stays None)."""
    dev = resolve_device(device)
    as_bool = lambda a: None if a is None else torch.as_tensor(
        np.array(a, bool), device=dev)
    as_f32 = lambda a: None if a is None else _tensor(a, dev, torch.float32)
    return (as_bool(feas), as_f32(occ_pts), as_bool(trans_feas),
            as_f32(cell_cost))


def astar_result_from_numpy(success, path, yaw_bins,
                            expansions) -> AstarResult:
    """An A* result of the JAX package (path (L, 3), yaw bins (L,),
    expansion count) in the port's form."""
    return AstarResult(bool(success), np.asarray(path, np.float64),
                       np.asarray(yaw_bins).astype(int), int(expansions))


def warm_start_from_numpy(opt_x, head, tail, device=None,
                          dtype=torch.float32):
    """A mid-end warm start of one plan (opt_x (4N-3,), head and tail
    (3, 3)) -> (opt_x (1, 4N-3), head (1, 3, 3), tail (1, 3, 3)) tensors,
    the leading plan axis of the port's mid and back ends."""
    dev = resolve_device(device)
    return tuple(_tensor(np.asarray(a)[None], dev, dtype)
                 for a in (opt_x, head, tail))
