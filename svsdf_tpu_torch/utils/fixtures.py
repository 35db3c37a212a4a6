"""Scenario fixtures (own copy of svsdf_tpu/utils/fixtures.py).

The reference's regression suite is its 13 shape scenarios, each a
(config/<shape>.yaml, pcds/map_<shape>.pcd, pcds/trajectory_<shape>.txt
with "Start:" / "End:" lines) triple under src/plan_manager of the
reference checkout (the loader LoadStartEnd,
src/plan_manager/src/plan_manager.cpp:359-422); ``mesh_scenario`` plans
one of them with the robot loaded from the reference's own .obj through
the mesh-SDF path. The checkout is read from ``SVSDF_REFERENCE_ROOT``,
by default ``reference/`` at the root of this repository; it is not in
the repository, so those loaders run only where it is provided.

For the analytic shapes the reference ships no demo fixtures for, each
synthetic scenario is a gate map (one two-voxel-thick wall, one gap)
sized to the shape, so every shape family can be driven end to end
without the reference checkout. The deformable scenarios thread a
breathing robot (models/shapes.py ScaledShape) through a gate sized for
its largest scale.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Tuple

import numpy as np

from svsdf_tpu_torch.models import shapes
from svsdf_tpu_torch.utils.config import PlannerConfig
from svsdf_tpu_torch.utils.pcd import read_pcd

REFERENCE_ROOT = os.environ.get(
    "SVSDF_REFERENCE_ROOT",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "reference"))
_PM = "src/plan_manager"


@dataclasses.dataclass
class Scenario:
    name: str
    config: PlannerConfig
    map_points: np.ndarray     # (N, 3)
    start: np.ndarray          # (3,) x, y, yaw
    goal: np.ndarray           # (3,)
    #: prebuilt robot shape overriding config.inputdata
    shape: object = None


def list_scenarios(root: str = REFERENCE_ROOT):
    """The reference scenarios under ``root``: each config YAML with its
    map PCD."""
    cfg_dir = os.path.join(root, _PM, "config")
    names = []
    for f in sorted(os.listdir(cfg_dir)):
        if f.endswith(".yaml"):
            name = f[:-5]
            if os.path.exists(os.path.join(root, _PM, "pcds",
                                           f"map_{name}.pcd")):
                names.append(name)
    return names


def load_start_end(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse the "Start: x y z" / "End: x y z" fixture lines
    (plan_manager.cpp:396-421)."""
    start = np.zeros(3)
    end = np.zeros(3)
    with open(path) as f:
        for line in f:
            m = re.match(r"\s*Start:\s+([-\d.eE]+)\s+([-\d.eE]+)"
                         r"\s+([-\d.eE]+)", line)
            if m:
                start = np.asarray([float(g) for g in m.groups()])
            m = re.match(r"\s*End:\s+([-\d.eE]+)\s+([-\d.eE]+)"
                         r"\s+([-\d.eE]+)", line)
            if m:
                end = np.asarray([float(g) for g in m.groups()])
    return start, end


def load_scenario(name: str, root: str = REFERENCE_ROOT) -> Scenario:
    """One reference scenario: its YAML config, PCD map and start / goal."""
    cfg = PlannerConfig.from_yaml(
        os.path.join(root, _PM, "config", f"{name}.yaml"))
    pts = read_pcd(os.path.join(root, _PM, "pcds", f"map_{name}.pcd"))
    start, goal = load_start_end(
        os.path.join(root, _PM, "pcds", f"trajectory_{name}.txt"))
    return Scenario(name=name, config=cfg, map_points=pts,
                    start=start, goal=goal)


def mesh_scenario(ref_name: str, root: str = REFERENCE_ROOT,
                  resolution: float = 0.05) -> Scenario:
    """A reference scenario planned with the robot loaded from the
    reference's own .obj (src/plan_manager/shapes/) through the mesh-SDF
    path (models/mesh_sdf.py) instead of the analytic SDF: the BasicShape
    mesh route (Shape.hpp:284-340) on the reference's robot geometry."""
    from svsdf_tpu_torch.models.mesh_sdf import shape_from_mesh

    sc = load_scenario(ref_name, root=root)
    objpath = os.path.join(root, _PM, "shapes", f"{ref_name}.obj")
    if not os.path.isfile(objpath):
        raise FileNotFoundError(objpath)
    sc.name = f"mesh_{ref_name}"
    sc.shape = shape_from_mesh(objpath, resolution=resolution,
                               poly_params=sc.config.poly_params)
    return sc


#: shape -> (max body radius [m], kernel_size, kernel_yaw_num)
_SYNTHETIC = {
    "Circle": (1.0, 7, 4),
    "sdTrapezoid": (3.6, 11, 12),
    "bigX": (3.8, 11, 12),
    "sdMoon": (3.0, 9, 12),
    "Polygon": (6.0, 15, 18),
}


def list_synthetic_scenarios():
    return sorted(_SYNTHETIC)


def synthetic_scenario(name: str) -> Scenario:
    """Gate-map scenario for a shape without a reference fixture. The
    gap is radius+1 m on each side of the wall centre: passable, but
    tight enough that the swept-volume penalty is live."""
    if name not in _SYNTHETIC:
        raise KeyError(f"no synthetic scenario for {name!r}; "
                       f"have {list_synthetic_scenarios()}")
    radius, ksize, yawn = _SYNTHETIC[name]
    half_gap = radius + 1.0
    height = max(24.0, 4.0 * radius + 12.0)
    mid = height / 2.0
    pts = []
    for x in (24.0, 25.0):                   # 2-voxel-thick wall
        for y in np.arange(0.5, height, 1.0):
            if abs(y - mid) > half_gap:
                for z in (0.5, 1.5):
                    pts.append((x + 0.5, y, z))
    # domain markers (map bounds are measured from the cloud)
    pts += [(0.05, 0.05, 0.05), (49.9, height - 0.1, 1.9)]
    cfg = PlannerConfig(inputdata=f"shapes/{name}.obj",
                        kernel_size=ksize, kernel_yaw_num=yawn,
                        occupancy_resolution=1.0, safety_hor=0.4,
                        loadStartEnd=False)
    start = np.asarray([6.5, mid + 0.5, 0.0])
    goal = np.asarray([43.5, mid + 0.5, 0.0])
    return Scenario(name=f"synthetic_{name}", config=cfg,
                    map_points=np.asarray(pts), start=start, goal=goal)


def list_deformable_scenarios():
    return ["deformable_heart", "deformable_rhombus", "deformable_star"]


#: deformable scenario -> (body, scale amplitude, angular rate,
#: kernel_scale, half gap, map height, kernel_size): s(t) = 1 + amp *
#: sin(rate * t), the front end's kernels at the largest scale
_DEFORMABLE = {
    # breathing sdHeart (max body radius ~4.6 m, +25% inflation): a
    # curved, asymmetric SDF through the scale hook; its round footprint
    # cannot thread tighter than its max-scale width, so the gate is roomy
    "deformable_heart": ("sdHeart", 0.25, 0.8, 1.25, 6.4, 36.0, 15),
    # breathing sdRhombus: long axis ~4.4 m but narrow across, so it
    # threads the 3.6 m half gap sideways while inflating 20%: wall voxels
    # land in the harvest band and certify-refine is live
    "deformable_rhombus": ("sdRhombus", 0.2, 0.8, 1.2, 3.6, 28.0, 13),
    # max-scale star radius ~3.8 m: a 4.2 m half gap keeps the
    # conservative front end feasible with wall voxels in the bd/3 band
    "deformable_star": ("star", 0.35, 0.9, 1.35, 4.2, 28.0, 13),
}


def deformable_scenario(name: str = "deformable_star") -> Scenario:
    """Breathing-scale robot scenario: the paper's ``useScale`` demos
    (sw_manager.hpp:495-518). The front end plans with conservative
    max-scale kernels (ScaledShape.sdf_xy at kernel_scale), the SVSDF
    certificate sees the true time-varying sweep."""
    if name not in _DEFORMABLE:
        raise KeyError(name)
    body, amp, rate, kscale, half_gap, height, ksize = _DEFORMABLE[name]
    shape = shapes.make_scaled_shape(
        body, shapes.breathing_scale(amp, rate), kernel_scale=kscale)
    mid = height / 2.0
    pts = []
    for x in (24.5, 25.5):
        for y in np.arange(0.5, height, 1.0):
            if abs(y - mid) > half_gap:
                for z in (0.5, 1.5):
                    pts.append((x, y, z))
    pts += [(0.05, 0.05, 0.05), (49.9, height - 0.1, 1.9)]
    cfg = PlannerConfig(inputdata=f"shapes/{body}.obj", kernel_size=ksize,
                        kernel_yaw_num=12, occupancy_resolution=1.0,
                        safety_hor=0.4, loadStartEnd=False)
    return Scenario(name=name, config=cfg, map_points=np.asarray(pts),
                    start=np.asarray([6.5, mid + 0.5, 0.0]),
                    goal=np.asarray([43.5, mid + 0.5, 0.0]), shape=shape)


def load_any(name: str, root: str = REFERENCE_ROOT) -> Scenario:
    """A scenario by the repo's naming convention: ``synthetic_*`` (gate
    maps), ``deformable_*`` (breathing robots), ``mesh_*`` (a reference
    scenario with its mesh robot), anything else a reference scenario
    (plan_manager.cpp:359-422)."""
    if name.startswith("synthetic_"):
        return synthetic_scenario(name.removeprefix("synthetic_"))
    if name.startswith("deformable_"):
        return deformable_scenario(name)
    if name.startswith("mesh_"):
        return mesh_scenario(name.removeprefix("mesh_"), root=root)
    return load_scenario(name, root=root)
