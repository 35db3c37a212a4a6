"""Synthetic scenario fixtures (own copy of the synthetic part of
svsdf_tpu/utils/fixtures.py).

For the analytic shapes the reference ships no demo fixtures for, each
scenario is a gate map (one two-voxel-thick wall, one gap) sized to the
shape, so every shape family can be driven end to end without the
reference checkout. The loaders of the reference's 13 fixtures (PCD maps,
YAML configs) are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from svsdf_tpu_torch.utils.config import PlannerConfig


@dataclasses.dataclass
class Scenario:
    name: str
    config: PlannerConfig
    map_points: np.ndarray     # (N, 3)
    start: np.ndarray          # (3,) x, y, yaw
    goal: np.ndarray           # (3,)
    #: prebuilt robot shape overriding config.inputdata
    shape: object = None


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
