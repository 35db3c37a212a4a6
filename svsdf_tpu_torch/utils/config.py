"""Flat planner configuration (own copy of svsdf_tpu/utils/config.py).

Field names and defaults match the JAX package's ``PlannerConfig``
field for field, which in turn match the reference Config struct, so
``dataclasses.asdict`` of one loads into the other
(``convert.planner_config_from_dict``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    # shape / robot
    inputdata: str = "shapes/sdHeart.obj"
    poly_params: Sequence[float] = (0.0, 0.0, 0.0)
    loadStartEnd: bool = True
    colli_thres: float = 0.15
    selfmapresu: float = 0.05
    threads_num: int = 12

    momentum: float = 0.0
    eps: float = 0.3
    testRate: float = 100.0
    scale: float = 2.0
    ts: float = 2.0

    # flatness model
    vehicleMass: float = 0.61
    gravAcc: float = 9.8
    horizDrag: float = 0.10
    vertDrag: float = 0.10
    parasDrag: float = 0.01
    speedEps: float = 0.0001

    # map
    mapTopic: str = "/voxel_map"
    voxelWidth: float = 0.15
    mapBound: Sequence[float] = (-25.0, 25.0, -25.0, 25.0, 0.0, 15.0)
    occupancy_resolution: float = 1.0
    debug_output: bool = False
    sta_threshold: int = 1
    kernel_size: int = 21
    kernel_yaw_num: int = 18
    front_end_safeh: float = 0.0

    # back end
    enableearlyExit: bool = True
    debugpause: int = 1
    smoothingEps: float = 1.0e-2
    integralIntervs: int = 4
    relCostTol: float = 1.0e-20
    relCostTolMidEnd: float = 1.0e-10
    vmax: float = 10.0
    omgmax: float = 10.0
    thetamax: float = 100.0
    weight_v: float = 10.0
    weight_a: float = 10.0
    weight_p: float = 60.0
    weight_pr: float = 40.0
    weight_ar: float = 0.0
    weight_omg: float = 10.0
    weight_theta: float = 10.0
    rho_mid_end: float = 2.0
    rho: float = 3.8
    safety_hor: float = 0.8
    inittime: float = 2.5

    # L-BFGS / LMBM solver knobs
    mem_size: int = 16
    past: int = 64
    min_step: float = 1.0e-32
    g_epsilon: float = 0.0
    back_rel_stall: float = 1.0e-6
    back_max_ls: int = 8

    # topics kept for config-file compatibility (unused here)
    meshTopic: str = "/polyve/mesh"
    edgeTopic: str = "/polyve/edge"
    vertexTopic: str = "/polyve/vert"

    def __post_init__(self):
        object.__setattr__(self, "poly_params", tuple(self.poly_params))
        object.__setattr__(self, "mapBound", tuple(self.mapBound))

    @property
    def shape_name(self) -> str:
        stem = self.inputdata.rsplit("/", 1)[-1]
        return stem[:-4] if stem.endswith(".obj") else stem

    @classmethod
    def from_yaml(cls, path: str) -> "PlannerConfig":
        """The config of one of the reference's per-shape YAML files
        (src/plan_manager/config/*.yaml); keys that are not fields are
        ignored."""
        import yaml
        with open(path) as f:
            raw = yaml.safe_load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in known})
