"""Carry the JAX package's state across to the port.

This system has no learned weights: its parameters are the problem,
the trajectory and the configurations. Each function here takes numpy
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
from svsdf_tpu_torch.planner.back_end import BackEndProblem
from svsdf_tpu_torch.utils.config import PlannerConfig
from svsdf_tpu_torch.utils.trajectory import Trajectory


def _tensor(a, device, dtype):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


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
    return _from_dict(SVSDFConfig, d)


def planner_config_from_dict(d: dict) -> PlannerConfig:
    return _from_dict(PlannerConfig, d)


def shape_from_spec(name: str,
                    poly_params: Sequence[float] = (0.0, 0.0, 0.0),
                    vertices: Optional[Sequence] = None) -> shapes.Shape2D:
    return shapes.make_shape(name, poly_params=poly_params,
                             vertices=vertices)
