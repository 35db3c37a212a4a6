"""Checkpoint / resume for planning runs (svsdf_tpu/utils/checkpoint.py).

The reference's only persistence is start/goal fixture files
(`plan_manager.cpp:359-422`), an OBJ export, and the in-memory mid-end
-> back-end `opt_x` warm-start handoff (SURVEY.md §5). This module
makes all three first-class and adds batch-run checkpointing:

  * `save_plan` / `load_plan` — one plan artifact: decision vector,
    trajectory coefficients/durations, costs, config echo. The loaded
    `opt_x` warm-starts `back_end.optimize`.
  * `save_batch` / `load_batch` — a batched run's decision vectors +
    per-scenario costs/converged flags; `resume_mask` tells the caller
    which scenarios still need iterations.
  * plain `.npz` + JSON metadata in the JAX package's layout, so a
    checkpoint either package writes, the other loads. Tensors go to
    numpy on save; loading returns tensors on ``device`` (None: CUDA).

One plan is stored unbatched, as the JAX package stores it: `save_plan`
takes a batch of one (opt_x (1, n), a Trajectory (1, N, 6, D)) and
`load_plan` returns one.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from svsdf_tpu_torch import resolve_device
from svsdf_tpu_torch.utils import trajectory as trj


class PlanCheckpoint(NamedTuple):
    opt_x: torch.Tensor                 # (1, n)
    traj: Optional[trj.Trajectory]      # a batch of one
    meta: Dict[str, Any]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x)


def _one(x) -> np.ndarray:
    x = _host(x)
    if x.shape[:1] != (1,):
        raise ValueError(f"save_plan stores one plan: a batch of one, got "
                         f"shape {x.shape}")
    return x[0]


def _meta(meta) -> np.ndarray:
    return np.frombuffer(json.dumps(meta, default=float).encode(),
                         dtype=np.uint8)


def _savez(path: str, arrays) -> str:
    """Write atomically: tmp + rename."""
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)
    return path


def save_plan(path: str, opt_x, traj: Optional[trj.Trajectory] = None,
              **meta) -> str:
    """Write one plan checkpoint (atomic: tmp + rename)."""
    arrays = {"opt_x": _one(opt_x)}
    if traj is not None:
        arrays["coeffs"] = _one(traj.coeffs)
        arrays["durations"] = _one(traj.durations)
    arrays["meta_json"] = _meta(meta)
    return _savez(path, arrays)


def load_plan(path: str, device=None) -> PlanCheckpoint:
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(a[None], device=dev)
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta_json"]).decode())
        traj = None
        if "coeffs" in z:
            traj = trj.Trajectory(t(z["coeffs"]), t(z["durations"]))
        return PlanCheckpoint(t(z["opt_x"]), traj, meta)


def save_batch(path: str, x_b, cost_b, converged_b, it: int = 0,
               **meta) -> str:
    """Checkpoint a batched solve mid-run (e.g. between continuation
    stages)."""
    return _savez(path, {
        "x": _host(x_b),
        "cost": _host(cost_b),
        "converged": _host(converged_b),
        "it": np.asarray(it),
        "meta_json": _meta(meta),
    })


class BatchCheckpoint(NamedTuple):
    x: torch.Tensor
    cost: torch.Tensor
    converged: torch.Tensor
    it: int
    meta: Dict[str, Any]

    @property
    def resume_mask(self) -> torch.Tensor:
        """Scenarios that still need work after a restart."""
        return ~self.converged.bool()


def load_batch(path: str, device=None) -> BatchCheckpoint:
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(a, device=dev)
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta_json"]).decode())
        return BatchCheckpoint(t(z["x"]), t(z["cost"]), t(z["converged"]),
                               int(z["it"]), meta)


def save_start_end(path: str, start, goal) -> str:
    """The reference's fixture format (`plan_manager.cpp:359-422`,
    `pcds/trajectory_<shape>.txt`): 'Start:' / 'End:' lines with
    x y yaw."""
    start = _host(start).astype(float).ravel()
    goal = _host(goal).astype(float).ravel()
    with open(path, "w") as f:
        f.write(f"Start: {start[0]} {start[1]} {start[2]}\n")
        f.write(f"End: {goal[0]} {goal[1]} {goal[2]}\n")
    return path
