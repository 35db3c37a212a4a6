"""Trajectory wire formats — the planner <-> executor boundary
(svsdf_tpu/io/polytraj.py).

Re-design of the reference's ROS message layer:

  * ``PolyTraj``  — piecewise-polynomial trajectory message
    (`src/common/traj_utils/msg/PolyTraj.msg:1-9`): per-axis flat
    coefficient arrays (6 per quintic piece, HIGHEST power first — the
    order consumed by `Piece::getPos`'s Horner loop,
    `src/utils/include/utils/trajectory.hpp:104-113` — and by
    `traj_server.cpp:38-75`'s decoder), plus per-piece durations.
  * ``MincoTraj`` — compact MINCO parameterization message
    (`src/common/traj_utils/msg/MINCOTraj.msg`): boundary conditions +
    inner waypoints + durations; decoding re-runs the banded MINCO
    solve, so the wire cost is O(N) instead of O(6N) per axis.
  * ``PositionCommand`` — the 100 Hz executor output
    (`src/common/quadrotor_msgs/msg/PositionCommand.msg`).

The messages are plain NamedTuples of host numpy arrays with
``to_dict``/``from_dict`` JSON round-trips, the JAX package's wire format
byte for byte: a message either package writes, the other reads. A
message carries one trajectory, so encoding takes a batch of one (what
``PlanResult.traj`` and ``ReplanResult.traj`` are) and decoding returns
one, on ``device``.
"""

from __future__ import annotations

import json
from typing import NamedTuple

import numpy as np
import torch

from svsdf_tpu_torch import resolve_device
from svsdf_tpu_torch.ops import minco
from svsdf_tpu_torch.utils import trajectory as trj


class TrajectoryStatus:
    """PositionCommand.trajectory_flag values
    (quadrotor_msgs/PositionCommand.msg constants)."""
    EMPTY = 0
    READY = 1
    COMPLETED = 3
    ABORT = 4
    ILLEGAL_START = 5
    ILLEGAL_FINAL = 6
    IMPOSSIBLE = 7


class PolyTraj(NamedTuple):
    drone_id: int
    traj_id: int
    start_time: float
    order: int
    coef_x: np.ndarray    # (N * (order+1),) highest power first
    coef_y: np.ndarray
    coef_z: np.ndarray
    duration: np.ndarray  # (N,)

    def to_dict(self) -> dict:
        return {
            "drone_id": int(self.drone_id),
            "traj_id": int(self.traj_id),
            "start_time": float(self.start_time),
            "order": int(self.order),
            "coef_x": np.asarray(self.coef_x, np.float64).tolist(),
            "coef_y": np.asarray(self.coef_y, np.float64).tolist(),
            "coef_z": np.asarray(self.coef_z, np.float64).tolist(),
            "duration": np.asarray(self.duration, np.float64).tolist(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PolyTraj":
        return cls(int(d["drone_id"]), int(d["traj_id"]),
                   float(d["start_time"]), int(d["order"]),
                   np.asarray(d["coef_x"], np.float64),
                   np.asarray(d["coef_y"], np.float64),
                   np.asarray(d["coef_z"], np.float64),
                   np.asarray(d["duration"], np.float64))

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_json(cls, s: str) -> "PolyTraj":
        return cls.from_dict(json.loads(s))


class MincoTraj(NamedTuple):
    drone_id: int
    traj_id: int
    start_time: float
    des_clearance: float
    order: int
    start_p: np.ndarray   # (3,)
    start_v: np.ndarray
    start_a: np.ndarray
    end_p: np.ndarray
    end_v: np.ndarray
    end_a: np.ndarray
    inner_x: np.ndarray   # (N-1,)
    inner_y: np.ndarray
    inner_z: np.ndarray
    duration: np.ndarray  # (N,)

    def to_dict(self) -> dict:
        d = self._asdict()
        out = {}
        for k, v in d.items():
            if isinstance(v, np.ndarray):
                out[k] = np.asarray(v, np.float64).tolist()
            else:
                out[k] = v
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "MincoTraj":
        arrs = {k: np.asarray(d[k], np.float64) for k in
                ("start_p", "start_v", "start_a", "end_p", "end_v",
                 "end_a", "inner_x", "inner_y", "inner_z", "duration")}
        return cls(int(d["drone_id"]), int(d["traj_id"]),
                   float(d["start_time"]), float(d["des_clearance"]),
                   int(d["order"]), **arrs)


class PositionCommand(NamedTuple):
    """quadrotor_msgs/PositionCommand parity (the traj_server output,
    `traj_server.cpp:138-163`)."""
    t: float
    position: np.ndarray      # (3,)
    velocity: np.ndarray
    acceleration: np.ndarray
    jerk: np.ndarray
    yaw: float
    yaw_dot: float
    trajectory_id: int = 0
    trajectory_flag: int = TrajectoryStatus.READY

    def to_dict(self) -> dict:
        return {
            "t": float(self.t),
            "position": np.asarray(self.position, np.float64).tolist(),
            "velocity": np.asarray(self.velocity, np.float64).tolist(),
            "acceleration": np.asarray(self.acceleration,
                                       np.float64).tolist(),
            "jerk": np.asarray(self.jerk, np.float64).tolist(),
            "yaw": float(self.yaw),
            "yaw_dot": float(self.yaw_dot),
            "trajectory_id": int(self.trajectory_id),
            "trajectory_flag": int(self.trajectory_flag),
        }


def _host64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, np.float64)


def _only(traj: trj.Trajectory) -> trj.Trajectory:
    if traj.coeffs.shape[0] != 1:
        raise ValueError("a message carries one trajectory: pass a batch "
                         f"of one, not {traj.coeffs.shape[0]}")
    return traj


# ---------------------------------------------------------------------------
# Trajectory <-> PolyTraj
# ---------------------------------------------------------------------------

def encode_poly_traj(traj: trj.Trajectory, drone_id: int = 0,
                     traj_id: int = 1,
                     start_time: float = 0.0) -> PolyTraj:
    """A batch of one Trajectory (ascending-power coeffs, (1, N, 6, D)) ->
    PolyTraj (per-axis flat arrays, highest power first — the reference
    wire order, `traj_server.cpp:52-66`). D may be 2 (z filled with
    zeros) or 3 (z = yaw, the reference's SE(2)-in-z convention)."""
    traj = _only(traj)
    coeffs = _host64(traj.coeffs[0])                   # (N, nc, D)
    n, nc, dim = coeffs.shape
    desc = coeffs[:, ::-1, :]                          # highest first
    flat = desc.reshape(n * nc, dim)
    cz = (flat[:, 2] if dim >= 3
          else np.zeros(n * nc, np.float64))
    return PolyTraj(drone_id, traj_id, start_time, nc - 1,
                    flat[:, 0].copy(), flat[:, 1].copy(), cz.copy(),
                    _host64(traj.durations[0]).copy())


def decode_poly_traj(msg: PolyTraj, device=None) -> trj.Trajectory:
    """PolyTraj -> a batch of one float32 Trajectory on ``device`` (None:
    CUDA). Mirrors polyTrajCallback's validation
    (`traj_server.cpp:45-56`): order must be 5 and coefficient array
    lengths must equal N*(order+1)."""
    if msg.order != 5:
        raise ValueError(
            f"only order-5 trajectories supported, got {msg.order}")
    nc = msg.order + 1
    n, rem = divmod(len(msg.coef_x), nc)
    if rem or n != len(msg.duration) or \
            len(msg.coef_y) != len(msg.coef_x) or \
            len(msg.coef_z) != len(msg.coef_x):
        raise ValueError("inconsistent PolyTraj coefficient lengths")
    dev = resolve_device(device)
    per_axis = np.stack([np.asarray(msg.coef_x, np.float64),
                         np.asarray(msg.coef_y, np.float64),
                         np.asarray(msg.coef_z, np.float64)], -1)
    asc = per_axis.reshape(n, nc, 3)[:, ::-1, :]
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32)[None],
                                    device=dev)
    return trj.Trajectory(f32(asc), f32(msg.duration))


# ---------------------------------------------------------------------------
# Trajectory <-> MincoTraj
# ---------------------------------------------------------------------------

def encode_minco_traj(times, head, tail, waypoints, drone_id: int = 0,
                      traj_id: int = 1, start_time: float = 0.0,
                      des_clearance: float = 0.0) -> MincoTraj:
    """MINCO parameters of one plan -> compact wire message
    (MINCOTraj.msg). times (N,); head/tail: (3, 3) rows (p, v, a);
    waypoints: (N-1, 3). Arrays or tensors."""
    head = _host64(head)
    tail = _host64(tail)
    wps = _host64(waypoints)
    return MincoTraj(drone_id, traj_id, start_time, des_clearance, 5,
                     head[0], head[1], head[2], tail[0], tail[1],
                     tail[2], wps[:, 0].copy(), wps[:, 1].copy(),
                     wps[:, 2].copy(), _host64(times).copy())


def decode_minco_traj(msg: MincoTraj, device=None) -> trj.Trajectory:
    """MincoTraj -> a batch of one float32 Trajectory on ``device`` (None:
    CUDA) by re-running the banded MINCO S3 solve — the receiving side
    reconstructs the quintic coefficients (minco.hpp setParameters
    semantics)."""
    dev = resolve_device(device)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32)[None],
                                    device=dev)
    head = np.stack([msg.start_p, msg.start_v, msg.start_a])
    tail = np.stack([msg.end_p, msg.end_v, msg.end_a])
    wps = np.stack([msg.inner_x, msg.inner_y, msg.inner_z], -1)
    return minco.solve(f32(msg.duration), f32(head), f32(tail), f32(wps))
