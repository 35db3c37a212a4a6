"""Closed-loop flight: planned trajectories -> controller -> dynamics
(svsdf_tpu/sim/closed_loop.py).

The reference wires traj_server -> so3_control -> so3_quadrotor_
simulator as three ROS processes exchanging topics at 100 Hz
(run_sdHeart.launch:22-48); here the identical loop runs a fleet of B
trajectories in lockstep on their device: per control tick, the
sampled command, one SO(3) control step and ``substeps`` RK4 substeps
(the JAX package runs it as one ``lax.scan``, vmapped over fleets).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from svsdf_tpu_torch.planner import traj_server
from svsdf_tpu_torch.sim import so3_control
from svsdf_tpu_torch.sim.quadrotor import QuadParams, hover_state, step_rk4
from svsdf_tpu_torch.utils import trajectory as trj


class FlightLog(NamedTuple):
    t: torch.Tensor           # (B, T)
    pos: torch.Tensor         # (B, T, 3) simulated positions
    ref_pos: torch.Tensor     # (B, T, 3) commanded positions
    vel: torch.Tensor         # (B, T, 3)
    track_err: torch.Tensor   # (B, T) |pos - ref|


def fly(traj: trj.Trajectory,
        cfg: traj_server.TrajServerConfig = traj_server.TrajServerConfig(),
        gains: so3_control.SO3Gains = so3_control.SO3Gains(),
        params: QuadParams = QuadParams(),
        substeps: int = 5) -> FlightLog:
    """Fly B planned SE(2) trajectories (x, y, yaw in the z slot) with
    the full dynamic stack at cfg.rate_hz; z is held at 0 reference. The
    fleet runs the longest lane's ticks: lane b's first
    ``traj_server.n_ticks`` ticks are its own flight, after which it
    holds its end point."""
    cmds = traj_server.sample_commands(traj, cfg)
    # SE(2) plan: z-component of pos is YAW (SURVEY: 2.5D state) — the
    # simulated drone flies the xy path at constant altitude.
    flat = lambda a: torch.cat([a[..., :2], torch.zeros_like(a[..., 2:])],
                               -1)
    ref_pos, ref_vel, ref_acc = (flat(cmds.pos), flat(cmds.vel),
                                 flat(cmds.acc))
    dt = 1.0 / cfg.rate_hz
    sub_dt = dt / substeps

    s = hover_state(ref_pos[:, 0])
    pos, vel = [], []
    for k in range(ref_pos.shape[1]):
        f, M = so3_control.control(s, ref_pos[:, k], ref_vel[:, k],
                                   ref_acc[:, k], cmds.yaw[:, k], gains,
                                   params)
        for _ in range(substeps):
            s = step_rk4(s, f, M, sub_dt, params)
        pos.append(s.pos)
        vel.append(s.vel)
    pos, vel = torch.stack(pos, 1), torch.stack(vel, 1)
    err = torch.linalg.vector_norm(pos - ref_pos, dim=-1)
    return FlightLog(cmds.t, pos, ref_pos, vel, err)
