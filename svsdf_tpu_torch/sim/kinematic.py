"""Kinematic "fake drone": position commands -> perfect odometry
(svsdf_tpu/sim/kinematic.py).

Re-design of fake_drone/poscmd_2_odom
(`src/uav_simulator/fake_drone/src/poscmd_2_odom.cpp:16-60`), the
closed-loop "simulator" of every shipped demo: the drone is assumed to
track commands perfectly, and the odometry orientation is
reconstructed from the commanded acceleration + gravity and yaw.

Instead of a 100 Hz ROS callback, the whole odometry stream of a batch of
command streams (planner/traj_server.py) is one vectorized function, on
the commands' device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from svsdf_tpu_torch.planner.traj_server import CommandStream

GRAV = 9.81


class OdomStream(NamedTuple):
    t: torch.Tensor       # (B, T)
    pos: torch.Tensor     # (B, T, 3)
    vel: torch.Tensor     # (B, T, 3)
    quat: torch.Tensor    # (B, T, 4) wxyz body->world


def odom_from_commands(cmds: CommandStream) -> OdomStream:
    """Perfect-tracking odometry (poscmd_2_odom.cpp:22-60): body z axis
    along (acc + g*e3), yaw from the command, quaternion assembled from
    the tilt + yaw decomposition."""
    acc = cmds.acc
    zb = acc + torch.tensor([0.0, 0.0, GRAV], dtype=acc.dtype,
                            device=acc.device)
    zb = zb / torch.linalg.vector_norm(zb, dim=-1, keepdim=True)
    z0, z1, z2 = zb[..., 0], zb[..., 1], zb[..., 2]
    # tilt quaternion (rotation taking e3 to zb), then yaw about body z
    den = torch.sqrt(2.0 * (1.0 + z2))
    tw = 0.5 * den
    tx = -z1 / den
    ty = z0 / den
    ch = torch.cos(0.5 * cmds.yaw)
    sh = torch.sin(0.5 * cmds.yaw)
    quat = torch.stack([tw * ch, tx * ch + ty * sh,
                        ty * ch - tx * sh, tw * sh], dim=-1)
    return OdomStream(cmds.t, cmds.pos, cmds.vel, quat)
