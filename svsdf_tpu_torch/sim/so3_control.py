"""Geometric SO(3) position/attitude controller for a fleet
(svsdf_tpu/sim/so3_control.py).

Re-design of so3_control
(`src/uav_simulator/so3_control/include/so3_control/SO3Control.h:6` +
`src/SO3Control.cpp`): the standard Lee geometric controller — PD on
position/velocity error giving a desired force, desired attitude from
the force direction + commanded yaw, then PD on the SO(3) attitude
error (eR = 0.5 vee(Rd^T R - R^T Rd)) for torque. Pure function of a
fleet's states (B, ...), on their device.
"""

from __future__ import annotations

import dataclasses

import torch

from svsdf_tpu_torch.sim.quadrotor import (GRAV, QuadParams, QuadState,
                                           _vec, quat_to_rot)


@dataclasses.dataclass(frozen=True)
class SO3Gains:
    """Gain defaults mirror so3_control's config (gains.launch)."""
    kx: tuple = (5.7, 5.7, 6.2)
    kv: tuple = (3.4, 3.4, 4.0)
    kr: tuple = (1.5, 1.5, 1.0)
    kw: tuple = (0.13, 0.13, 0.1)


def _vee(m):
    return torch.stack([m[..., 2, 1] - m[..., 1, 2],
                        m[..., 0, 2] - m[..., 2, 0],
                        m[..., 1, 0] - m[..., 0, 1]], -1) * 0.5


def control(state: QuadState, pos_des, vel_des, acc_des, yaw_des,
            gains: SO3Gains = SO3Gains(),
            p: QuadParams = QuadParams()):
    """One control tick: desired (pos, vel, acc (B, 3), yaw (B,)) ->
    (thrust f (B,), body torque M (B, 3)) for sim/quadrotor.step_rk4
    (SO3Control.cpp calculateControl)."""
    v = lambda a: _vec(a, state.pos)
    e3 = v([0.0, 0.0, 1.0])
    force = (p.mass * (acc_des + GRAV * e3)
             + p.mass * v(gains.kx) * (pos_des - state.pos)
             + p.mass * v(gains.kv) * (vel_des - state.vel))
    R = quat_to_rot(state.quat)
    f = torch.sum(force * R[..., :, 2], dim=-1)

    # desired frame: b3 along force, b1 from yaw
    cross = lambda a, b: torch.linalg.cross(a, b, dim=-1)
    unit = lambda a: a / torch.clamp(torch.linalg.vector_norm(
        a, dim=-1, keepdim=True), min=1e-6)
    b3 = unit(force)
    c1 = torch.stack([torch.cos(yaw_des), torch.sin(yaw_des),
                      torch.zeros_like(yaw_des)], -1)
    b2 = unit(cross(b3, c1))
    b1 = cross(b2, b3)
    Rd = torch.stack([b1, b2, b3], dim=-1)

    eR = _vee(Rd.transpose(-1, -2) @ R - R.transpose(-1, -2) @ Rd)
    eW = state.omega            # omega_des = 0 (SO3Control.cpp)
    J = v(p.inertia)
    M = (-v(gains.kr) * eR - v(gains.kw) * eW
         + cross(state.omega, J * state.omega))
    return f, M
