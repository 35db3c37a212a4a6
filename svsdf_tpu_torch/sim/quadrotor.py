"""Rigid-body quadrotor dynamics, RK4-integrated, for a fleet of drones
(svsdf_tpu/sim/quadrotor.py).

Re-design of so3_quadrotor_simulator
(`src/uav_simulator/so3_quadrotor_simulator/include/quadrotor_simulator/
Quadrotor.h:10` + `src/quadrotor_simulator_so3.cpp`): the reference
integrates a boost.odeint ODE per 100 Hz ROS tick in its own process;
here a rollout is a Python loop of fixed RK4 steps over a fleet of B
drones in lockstep, on the state's device (``lax.scan`` and ``vmap`` in
the JAX package).

State: (pos (B, 3), vel (B, 3), quat (B, 4) wxyz body->world, omega
(B, 3) body rates). Inputs: collective thrust f (B,) (N) along body z
and body torque M (B, 3) — the interface so3_control produces.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from svsdf_tpu_torch import resolve_device

GRAV = 9.81


@dataclasses.dataclass(frozen=True)
class QuadParams:
    """Defaults mirror the reference's simulator config
    (so3_quadrotor_simulator/config + Quadrotor.h defaults)."""
    mass: float = 0.98
    inertia: tuple = (2.64e-3, 2.64e-3, 4.96e-3)   # diagonal J
    drag: float = 0.10                              # linear drag coeff
    f_max: float = 4.0 * 6.0                        # 4 motors x 6 N
    m_max: float = 1.0                              # torque clamp


class QuadState(NamedTuple):
    pos: torch.Tensor      # (B, 3)
    vel: torch.Tensor      # (B, 3)
    quat: torch.Tensor     # (B, 4)
    omega: torch.Tensor    # (B, 3)


def hover_state(pos=(0.0, 0.0, 0.0), device=None,
                dtype=torch.float32) -> QuadState:
    """At rest, level, at pos (B, 3) or (3,) (a fleet of one). A tensor
    keeps its device and floating dtype; host data goes to ``device``
    (None: CUDA) in ``dtype``."""
    if isinstance(pos, torch.Tensor):
        pos = pos * 1.0
    else:
        pos = torch.as_tensor(pos, dtype=dtype,
                              device=resolve_device(device))
    pos = pos.reshape(-1, 3)
    z = torch.zeros_like(pos)
    quat = torch.zeros(pos.shape[0], 4, dtype=pos.dtype, device=pos.device)
    quat[:, 0] = 1.0
    return QuadState(pos, z, quat, z.clone())


@functools.lru_cache(maxsize=None)
def _const(values: tuple, dtype, device) -> torch.Tensor:
    """A constant vector (values or indices), made once per dtype and
    device (on the card a fresh one would cost a host-to-device copy at
    every derivative)."""
    return torch.tensor(values, dtype=dtype, device=device)


def _vec(v, like):
    return _const(tuple(v), like.dtype, like.device)


def quat_to_rot(q):
    """(..., 4) wxyz -> (..., 3, 3) body->world."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


#: the products the derivative needs, gathered from the packed state:
#: q q products (xz, yz, xx, wy, wx, yy) and q omega products (12, three
#: per quaternion rate, in the order of the JAX package's expressions)
_QQ = ((1, 2, 1, 0, 0, 2), (3, 3, 1, 2, 1, 2))
_QO = ((1, 0, 0, 0, 2, 2, 1, 1, 3, 3, 3, 2),
       (0, 0, 1, 2, 1, 2, 2, 1, 2, 1, 0, 0))
_QO_SIGN = (-1.0, 1.0, 1.0, 1.0, -1.0, 1.0, -1.0, 1.0, -1.0, -1.0, 1.0, -1.0)


def _deriv(X, f, M, p: QuadParams):
    """d/dt of the packed state X (B, 13) = (pos, vel, quat, omega). Each
    component is the JAX package's expression, operation for operation:
    the thrust direction is quat_to_rot's third column, 2 (xz + wy),
    2 (yz - wx), 1 - 2 (xx + yy), and the quaternion rate
    0.5 (-x ox - y oy - z oz, w ox + y oz - z oy, ...); the products are
    gathered so that each step is one launch for all of them."""
    idx = lambda v: _const(v, torch.long, X.device)
    vel, q, om = X[:, 3:6], X[:, 6:10], X[:, 10:13]
    qq = (torch.index_select(q, 1, idx(_QQ[0]))
          * torch.index_select(q, 1, idx(_QQ[1])))
    s = qq[:, :3] + _vec((1.0, -1.0, 1.0), X) * qq[:, 3:]
    body_z = _vec((2.0, 2.0, -2.0), X) * s + _vec((0.0, 0.0, 1.0), X)
    thrust_w = body_z * f[:, None] / p.mass
    dvel = thrust_w - _vec((0.0, 0.0, GRAV), X) - p.drag / p.mass * vel
    qo = (torch.index_select(q, 1, idx(_QO[0]))
          * torch.index_select(om, 1, idx(_QO[1]))) \
        * _vec(_QO_SIGN, X)
    dquat = 0.5 * ((qo[:, 0:4] + qo[:, 4:8]) + qo[:, 8:12])
    J = _vec(p.inertia, X)
    domega = (M - torch.linalg.cross(om, J * om, dim=-1)) / J
    return torch.cat([vel, dvel, dquat, domega], 1)


def step_rk4(s: QuadState, f, M, dt, p: QuadParams) -> QuadState:
    """One RK4 step of dt for the fleet: f (B,), M (B, 3). The four
    components advance as one packed (B, 13) state, elementwise as the
    JAX package advances each."""
    f = torch.clamp(f, 0.0, p.f_max)
    M = torch.clamp(M, -p.m_max, p.m_max)
    X = torch.cat([s.pos, s.vel, s.quat, s.omega], 1)
    k1 = _deriv(X, f, M, p)
    k2 = _deriv(X + dt / 2 * k1, f, M, p)
    k3 = _deriv(X + dt / 2 * k2, f, M, p)
    k4 = _deriv(X + dt * k3, f, M, p)
    Y = X + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    q = Y[:, 6:10]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return QuadState(Y[:, 0:3], Y[:, 3:6], q, Y[:, 10:13])


def simulate(s0: QuadState, f_seq, M_seq, dt,
             p: QuadParams = QuadParams()):
    """Roll out T control ticks: f_seq (B, T), M_seq (B, T, 3). Returns
    the final state and the QuadState history stacked over T (B, T, ...)."""
    s, hist = s0, []
    for k in range(f_seq.shape[1]):
        s = step_rk4(s, f_seq[:, k], M_seq[:, k], dt, p)
        hist.append(s)
    return s, QuadState(*(torch.stack(v, 1) for v in zip(*hist)))
