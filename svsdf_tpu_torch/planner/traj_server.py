"""Trajectory server: optimized spline -> rate-limited position commands
(svsdf_tpu/planner/traj_server.py).

Re-design of the traj_server node
(`src/plan_manager/src/traj_server.cpp:38-336`): samples the quintic
trajectory at a fixed command rate into (pos, vel, acc, jerk, yaw,
yaw_rate) commands with the reference's look-ahead yaw plus
acceleration/rate limiting (calculate_yaw, traj_server.cpp:77-136) and
the heartbeat watchdog semantics (hold position after `watchdog_s` of
planner silence, traj_server.cpp:178-184).

A batch of B trajectories is sampled in lockstep: the tick count comes
from the longest lane and each lane's times clamp at its own end, so
lane b's first ``int(total_b / dt) + 1`` ticks are the stream of that
trajectory alone. Positions and derivatives for every tick are one
batched evaluation; the yaw rate limiter is a sequential recurrence, a
loop over ticks vectorized over B (``lax.scan`` in the JAX package).
The samples come from ``eval_at_gather``, whose sum runs in the order of
the JAX package's ``eval_at`` on the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from svsdf_tpu_torch.utils import trajectory as trj

PI = math.pi


@dataclasses.dataclass(frozen=True)
class TrajServerConfig:
    rate_hz: float = 100.0            # cmdCallback timer rate
    time_forward: float = 1.0         # yaw look-ahead horizon
    yaw_dot_max: float = 2.0 * PI     # YAW_DOT_MAX_PER_SEC
    yaw_ddot_max: float = 5.0 * PI    # YAW_DOT_DOT_MAX_PER_SEC
    watchdog_s: float = 0.5           # heartbeat hold threshold


class CommandStream(NamedTuple):
    t: torch.Tensor          # (B, T)
    pos: torch.Tensor        # (B, T, 3)
    vel: torch.Tensor        # (B, T, 3)
    acc: torch.Tensor        # (B, T, 3)
    jerk: torch.Tensor       # (B, T, 3)
    yaw: torch.Tensor        # (B, T)
    yaw_rate: torch.Tensor   # (B, T)


def _wrap(a):
    """(a + pi) mod 2 pi - pi with the JAX package's ``%``: a truncated
    remainder whose sign is fixed up to the divisor's."""
    two_pi = 2.0 * PI
    r = torch.fmod(a + PI, two_pi)
    r = torch.where(r < 0, r + two_pi, r)
    return r - PI


def total_duration(traj: trj.Trajectory) -> torch.Tensor:
    """(B,) durations summed piece after piece: the order of XLA's host
    sum of up to 32 pieces (past 32 it regroups, an ulp or so away).

    ``Trajectory.total_duration`` keeps ``torch.sum``, whose vectorized
    order on the host differs from this one in the last bit for some
    rows, so the server cannot use it and stay bit for bit with JAX. The
    port's host tests also pass with the property replaced by this loop,
    but the property is read in every SVSDF query of the solves
    (``ops/svsdf.py``: the pose tables, the t* search, the GSIP
    velocity), which are launch-bound on the card: there this loop is
    N - 1 launches to the sum's one, and the sum's order is the one the
    card's recorded plans (PERF.md) were computed in."""
    total = traj.durations[:, 0]
    for i in range(1, traj.num_pieces):
        total = total + traj.durations[:, i]
    return total


def n_ticks(traj: trj.Trajectory, cfg: TrajServerConfig) -> torch.Tensor:
    """(B,) tick count of each lane on the host: int(total / dt) + 1, the
    division in the trajectory's dtype as the JAX package divides (on the
    host, where a division by a scalar is not a product with its
    reciprocal as on the card)."""
    total = total_duration(traj).detach().cpu()
    return (total / (1.0 / cfg.rate_hz)).to(torch.int64) + 1


def sample_commands(traj: trj.Trajectory,
                    cfg: TrajServerConfig = TrajServerConfig()
                    ) -> CommandStream:
    """Sample the command stream of B trajectories (B, N, 6, D), D >= 3,
    over the longest lane's duration, on the trajectory's device."""
    total = total_duration(traj)                               # (B,)
    dt = 1.0 / cfg.rate_hz
    n_steps = int(n_ticks(traj, cfg).max())
    ts = torch.arange(n_steps, device=total.device,
                      dtype=total.dtype) * dt
    ts = torch.minimum(ts[None], total[:, None])               # (B, T)
    pos = trj.eval_at_gather(traj, ts, 0)
    vel = trj.eval_at_gather(traj, ts, 1)
    acc = trj.eval_at_gather(traj, ts, 2)
    jerk = trj.eval_at_gather(traj, ts, 3)

    # look-ahead yaw target (traj_server.cpp:84-89)
    ahead = torch.minimum(ts + cfg.time_forward, total[:, None])
    dir_ = trj.eval_at_gather(traj, ahead, 0)[..., :2] - pos[..., :2]
    ok = torch.linalg.vector_norm(dir_, dim=-1) > 0.1
    yaw_tgt = torch.atan2(dir_[..., 1], dir_[..., 0])

    c = lambda v: torch.tensor(v, dtype=pos.dtype, device=pos.device)
    ydm_p, ydm_n = c(cfg.yaw_dot_max), c(-cfg.yaw_dot_max)
    yddm_p, yddm_n = c(cfg.yaw_ddot_max), c(-cfg.yaw_ddot_max)
    half_dt2, two_dt, inv_dt = 0.5 * dt * dt, dt + dt, 1.0 / dt
    dt_t = c(dt)
    last_yaw = yaw_tgt[:, 0] * 0.0
    last_yd = torch.zeros_like(last_yaw)
    yaws, rates = [], []
    for k in range(n_steps):
        tgt = torch.where(ok[:, k], yaw_tgt[:, k], last_yaw)
        d = _wrap(tgt - last_yaw)
        pos_d = d >= 0
        ydm = torch.where(pos_d, ydm_p, ydm_n)
        yddm = torch.where(pos_d, yddm_p, yddm_n)
        # accel-limited max change this tick (traj_server.cpp:105-116):
        # last_yd dt + yddm dt^2 / 2, or ((dt - t1) + dt)(ydm - last_yd) / 2
        # with t1 = (ydm - last_yd) / yddm, and the rate d / dt, in the
        # form XLA compiles the JAX package's step into on the host:
        # constants gathered, divisions by constants as products, and a
        # product added to a sum fused (addcmul)
        can_accel = torch.abs(torch.addcmul(last_yd, yddm, dt_t)) \
            <= torch.abs(ydm)
        d_max_a = torch.addcmul(yddm * half_dt2, last_yd, dt_t)
        t1 = (ydm - last_yd) / yddm
        d_max_b = (two_dt - t1) * (ydm - last_yd) * 0.5
        d_max = torch.where(can_accel, d_max_a, d_max_b)
        d = torch.where(torch.abs(d) > torch.abs(d_max), d_max, d)
        last_yd = d * inv_dt
        last_yaw = _wrap(last_yaw + d)
        yaws.append(last_yaw)
        rates.append(last_yd)
    return CommandStream(ts, pos, vel, acc, jerk, torch.stack(yaws, 1),
                         torch.stack(rates, 1))


def hold_command(last_pos):
    """Watchdog hold-position command (traj_server.cpp:178-184)."""
    z = torch.zeros_like(last_pos)
    return last_pos, z, z
