"""Port parity: the simulation stack (``sim/``) — kinematic odometry, the
quadrotor's RK4 dynamics, the SO(3) controller and the closed loop.

Every case of tests/test_sim.py runs on the port, and the same inputs
(MINCO trajectories solved by the JAX package from numpy seeds) go
through the JAX functions, all in float64 (JAX under x64). Held:

  * ``odom_from_commands``, ``quat_to_rot``, one ``control`` step and one
    ``step_rk4`` within 1e-12;
  * a ``simulate`` rollout of 200 ticks within 1e-12;
  * ``fly`` on one trajectory and on a fleet of 3 of different lengths in
    lockstep, each lane against JAX's ``fly`` of that trajectory over its
    own ticks: positions within 1e-9 m (XLA compiles the flight's scan
    whole and regroups its arithmetic, so the two may drift apart by
    roundings over hundreds of ticks; 4.4e-16 m measured on the 6 s line).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svsdf_tpu.ops import minco as jminco
from svsdf_tpu.planner import traj_server as jts
from svsdf_tpu.sim import closed_loop as jcl
from svsdf_tpu.sim import kinematic as jkin
from svsdf_tpu.sim import quadrotor as jquad
from svsdf_tpu.sim import so3_control as jso3
from svsdf_tpu_torch.planner import traj_server
from svsdf_tpu_torch.sim import closed_loop, kinematic, quadrotor, so3_control
from svsdf_tpu_torch.utils import trajectory as trj

torch.set_num_threads(1)


def _line_traj(n=3, length=6.0, t_piece=2.0, wiggle=0.0):
    head = np.zeros((3, 3))
    tail = np.zeros((3, 3))
    tail[0] = [length, 0.0, 0.0]
    frac = np.linspace(0, 1, n + 1)[1:-1]
    wps = np.stack([length * frac, wiggle * np.sin(7 * frac), 0 * frac], -1)
    return jminco.solve(jnp.ones(n) * t_piece, jnp.asarray(head),
                        jnp.asarray(tail), jnp.asarray(wps))


def _port(*jts_):
    return trj.Trajectory(
        torch.as_tensor(np.stack([np.asarray(t.coeffs) for t in jts_])),
        torch.as_tensor(np.stack([np.asarray(t.durations) for t in jts_])))


def _state(s):
    return quadrotor.QuadState(*(torch.as_tensor(np.asarray(v))[None]
                                 for v in s))


def _close(a, b, tol, what=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=tol, err_msg=what)


def test_kinematic_odom():
    traj = _line_traj()
    cmds = traj_server.sample_commands(_port(traj))
    odom = kinematic.odom_from_commands(cmds)
    assert odom.pos.shape == cmds.pos.shape
    np.testing.assert_allclose(odom.quat.norm(dim=-1).numpy(), 1.0,
                               atol=1e-5)
    q0 = odom.quat[0, 0].numpy()
    assert abs(q0[1]) < 1e-5 and abs(q0[2]) < 1e-5


@pytest.mark.parametrize("wiggle", [0.0, 1.5])
def test_odom_matches_jax(wiggle):
    traj = _line_traj(wiggle=wiggle)
    jodom = jkin.odom_from_commands(jts.sample_commands(traj))
    odom = kinematic.odom_from_commands(
        traj_server.sample_commands(_port(traj)))
    for f in jkin.OdomStream._fields:
        _close(getattr(odom, f)[0], getattr(jodom, f), 1e-12, f)


def test_quadrotor_hover():
    p = quadrotor.QuadParams()
    s0 = quadrotor.hover_state((0.0, 0.0, 1.0), device="cpu",
                               dtype=torch.float64)
    n = 200
    f = torch.full((1, n), p.mass * quadrotor.GRAV, dtype=torch.float64)
    M = torch.zeros((1, n, 3), dtype=torch.float64)
    s_end, hist = quadrotor.simulate(s0, f, M, 0.01, p)
    np.testing.assert_allclose(s_end.pos[0].numpy(), [0, 0, 1], atol=1e-4)
    np.testing.assert_allclose(s_end.vel[0].numpy(), 0, atol=1e-4)
    assert hist.pos.shape == (1, n, 3)


def test_simulate_matches_jax():
    """A rollout under varying thrust and torques, clamps included."""
    rng = np.random.default_rng(0)
    n = 200
    f = rng.uniform(5.0, 30.0, n)           # past f_max = 24 N at times
    M = rng.normal(0, 0.02, (n, 3))
    M[::37] = 1.5                           # past m_max
    js_end, jhist = jquad.simulate(jquad.hover_state((0.2, -0.1, 1.0)),
                                   jnp.asarray(f), jnp.asarray(M), 0.01)
    s_end, hist = quadrotor.simulate(
        quadrotor.hover_state((0.2, -0.1, 1.0), device="cpu",
                              dtype=torch.float64),
        torch.as_tensor(f)[None], torch.as_tensor(M)[None], 0.01)
    for fld in jquad.QuadState._fields:
        _close(getattr(hist, fld)[0], getattr(jhist, fld), 1e-12, fld)
        _close(getattr(s_end, fld)[0], getattr(js_end, fld), 1e-12, fld)


def test_one_control_and_rk4_step_match_jax():
    rng = np.random.default_rng(1)
    q = rng.normal(size=4)
    s = jquad.QuadState(jnp.asarray(rng.normal(size=3)),
                        jnp.asarray(rng.normal(size=3)),
                        jnp.asarray(q / np.linalg.norm(q)),
                        jnp.asarray(rng.normal(0, 0.3, 3)))
    des = [rng.normal(size=3) for _ in range(3)]
    yaw = 0.7
    jf, jM = jso3.control(s, *map(jnp.asarray, des), jnp.asarray(yaw))
    ts = _state(s)
    f, M = so3_control.control(ts, *(torch.as_tensor(d)[None] for d in des),
                               torch.tensor([yaw], dtype=torch.float64))
    _close(f[0], jf, 1e-12, "f")
    _close(M[0], jM, 1e-12, "M")
    _close(quadrotor.quat_to_rot(ts.quat)[0], jquad.quat_to_rot(s.quat),
           1e-15, "R")
    js2 = jquad.step_rk4(s, jf, jM, 0.002, jquad.QuadParams())
    s2 = quadrotor.step_rk4(ts, f, M, 0.002, quadrotor.QuadParams())
    for fld in jquad.QuadState._fields:
        _close(getattr(s2, fld)[0], getattr(js2, fld), 1e-12, fld)


def test_so3_controller_stabilizes():
    """From an offset + tilt, the controller brings the quad to the
    setpoint."""
    p = quadrotor.QuadParams()
    t = lambda v: torch.tensor([v], dtype=torch.float64)
    q = t([0.9990, 0.0314, 0.0314, 0.0])
    s = quadrotor.QuadState(t([0.5, -0.3, 0.8]), t([0.0] * 3),
                            q / q.norm(), t([0.0] * 3))
    tgt = t([0.0, 0.0, 1.0])
    zero = torch.zeros_like(tgt)
    for _ in range(600):
        f, M = so3_control.control(s, tgt, zero, zero, t(0.0), p=p)
        s = quadrotor.step_rk4(s, f, M, 0.01, p)
    assert float((s.pos - tgt).norm()) < 0.05
    assert float(s.vel.norm()) < 0.05


def test_closed_loop_tracks_plan_and_matches_jax():
    traj = _line_traj(length=6.0, t_piece=2.5)
    log = closed_loop.fly(_port(traj))
    err = log.track_err[0].numpy()
    assert err.max() < 0.15, err.max()
    assert err[-1] < 0.05
    jlog = jcl.fly(traj)
    for f in jcl.FlightLog._fields:
        _close(getattr(log, f)[0], getattr(jlog, f), 1e-9, f)


def test_fleet_of_three_matches_jax_lane_by_lane():
    """Three trajectories of different lengths fly in lockstep; each lane
    is JAX's flight of that trajectory over its own ticks."""
    lanes = [_line_traj(length=4.0, t_piece=1.2, wiggle=1.0),
             _line_traj(length=3.0, t_piece=0.8),
             _line_traj(length=5.0, t_piece=1.5, wiggle=-0.8)]
    port = _port(*lanes)
    log = closed_loop.fly(port)
    ticks = traj_server.n_ticks(port, traj_server.TrajServerConfig())
    assert log.pos.shape[1] == int(ticks.max())
    for b, jt in enumerate(lanes):
        jlog = jcl.fly(jt)
        n_b = int(ticks[b])
        assert n_b == jlog.pos.shape[0]
        for f in jcl.FlightLog._fields:
            _close(getattr(log, f)[b, :n_b], getattr(jlog, f), 1e-9, f)
