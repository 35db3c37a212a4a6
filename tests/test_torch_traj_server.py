"""Port parity: the trajectory server (``planner/traj_server.py``).

The same MINCO trajectories (numpy seeds, solved by the JAX package) go
through JAX's ``sample_commands`` and the port's. Held:

  * float64 (JAX under x64), up to 16 pieces: every field bit for bit,
    ``yaw`` and ``yaw_rate`` included (the port samples with
    ``eval_at_gather``, whose sum runs in XLA's order, and its yaw
    recurrence is written in the form XLA compiles JAX's step into);
    past 16 pieces XLA's cumulative sum of the durations regroups, the
    piece start times move by ulps, and the fields stay within 1e-11 of
    max(1, |value|), yaw and yaw_rate * dt within 1e-8 rad;
  * float32 (JAX with x64 off): the tick times bit for bit, positions
    and derivatives within 64 float32 epsilons of max(1, the channel's
    largest |value|) (XLA's float32 dot fuses its products, the port's
    sum does not; 31 measured), yaw within 1e-4 rad (a look-ahead vector
    as short as 0.1 m turns those ulps into ~1.5e-5 rad) and
    yaw_rate * dt likewise;
  * a batch of lanes of different durations: the tick count is the
    longest lane's, and lane b's first ticks are JAX's stream of that
    trajectory alone, bit for bit in float64;
  * the duration sum: XLA's host sum of up to 32 pieces runs in order,
    which the port's ``total_duration`` follows to the bit (4 ulps past
    32), and the tick counts are JAX's;
  * test_planner_e2e.py::test_traj_server_commands on the port's own
    ``Planner`` plan of that corridor, and its stream equal to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svsdf_tpu.ops import minco as jminco
from svsdf_tpu.planner import traj_server as jts
from svsdf_tpu.utils import trajectory as jtrj
from svsdf_tpu_torch.planner import traj_server as ts
from svsdf_tpu_torch.utils import trajectory as trj

torch.set_num_threads(1)

FIELDS = jts.CommandStream._fields


def _jax_traj(n, seed, dtype=jnp.float64, length=8.0):
    """A wiggly MINCO trajectory of n pieces (yaw in the z slot)."""
    rng = np.random.default_rng(seed)
    head = np.zeros((3, 3))
    tail = np.zeros((3, 3))
    tail[0] = [length, 3.0, 2.5]
    wps = np.stack([np.linspace(1.0, length - 1.0, n - 1),
                    rng.normal(0, 1.5, n - 1), rng.normal(0, 1, n - 1)], -1)
    times = rng.uniform(0.5, 1.5, n)
    a = lambda v: jnp.asarray(v, dtype)
    return jminco.solve(a(times), a(head), a(tail), a(wps))


def _port(jt, lanes=None):
    """The JAX trajectory (or several of one piece count) as a port batch."""
    jt = [jt] if lanes is None else lanes
    c = np.stack([np.asarray(t.coeffs) for t in jt])
    d = np.stack([np.asarray(t.durations) for t in jt])
    return trj.Trajectory(torch.as_tensor(c), torch.as_tensor(d))


def _stream(js):
    return {f: np.asarray(getattr(js, f)) for f in FIELDS}


@pytest.mark.parametrize("n,seed", [(3, 0), (5, 1), (5, 2), (8, 3),
                                    (12, 4), (16, 5)])
def test_float64_stream_matches_jax(n, seed):
    jt = _jax_traj(n, seed)
    want = _stream(jts.sample_commands(jt))
    got = ts.sample_commands(_port(jt))
    for f in FIELDS:
        g = getattr(got, f)[0].numpy()
        assert g.dtype == np.float64
        np.testing.assert_array_equal(g, want[f], err_msg=f)


@pytest.mark.parametrize("n,seed", [(24, 6), (32, 5)])
def test_float64_stream_past_16_pieces(n, seed):
    jt = _jax_traj(n, seed)
    want = _stream(jts.sample_commands(jt))
    got = ts.sample_commands(_port(jt))
    np.testing.assert_array_equal(got.t[0].numpy(), want["t"])
    for f in ("pos", "vel", "acc", "jerk"):
        g = getattr(got, f)[0].numpy()
        err = np.abs(g - want[f]) / np.maximum(1.0, np.abs(want[f]))
        assert err.max() <= 1e-11, f
    dyaw = np.asarray(jts._wrap(got.yaw[0].numpy() - want["yaw"]))
    assert np.abs(dyaw).max() <= 1e-8
    step = (got.yaw_rate[0].numpy() - want["yaw_rate"]) * 0.01
    assert np.abs(step).max() <= 1e-8


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_float32_stream_matches_jax(seed):
    with jax.enable_x64(False):
        jt = _jax_traj(5, seed, jnp.float32)
        want = _stream(jts.sample_commands(jt))
        c, d = np.asarray(jt.coeffs), np.asarray(jt.durations)
    got = ts.sample_commands(trj.Trajectory(torch.as_tensor(c)[None],
                                            torch.as_tensor(d)[None]))
    np.testing.assert_array_equal(got.t[0].numpy(), want["t"])
    for f in ("pos", "vel", "acc", "jerk"):
        g = getattr(got, f)[0].numpy()
        assert g.dtype == np.float32
        scale = np.maximum(1.0, np.abs(want[f]).max(0))
        eps = np.finfo(np.float32).eps
        assert (np.abs(g - want[f]) <= 64 * eps * scale).all(), f
    dyaw = np.asarray(jts._wrap(got.yaw[0].numpy() - want["yaw"]))
    assert np.abs(dyaw).max() <= 1e-4
    step = (got.yaw_rate[0].numpy() - want["yaw_rate"]) * 0.01
    assert np.abs(step).max() <= 1e-4


def test_wrap_matches_jax_to_the_bit():
    rng = np.random.default_rng(0)
    a = np.concatenate([rng.uniform(-30, 30, 4000), np.pi * np.arange(-9, 10),
                        [0.0, -0.0, np.pi, -np.pi, 2 * np.pi - 1e-15]])
    np.testing.assert_array_equal(ts._wrap(torch.as_tensor(a)).numpy(),
                                  np.asarray(jts._wrap(jnp.asarray(a))))


@pytest.mark.parametrize("n", [2, 5, 16, 32, 48])
def test_total_duration_and_ticks(n):
    """The port's sum equals XLA's to the bit up to 32 pieces (in order)
    and within 4 ulps past that; the tick count equals JAX's."""
    rng = np.random.default_rng(n)
    for dt, jdt in ((torch.float64, jnp.float64), (torch.float32, None)):
        d = rng.uniform(0.3, 1.7, (40, n))
        if jdt is None:
            with jax.enable_x64(False):
                want = np.stack([np.asarray(jnp.sum(jnp.asarray(
                    r, jnp.float32))) for r in d])
        else:
            want = np.stack([np.asarray(jnp.sum(jnp.asarray(r, jdt)))
                             for r in d])
        tr = trj.Trajectory(torch.zeros(40, n, 6, 3, dtype=dt),
                            torch.as_tensor(d, dtype=dt))
        got = ts.total_duration(tr).numpy()
        if n <= 32:
            np.testing.assert_array_equal(got, want)
        else:
            assert (np.abs(got - want) <= 4 * np.spacing(want)).all()
        ticks = ts.n_ticks(tr, ts.TrajServerConfig()).numpy()
        np.testing.assert_array_equal(
            ticks, [int(w / 0.01) + 1 for w in want.astype(
                np.float32 if jdt is None else np.float64)])


def test_batched_lanes_of_different_durations():
    """Lanes of one piece count and different lengths, in lockstep: each
    lane's first ticks are JAX's stream of that trajectory alone."""
    lanes = [_jax_traj(4, s, length=ln) for s, ln in
             ((0, 8.0), (1, 3.0), (2, 12.0))]
    got = ts.sample_commands(_port(None, lanes))
    n_b = ts.n_ticks(_port(None, lanes), ts.TrajServerConfig()).tolist()
    assert got.t.shape[1] == max(n_b)
    for b, jt in enumerate(lanes):
        want = _stream(jts.sample_commands(jt))
        assert n_b[b] == len(want["t"])
        for f in FIELDS:
            np.testing.assert_array_equal(
                getattr(got, f)[b, :n_b[b]].numpy(), want[f], err_msg=f)
        # past its end a lane holds its end point
        total = float(ts.total_duration(_port(jt))[0])
        assert (got.t[b, n_b[b]:] == total).all()


def test_hold_command():
    last = torch.tensor([[1.0, 2.0, 0.5]])
    p, v, a = ts.hold_command(last)
    assert torch.equal(p, last) and not v.any() and not a.any()
    jp, jv, ja = jts.hold_command(jnp.asarray(last.numpy()[0]))
    np.testing.assert_array_equal(v[0].numpy(), np.asarray(jv))


def test_traj_server_commands_on_the_ports_plan():
    """test_planner_e2e.py::test_traj_server_commands with the port's
    Planner on the same corridor, then JAX's stream of the same plan."""
    from svsdf_tpu_torch.planner.pipeline import Planner
    from svsdf_tpu_torch.utils.config import PlannerConfig
    pts = [(x + 0.5, 7.2, z + 0.5) for x in range(24) for z in range(2)
           if not 10 <= x <= 13]
    pts += [(0.05, 0.05, 0.05), (23.9, 15.9, 1.9)]
    cfg = PlannerConfig(inputdata="shapes/Circle.obj", kernel_size=7,
                        kernel_yaw_num=4, occupancy_resolution=1.0,
                        safety_hor=0.4, inittime=1.5)
    pl = Planner(cfg, np.asarray(pts), use_transition_check=False,
                 device="cpu")
    res = pl.plan(np.array([3.5, 3.5, 0.0]), np.array([20.5, 12.5, 0.0]),
                  mid_iters=30, back_iters=40)
    stream = ts.sample_commands(res.traj)
    assert stream.pos.shape[1] == stream.yaw.shape[1]
    total = float(res.traj.total_duration[0])
    assert abs(stream.pos.shape[1] - total * 100.0) < 3
    assert float(stream.yaw_rate.abs().max()) <= 2 * np.pi + 1e-6
    d = np.linalg.norm(np.diff(stream.pos[0, :, :2].numpy(), axis=0),
                       axis=1)
    assert d.max() < 0.5
    tr64 = trj.Trajectory(res.traj.coeffs.double(), res.traj.durations.double())
    want = _stream(jts.sample_commands(jtrj.Trajectory(
        jnp.asarray(tr64.coeffs[0].numpy()),
        jnp.asarray(tr64.durations[0].numpy()))))
    got = ts.sample_commands(tr64)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f)[0].numpy(), want[f],
                                      err_msg=f)
