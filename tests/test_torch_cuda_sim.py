"""The deployment loop's modules on the card against the host: the depth
camera, the closed-loop flight of a fleet, the command stream and the
profiling stage's wait for the device.

Tests marked ``cuda`` need an NVIDIA card and skip without one. This
file imports neither JAX nor the JAX package, so on a card whose
installation has no JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_sim.py

Held: the depth images of a cloud full of duplicate pixels and equal
depths to the bit (each camera-frame coordinate is separately rounded
products and sums, and the scatter-min does not depend on the order of
the card's atomics); a fleet of 8 flights in float32 on the card within
1e-4 m of the host's float64 flights of the same trajectories; the
float32 command stream within 1e-5 of max(1, the lane's largest
|value| of the channel) of the host's float64 one (a float32 polynomial
rounds at the scale of its terms, not of its value), yaw (wrapped) and
yaw_rate * dt within 1e-4 rad (the yaw
target is the angle of a look-ahead vector as short as 0.1 m between
two float32 positions); and
``stage(...).block(out)`` returning only once the card has finished.
"""

import numpy as np
import pytest
import torch

from svsdf_tpu_torch.ops import minco
from svsdf_tpu_torch.planner import traj_server
from svsdf_tpu_torch.sim import closed_loop
from svsdf_tpu_torch.sim.depth_camera import (CameraModel, render_depth,
                                              render_depth_batch,
                                              sensing_pose_from_odom)
from svsdf_tpu_torch.utils import profiling
from svsdf_tpu_torch.utils import trajectory as trj

torch.set_num_threads(1)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the deployment loop's card path")


def _fleet(b, seed=0):
    """b MINCO trajectories of 4 pieces and different lengths on the host,
    their coefficients float32 values held in float64 (so the card's
    float32 copy is the same trajectory); yaw in the z slot."""
    rng = np.random.default_rng(seed)
    n = 4
    length = rng.uniform(3.0, 8.0, b)
    head = np.zeros((b, 3, 3))
    tail = np.zeros((b, 3, 3))
    tail[:, 0, 0] = length
    tail[:, 0, 1] = rng.uniform(-2, 2, b)
    frac = np.linspace(0, 1, n + 1)[1:-1]
    wps = np.stack([length[:, None] * frac,
                    rng.normal(0, 1.0, (b, n - 1)),
                    rng.normal(0, 0.5, (b, n - 1))], -1)
    times = rng.uniform(0.6, 1.6, (b, n))
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    traj = minco.solve(t(times), t(head), t(tail), t(wps))
    return _to(_to(traj, torch.float32, "cpu"), torch.float64, "cpu")


def _to(traj, dtype, device):
    return trj.Trajectory(traj.coeffs.to(device, dtype),
                          traj.durations.to(device, dtype))


@pytest.mark.cuda
def test_depth_on_card_equals_host_with_duplicates_and_ties():
    _card()
    rng = np.random.default_rng(0)
    cloud = rng.uniform([-12, -12, -2], [12, 12, 4], (30000, 3))
    # many points on few pixels: exact duplicates, equal depths at
    # neighbouring offsets, and a nearer point behind each group
    groups = rng.uniform([2, -3, -1], [9, 3, 1], (40, 3))
    dup = np.repeat(groups, 64, 0)
    ties = groups + np.asarray([0.0, 1e-4, -1e-4])
    near = groups * np.asarray([0.5, 0.5, 0.5])
    pts = np.concatenate([cloud, dup, ties, ties, near]).astype(np.float32)
    pts = pts[rng.permutation(len(pts))]
    poses = [sensing_pose_from_odom(rng.uniform(-1, 1, 3),
                                    rng.uniform(-np.pi, np.pi), 0.1 * k)
             for k in range(6)]
    poses.append(sensing_pose_from_odom(np.zeros(3), 0.0))
    Rb = np.stack([p[0] for p in poses])
    tb = np.stack([p[1] for p in poses])
    cam = CameraModel()
    host = render_depth_batch(torch.as_tensor(pts), Rb, tb, cam)
    card = render_depth_batch(torch.as_tensor(pts, device="cuda"), Rb, tb,
                              cam)
    assert card.is_cuda and (host > 0).sum() > 10000
    assert torch.equal(card.cpu(), host)
    one = render_depth(torch.as_tensor(pts, device="cuda"), Rb[-1], tb[-1],
                       cam)
    assert torch.equal(one, card[-1])


@pytest.mark.cuda
def test_fleet_of_8_flies_on_card_as_on_host():
    _card()
    fleet = _fleet(8)
    host = closed_loop.fly(fleet)
    card = closed_loop.fly(_to(fleet, torch.float32, "cuda"))
    assert card.pos.is_cuda and card.pos.shape == host.pos.shape
    err = (card.pos.double().cpu() - host.pos).abs().max()
    assert float(err) <= 1e-4, float(err)
    assert torch.isfinite(card.track_err).all()
    assert float(card.track_err.max()) < 0.5


@pytest.mark.cuda
def test_command_stream_on_card_as_on_host():
    _card()
    fleet = _fleet(8, seed=1)
    host = traj_server.sample_commands(fleet)
    card = traj_server.sample_commands(_to(fleet, torch.float32, "cuda"))
    for f in ("t", "pos", "vel", "acc", "jerk"):
        a, b = getattr(card, f).double().cpu(), getattr(host, f)
        scale = b.abs().amax(dim=1, keepdim=True).clamp_min(1.0)
        assert float(((a - b).abs() / scale).max()) <= 1e-5, f
    dyaw = traj_server._wrap(card.yaw.double().cpu() - host.yaw)
    assert float(dyaw.abs().max()) <= 1e-4
    step = (card.yaw_rate.double().cpu() - host.yaw_rate) * 0.01
    assert float(step.abs().max()) <= 1e-4


@pytest.mark.cuda
def test_stage_block_waits_for_the_card():
    _card()
    prof = profiling.Profile()
    a = torch.randn(4096, 4096, device="cuda")
    torch.cuda.synchronize()
    with profiling.stage("matmul", profile=prof) as s:
        out = {"y": [a @ a @ a @ a]}
        s.block(out)
        assert torch.cuda.current_stream().query()
    assert prof.counts["matmul"] == 1 and prof.totals["matmul"] > 0
