"""Port parity: the depth camera (``sim/depth_camera.py``).

Every case of tests/test_depth_camera.py runs on the port, with the
image also held against JAX's. On seeded 20,000-point clouds at the
reference camera (642 x 482, ``CameraModel()`` defaults), posed by
``sensing_pose_from_odom``, the port's image is held against JAX's:

  * the same pixels are set, but for at most 0.1% of them whose
    projection may sit within an ulp of a pixel edge (the camera-frame
    coordinates are sums of products, which XLA and the port round in
    different orders; 0 measured on the seeds below);
  * each depth within 4 float32 epsilons of the cloud's extent around
    the camera (XLA fuses the products of the depth's sum, the port
    rounds each: 1 ulp on 3-20% of the pixels, 1.9e-6 m measured).

``render_depth_batch`` equals ``render_depth`` pose by pose, to the bit;
duplicate pixels keep the nearest return whichever point comes first.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svsdf_tpu.sim import depth_camera as jdc
from svsdf_tpu_torch.sim.depth_camera import (CameraModel, depth_to_points,
                                              render_depth,
                                              render_depth_batch,
                                              sensing_pose_from_odom)

torch.set_num_threads(1)

CAM = CameraModel(fx=100.0, fy=100.0, cx=32.0, cy=24.0,
                  width=64, height=48)
JCAM = jdc.CameraModel(*CAM)


def _identity_pose():
    return np.eye(3, dtype=np.float32), np.zeros(3, np.float32)


def _both(pts, R, t, cam=CAM):
    """(port image, JAX image) of one pose, as numpy."""
    pts = np.asarray(pts, np.float32)
    img = render_depth(torch.as_tensor(pts), R, t, cam).numpy()
    jimg = np.asarray(jdc.render_depth(jnp.asarray(pts), R, t,
                                       jdc.CameraModel(*cam)))
    return img, jimg


def test_single_point_lands_at_projection():
    R, t = _identity_pose()
    img, jimg = _both([[0.5, 0.25, 5.0]], R, t)
    u = round(100.0 * 0.5 / 5.0 + 32.0)
    v = round(100.0 * 0.25 / 5.0 + 24.0)
    assert img[v, u] == np.float32(5.0)
    assert (img > 0).sum() == 1
    np.testing.assert_array_equal(img, jimg)


def test_zbuffer_keeps_nearest():
    R, t = _identity_pose()
    img, jimg = _both([[0.0, 0.0, 5.0], [0.0, 0.0, 2.0]], R, t)
    assert img[24, 32] == np.float32(2.0)
    np.testing.assert_array_equal(img, jimg)


def test_behind_camera_and_out_of_frame_dropped():
    R, t = _identity_pose()
    img, jimg = _both([[0.0, 0.0, -3.0], [100.0, 0.0, 1.0],
                       [0.0, 0.0, 0.0], [1e9, -1e9, 0.05]], R, t)
    assert (img > 0).sum() == 0
    np.testing.assert_array_equal(img, jimg)


def test_backprojection_roundtrip():
    R, t = _identity_pose()
    rng = np.random.default_rng(0)
    pts = rng.uniform([-0.5, -0.4, 2.0], [0.5, 0.4, 8.0],
                      (200, 3)).astype(np.float32)
    img = render_depth(torch.as_tensor(pts), R, t, CAM)
    back = depth_to_points(img, R, t, CAM, stride=1)
    assert back.shape[0] > 100
    d2 = ((back[:, None] - pts[None]) ** 2).sum(-1)
    assert np.sqrt(d2.min(axis=1)).max() < 0.1
    jback = jdc.depth_to_points(np.asarray(img), R, t, JCAM, stride=1)
    np.testing.assert_array_equal(back, jback)


def test_pose_batched_render():
    R, t = _identity_pose()
    pts = torch.tensor([[0.0, 0.0, 4.0]])
    Rb = np.stack([R] * 3)
    tb = np.stack([t, [0.0, 0.0, 1.0], [0.0, 0.0, 10.0]]).astype(np.float32)
    imgs = render_depth_batch(pts, Rb, tb, CAM).numpy()
    assert imgs.shape == (3, 48, 64)
    assert imgs[0, 24, 32] == np.float32(4.0)
    assert imgs[1, 24, 32] == np.float32(3.0)
    assert (imgs[2] > 0).sum() == 0   # behind the camera
    np.testing.assert_array_equal(imgs, np.asarray(jdc.render_depth_batch(
        jnp.asarray(pts.numpy()), jnp.asarray(Rb), jnp.asarray(tb), JCAM)))


def test_sensing_pose_looks_forward():
    R, t = sensing_pose_from_odom(np.zeros(3), yaw=0.0)
    jR, jt = jdc.sensing_pose_from_odom(np.zeros(3), yaw=0.0)
    np.testing.assert_array_equal(R, jR)
    np.testing.assert_array_equal(t, jt)
    img, jimg = _both([[5.0, 0.0, 0.0]], R, t)
    assert img[24, 32] == np.float32(5.0)
    np.testing.assert_array_equal(img, jimg)


def _cloud(seed, n=20000):
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-15, -15, -2], [15, 15, 4], (n, 3)).astype(np.float32)
    pos = rng.uniform(-1, 1, 3)
    yaw = rng.uniform(-np.pi, np.pi)
    return pts, pos, yaw


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_camera_matches_jax(seed):
    pts, pos, yaw = _cloud(seed)
    cam = CameraModel()
    R, t = sensing_pose_from_odom(pos, yaw, pitch_down=0.2)
    img, jimg = _both(pts, R, t, cam)
    assert img.shape == (482, 642)
    set_, jset = img > 0, jimg > 0
    assert jset.sum() > 2000
    assert (set_ != jset).sum() <= 0.001 * jset.sum()
    both = set_ & jset
    extent = float(np.abs(pts - t).max())
    tol = 4 * np.finfo(np.float32).eps * extent
    assert np.abs(img[both] - jimg[both]).max() <= tol


def test_batch_equals_single_poses_and_duplicates():
    """A pose batch renders each pose's image to the bit; many points on
    one pixel (duplicates and equal depths) keep the nearest."""
    pts, pos, yaw = _cloud(5, 4000)
    dup = np.repeat(np.asarray([[3.0, 0.2, 0.1], [3.0, 0.2, 0.1],
                                [2.0, 0.1, 0.05]], np.float32), 50, 0)
    pts = np.concatenate([pts, dup])[np.random.default_rng(1).permutation(
        len(pts) + len(dup))]
    poses = [sensing_pose_from_odom(pos + [0.3 * k, 0, 0], yaw + 0.4 * k)
             for k in range(4)]
    Rb = np.stack([p[0] for p in poses])
    tb = np.stack([p[1] for p in poses])
    cam = CameraModel()
    imgs = render_depth_batch(torch.as_tensor(pts), Rb, tb, cam)
    for k, (R, t) in enumerate(poses):
        np.testing.assert_array_equal(
            imgs[k].numpy(), render_depth(torch.as_tensor(pts), R, t,
                                          cam).numpy())
    jimgs = np.asarray(jdc.render_depth_batch(
        jnp.asarray(pts), jnp.asarray(Rb), jnp.asarray(tb),
        jdc.CameraModel()))
    assert ((imgs.numpy() > 0) != (jimgs > 0)).sum() <= \
        0.001 * (jimgs > 0).sum()
