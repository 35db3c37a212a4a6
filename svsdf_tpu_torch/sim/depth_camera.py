"""Depth-camera rendering from a global point cloud
(svsdf_tpu/sim/depth_camera.py): the reference's only CUDA component
(`src/uav_simulator/local_sensing/src/depth_render.cu`,
`pcl_render_node.cpp:37-51,168-298`).

The reference's kernel assigns one thread per cloud point, projects it
through the pinhole model and atomically min-updates a z-buffer. Here a
pose batch is projected whole and ``scatter_reduce_(..., "amin")`` takes
each pixel's nearest return into an ``inf`` buffer: a minimum does not
depend on the order the card's atomics apply, so the image is exact.

The camera-frame coordinates are three products and two sums in a fixed
order, each its own operation (not a matrix product, whose summation
order differs between devices), so the card renders the host's image to
the bit.

Also provides `depth_to_points` (the depth -> local point cloud
back-projection of `pcl_render_node.cpp:234-261`) and
`sensing_pose_from_odom`, both host numpy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class CameraModel(NamedTuple):
    """Pinhole intrinsics (`pcl_render_node.cpp:48` fx,fy,cx,cy +
    width/height)."""
    fx: float = 387.0
    fy: float = 387.0
    cx: float = 321.0
    cy: float = 243.0
    width: int = 642
    height: int = 482
    max_depth: float = 500.0   # reference clamps >=500 m to empty
    min_depth: float = 0.02


def render_depth_batch(points, R_wc_b, t_wc_b, cam: CameraModel):
    """Render B depth images of one world cloud, on the cloud's device.

    points: (P, 3) tensor; R_wc_b, t_wc_b: (B, 3, 3) and (B, 3)
    camera-to-world rotations and translations (arrays or tensors).
    Returns (B, H, W) depth in meters in the cloud's dtype, 0 = no return
    (the reference encodes empties as 0, `pcl_render_node.cpp:292-294`).
    """
    as_t = lambda a: torch.as_tensor(a, dtype=points.dtype,
                                     device=points.device)
    R, t = as_t(R_wc_b), as_t(t_wc_b)
    d = points[None] - t[:, None, :]                       # (B, P, 3)
    # world -> camera frame: pts_c[..., j] = sum_i d[..., i] R[i, j]
    pts_c = (d[..., 0, None] * R[:, None, 0] + d[..., 1, None] * R[:, None, 1]
             ) + d[..., 2, None] * R[:, None, 2]
    x, y, z = pts_c[..., 0], pts_c[..., 1], pts_c[..., 2]
    valid = (z > cam.min_depth) & (z < cam.max_depth)
    u = torch.round(cam.fx * x / z + cam.cx)
    v = torch.round(cam.fy * y / z + cam.cy)
    # out-of-frame in float, before the integer cast (an out-of-range
    # float -> int cast is undefined)
    valid &= (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
    zero = torch.zeros_like(u)
    pix = (torch.where(valid, v, zero).to(torch.int64) * cam.width
           + torch.where(valid, u, zero).to(torch.int64))
    hw = cam.height * cam.width
    nb = R.shape[0]
    flat = pix + hw * torch.arange(nb, device=points.device)[:, None]
    z_in = torch.where(valid, z, torch.full_like(z, float("inf")))
    buf = torch.full((nb * hw,), float("inf"), dtype=points.dtype,
                     device=points.device)
    buf.scatter_reduce_(0, flat.reshape(-1), z_in.reshape(-1), "amin",
                        include_self=True)
    img = buf.reshape(nb, cam.height, cam.width)
    return torch.where(torch.isfinite(img), img, torch.zeros_like(img))


def render_depth(points, R_wc, t_wc, cam: CameraModel):
    """Render one depth image (H, W): R_wc (3, 3), t_wc (3,)."""
    as_t = lambda a: torch.as_tensor(a, dtype=points.dtype,
                                     device=points.device)
    return render_depth_batch(points, as_t(R_wc)[None], as_t(t_wc)[None],
                              cam)[0]


def depth_to_points(depth, R_wc, t_wc, cam: CameraModel,
                    stride: int = 2):
    """Back-project a depth image to a world point cloud — the local
    map the reference publishes (`pcl_render_node.cpp:231-261`, which
    also subsamples by 2 in u,v). Zero pixels are dropped; the output
    is host numpy (ragged size)."""
    if isinstance(depth, torch.Tensor):
        depth = depth.detach().cpu()
    depth = np.asarray(depth)
    vs, us = np.mgrid[0:cam.height:stride, 0:cam.width:stride]
    d = depth[::stride, ::stride].ravel()
    us, vs = us.ravel(), vs.ravel()
    keep = d > 0
    d, us, vs = d[keep], us[keep], vs[keep]
    x = (us - cam.cx) * d / cam.fx
    y = (vs - cam.cy) * d / cam.fy
    pts_c = np.stack([x, y, d], -1)
    return pts_c @ np.asarray(R_wc).T + np.asarray(t_wc)


def sensing_pose_from_odom(position, yaw, pitch_down: float = 0.0):
    """Camera pose from planar odometry: z-forward pinhole camera
    looking along the body +x axis (the reference mounts the depth
    camera forward on the drone, `pcl_render_node.cpp:264-283`).
    Returns host (R_wc, t_wc), float32."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch_down), np.sin(pitch_down)
    # camera axes in world frame: z = forward, x = right, y = down
    fwd = np.array([cy * cp, sy * cp, -sp])
    right = np.array([-sy, cy, 0.0])
    down = np.cross(fwd, right)
    R_wc = np.stack([right, down, fwd], axis=1)   # columns = cam axes
    return R_wc.astype(np.float32), np.asarray(position, np.float32)
