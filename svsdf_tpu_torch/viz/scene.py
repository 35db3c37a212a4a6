"""Planning-scene rendering to PNG (svsdf_tpu/viz/scene.py) — the RViz
marker stack's job
(`src/utils/include/utils/Visualization.hpp:72-1339`: visMesh,
visTraj colored by speed, R3/SE3 paths, point clouds, balls) done
headlessly with matplotlib onto files instead of RViz topics.

One entry point, `render_scene`, layers whatever artifacts the caller
has: occupancy slice, obstacle points, A* path, optimized trajectory
(colored by speed — visTraj, Visualization.hpp:1277), robot outlines at
sampled poses, and the swept-volume boundary contour.

Host matplotlib only, imported inside the functions that draw: the
package imports where matplotlib is not installed.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from svsdf_tpu_torch.utils import trajectory as trj

# categorical slots (dataviz reference palette, light mode)
_C_PATH = "#2a78d6"      # A* path — blue
_C_SHAPE = "#eb6834"     # robot outlines — orange
_C_SWEPT = "#1baf7a"     # swept boundary — aqua
_C_OBS = "#52514e"       # obstacle points — secondary ink
_C_MAP = "#c3c2b7"       # occupancy — muted


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return matplotlib, plt


def shape_outline(shape, yaw: float = 0.0, t: float = 0.0,
                  extent: float = 6.0, n: int = 241) -> np.ndarray:
    """Zero-level contour of the (possibly time-varying) shape SDF in
    the body frame rotated by yaw, as an (K, 2) polyline (marching
    squares via matplotlib's contour engine on a dense SDF grid, the
    SDF evaluated on the host in float64)."""
    _, plt = _pyplot()
    xs = np.linspace(-extent, extent, n)
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    gx_t, gy_t = torch.as_tensor(gx), torch.as_tensor(gy)
    d = shape.sdf_xy_t(gx_t, gy_t, torch.full_like(gx_t, t)).numpy()
    fig = plt.figure()
    try:
        cs = plt.contour(gx, gy, d, levels=[0.0])
        segs = [p.vertices for p in cs.get_paths()] if cs.get_paths() else []
    finally:
        plt.close(fig)
    if not segs:
        return np.zeros((0, 2))
    poly = max(segs, key=len)
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s], [s, c]])
    return poly @ R.T


def render_scene(out_path: str,
                 occupancy: Optional[np.ndarray] = None,
                 origin=(0.0, 0.0), resolution: float = 0.1,
                 obstacles: Optional[np.ndarray] = None,
                 astar_path: Optional[np.ndarray] = None,
                 traj=None, shape=None, n_poses: int = 7,
                 swept_contours: Optional[Sequence[np.ndarray]] = None,
                 title: str = "", dpi: int = 130) -> str:
    """Compose and save the scene. Any layer may be None.

    occupancy: (X, Y) boolean/float 2-D slice; origin/resolution place
    it in world coordinates. obstacles: (M, 2). astar_path: (K, >=2).
    traj: utils.trajectory.Trajectory, a batch of one (xy in dims 0,1;
    yaw in 2). swept_contours: list of (K, 2) world polylines.
    """
    matplotlib, plt = _pyplot()
    from matplotlib.collections import LineCollection
    fig, ax = plt.subplots(figsize=(9, 7))
    try:
        if occupancy is not None:
            occ = np.asarray(occupancy)
            ex = (origin[0], origin[0] + occ.shape[0] * resolution,
                  origin[1], origin[1] + occ.shape[1] * resolution)
            ax.imshow(occ.T, origin="lower", extent=ex,
                      cmap=matplotlib.colors.ListedColormap(
                          ["#fcfcfb", _C_MAP]),
                      vmin=0, vmax=1, interpolation="nearest",
                      zorder=0)
        if obstacles is not None and len(obstacles):
            obstacles = np.asarray(obstacles)
            ax.scatter(obstacles[:, 0], obstacles[:, 1], s=4,
                       c=_C_OBS, alpha=0.5, linewidths=0,
                       label="obstacle points", zorder=2)
        if astar_path is not None and len(astar_path):
            p = np.asarray(astar_path)
            ax.plot(p[:, 0], p[:, 1], "--", color=_C_PATH, lw=2,
                    label="A* path", zorder=3)
        if traj is not None:
            traj = trj.Trajectory(traj.coeffs.detach().cpu(),
                                  traj.durations.detach().cpu())
            total = float(traj.total_duration[0])
            ts = np.linspace(0.0, total, 300)
            ts_t = torch.as_tensor(ts, dtype=traj.coeffs.dtype)[None]
            pos = trj.eval_at(traj, ts_t, 0)[0].numpy()
            vel = trj.eval_at(traj, ts_t, 1)[0].numpy()
            speed = np.linalg.norm(vel[:, :2], axis=-1)
            pts = pos[:, :2].reshape(-1, 1, 2)
            segs = np.concatenate([pts[:-1], pts[1:]], axis=1)
            # one-hue sequential ramp: magnitude = speed (visTraj)
            lc = LineCollection(
                segs, cmap="Blues",
                norm=plt.Normalize(0.0, max(speed.max(), 1e-6)),
                linewidths=2.5, zorder=4)
            lc.set_array(speed[:-1])
            ax.add_collection(lc)
            cb = fig.colorbar(lc, ax=ax, shrink=0.75, pad=0.01)
            cb.set_label("speed (m/s)", color="#52514e")
            if shape is not None:
                yaws = pos[:, 2]
                for k in np.linspace(0, len(ts) - 1, n_poses).astype(int):
                    o = shape_outline(shape, yaws[k], float(ts[k]))
                    if len(o):
                        ax.plot(o[:, 0] + pos[k, 0], o[:, 1] + pos[k, 1],
                                color=_C_SHAPE, lw=1.2, alpha=0.8,
                                zorder=5)
        if swept_contours:
            for i, c in enumerate(swept_contours):
                c = np.asarray(c)
                if len(c):
                    ax.plot(c[:, 0], c[:, 1], color=_C_SWEPT, lw=2,
                            label="swept boundary" if i == 0 else None,
                            zorder=6)
        ax.set_aspect("equal")
        ax.set_xlabel("x (m)", color="#52514e")
        ax.set_ylabel("y (m)", color="#52514e")
        if title:
            ax.set_title(title, color="#0b0b0b")
        handles, labels = ax.get_legend_handles_labels()
        if len(labels) >= 2:
            ax.legend(loc="upper right", framealpha=0.9)
        for spine in ax.spines.values():
            spine.set_color("#c3c2b7")
        ax.grid(True, color="#eeeeec", lw=0.6, zorder=-1)
        ax.set_axisbelow(True)
        fig.tight_layout()
        fig.savefig(out_path, dpi=dpi)
    finally:
        plt.close(fig)
    return out_path


def write_obj(path: str, vertices: np.ndarray,
              faces: Optional[np.ndarray] = None) -> str:
    """Minimal OBJ writer (writeSVtoObj parity, sw_manager.hpp:176-185).
    vertices: (V, 3); faces: (F, 3) zero-based int indices or None for
    a point-cloud OBJ."""
    vertices = np.asarray(vertices, np.float64)
    with open(path, "w") as f:
        for v in vertices:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        if faces is not None:
            for tri in np.asarray(faces, np.int64) + 1:
                f.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")
    return path
