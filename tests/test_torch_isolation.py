"""The PyTorch port stands alone.

  * importing every module of ``svsdf_tpu_torch``, ``chip_smoke`` and
    ``scan_ab`` in a fresh interpreter loads neither ``jax`` nor any
    ``svsdf_tpu`` module;
  * no source file of the port imports JAX or names ``svsdf_tpu.``
    outside comments;
  * an entry point called without ``device`` runs on CUDA, so it raises
    where CUDA is absent instead of falling back to the host.
"""

import io
import json
import os
import re
import subprocess
import sys
import tokenize
from pathlib import Path

import pytest
import torch

import numpy as np

from svsdf_tpu_torch import convert, resolve_device
from svsdf_tpu_torch.bench import BENCH_MEM_SIZE, problem
from svsdf_tpu_torch.models import shapes
from svsdf_tpu_torch.ops import esdf
from svsdf_tpu_torch.ops import kernels as kops
from svsdf_tpu_torch.parallel import batch as pb
from svsdf_tpu_torch.planner import back_end, mid_end, wavefront
from svsdf_tpu_torch.planner.online import OnlineReplanner
from svsdf_tpu_torch.planner.pipeline import Planner
from svsdf_tpu_torch.utils import fixtures, lbfgs, lmbm
from svsdf_tpu_torch.utils.config import PlannerConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "svsdf_tpu_torch"
SCRIPTS = ["chip_smoke", "scan_ab", "grid_ab"]
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / f"{s}.py" for s in SCRIPTS]


def _module_names():
    names = []
    for path in sorted(PKG.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names + SCRIPTS


_PROBE = """
import importlib, json, sys
for name in json.loads(sys.argv[1]):
    importlib.import_module(name)
print(json.dumps(sorted(
    m for m in sys.modules
    if m in ("jax", "svsdf_tpu") or m.startswith(("jax.", "svsdf_tpu."))
)))
"""


def test_fresh_import_loads_no_jax():
    names = _module_names()
    assert {"svsdf_tpu_torch.ops.cuda_svsdf", "svsdf_tpu_torch.ops.flatness",
            "svsdf_tpu_torch.planner.pipeline",
            "svsdf_tpu_torch.planner.mid_end",
            "svsdf_tpu_torch.planner.astar",
            "svsdf_tpu_torch.planner.parity",
            "svsdf_tpu_torch.utils.debugbus",
            "svsdf_tpu_torch.utils.lmbm",
            "svsdf_tpu_torch.models.mesh_sdf",
            "svsdf_tpu_torch.viz.swept_surface",
            "svsdf_tpu_torch.utils.pcd",
            "svsdf_tpu_torch.planner.traj_server",
            "svsdf_tpu_torch.io", "svsdf_tpu_torch.io.polytraj",
            "svsdf_tpu_torch.sim.kinematic",
            "svsdf_tpu_torch.sim.quadrotor",
            "svsdf_tpu_torch.sim.so3_control",
            "svsdf_tpu_torch.sim.closed_loop",
            "svsdf_tpu_torch.sim.depth_camera",
            "svsdf_tpu_torch.utils.profiling",
            "svsdf_tpu_torch.utils.checkpoint",
            "svsdf_tpu_torch.utils.cache",
            "svsdf_tpu_torch.viz.dashboard",
            "svsdf_tpu_torch.utils.geo",
            "svsdf_tpu_torch.viz.scene",
            "svsdf_tpu_torch.native", "svsdf_tpu_torch.ops.banded",
            "svsdf_tpu_torch.parallel.multihost",
            "svsdf_tpu_torch.parallel.local_world"} <= set(names)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _PROBE, json.dumps(names)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _code_without_comments(path):
    toks = tokenize.generate_tokens(io.StringIO(path.read_text()).readline)
    return " ".join(t.string for t in toks if t.type != tokenize.COMMENT)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_jax(path):
    code = _code_without_comments(path)
    assert not re.search(r"\bimport\s+jax\b|\bfrom\s+jax\b", code)
    assert not re.search(r"\bsvsdf_tpu\.", code)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    h, t, o, x0 = problem(2, 4, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.problem_from_numpy(h, t, o, x0)
    prob, x = convert.problem_from_numpy(h, t, o, x0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        pb.plan_batch_staged(shapes.make_shape("sdHeart"), x, prob,
                             PlannerConfig(mem_size=BENCH_MEM_SIZE),
                             pb.default_stages(5, scan_dtype=None), 2)


def test_e2e_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = fixtures.synthetic_scenario("Circle")
    feas = np.ones((4, 6, 5), bool)
    occ = np.asarray([[0.5, 0.5]], np.float32)
    cells = np.asarray([[1, 1]])
    with pytest.raises(RuntimeError, match="CUDA"):
        pb.plan_batch_e2e(shapes.make_shape("Circle"), feas, occ, cells,
                          cells, sc.config, pb.default_stages(5), 2, 1, 1.0,
                          np.zeros(2, np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        OnlineReplanner(sc.config, sc.map_points)
    with pytest.raises(RuntimeError, match="CUDA"):
        kops.feasibility_maps(np.zeros((6, 5), np.uint8), feas)
    with pytest.raises(RuntimeError, match="CUDA"):
        wavefront.distance_field(feas[0], cells)
    with pytest.raises(RuntimeError, match="CUDA"):
        esdf.esdf(np.zeros((6, 5), np.uint8), 1.0)



def test_planner_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = fixtures.synthetic_scenario("Circle")
    with pytest.raises(RuntimeError, match="CUDA"):
        Planner(sc.config, sc.map_points)
    head = np.zeros((1, 3, 3))
    wps = np.zeros((1, 2, 3))
    with pytest.raises(RuntimeError, match="CUDA"):
        mid_end.optimize(head, head, wps, np.ones((1, 3)))
    with pytest.raises(RuntimeError, match="CUDA"):
        back_end.optimize(shapes.make_shape("Circle"), head, head,
                          np.zeros((1, 4, 2)), np.zeros((1, 9)))
    # the host runs only when asked for
    assert Planner(sc.config, sc.map_points, device="cpu").feas.shape[0] \
        == sc.config.kernel_yaw_num


def test_deformable_and_lmbm_entry_points_default_to_cuda(monkeypatch):
    """A deformable scenario's Planner and the LMBM back end run on CUDA
    unless asked for the host; a scaled shape is plain data."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = fixtures.deformable_scenario("deformable_star")
    assert isinstance(sc.shape, shapes.ScaledShape) and sc.shape.time_varying
    heart = shapes.make_scaled_shape("sdHeart", shapes.breathing_scale(
        0.25, 0.8), kernel_scale=1.25)
    assert float(heart.sdf_xy(torch.tensor(0.0), torch.tensor(2.0))) < 0.0
    with pytest.raises(RuntimeError, match="CUDA"):
        Planner(sc.config, sc.map_points, shape=sc.shape)
    with pytest.raises(RuntimeError, match="CUDA"):
        Planner(sc.config, sc.map_points, solver="lmbm")
    head = np.zeros((1, 3, 3))
    with pytest.raises(RuntimeError, match="CUDA"):
        back_end.optimize(heart, head, head, np.zeros((1, 4, 2)),
                          np.zeros((1, 9)), solver="lmbm")
    x = torch.zeros((2, 3), dtype=torch.float64)
    res = lmbm.minimize(lbfgs.value_and_grad(lambda v: (v * v).sum(-1)), x)
    assert res.x.device.type == "cpu" and bool((res.f == 0.0).all())


def test_mesh_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """A mesh robot is plain data (its grid on the host, a copy per device
    made on use); the Planner and the batch solve that take it run on CUDA
    unless asked for the host."""
    import dataclasses
    from svsdf_tpu_torch.bench import write_prism_obj
    from svsdf_tpu_torch.models import mesh_sdf
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    obj = write_prism_obj("Circle", str(tmp_path / "cyl.obj"), extent=2.0)
    shape = shapes.shape_from_objpath(obj)
    assert shape.name == "mesh:cyl" and shape.grid._tables == {}
    assert float(shape.sdf(torch.zeros((1, 2)))[0]) < 0.0
    sc = fixtures.synthetic_scenario("Circle")
    cfg = dataclasses.replace(sc.config, inputdata=obj)
    with pytest.raises(RuntimeError, match="CUDA"):
        Planner(cfg, sc.map_points)
    h, t, o, x0 = problem(2, 4, 1)
    prob, x = convert.problem_from_numpy(h, t, o, x0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        pb.plan_batch_staged(shape, x, prob,
                             PlannerConfig(mem_size=BENCH_MEM_SIZE),
                             pb.default_stages(5), 2)
    assert isinstance(mesh_sdf.grid_sdf_3d(*mesh_sdf.load_obj(obj), 0.5),
                      mesh_sdf.GridSDF3D)


def test_deployment_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """The deployment loop's functions that build tensors from host data
    (a decoded message, a loaded checkpoint, a hover state) run on CUDA
    unless asked for the host; the others run where their tensors are."""
    from svsdf_tpu_torch.io import (decode_minco_traj, decode_poly_traj,
                                    encode_minco_traj, encode_poly_traj)
    from svsdf_tpu_torch.ops import minco
    from svsdf_tpu_torch.planner import traj_server
    from svsdf_tpu_torch.sim import closed_loop, quadrotor
    from svsdf_tpu_torch.utils import checkpoint
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    times = torch.ones((1, 3))
    head = torch.zeros((1, 3, 3))
    tail = torch.zeros((1, 3, 3))
    tail[0, 0, 0] = 3.0
    wps = torch.tensor([[[1.0, 0.2, 0.0], [2.0, -0.2, 0.0]]])
    traj = minco.solve(times, head, tail, wps)
    msg = encode_poly_traj(traj)
    mmsg = encode_minco_traj(times[0], head[0], tail[0], wps[0])
    path = checkpoint.save_plan(str(tmp_path / "p.npz"), torch.zeros(1, 9),
                                traj)
    bpath = checkpoint.save_batch(str(tmp_path / "b.npz"), torch.zeros(2, 9),
                                  torch.zeros(2), torch.zeros(2, dtype=bool))
    for call in (lambda: decode_poly_traj(msg),
                 lambda: decode_minco_traj(mmsg),
                 lambda: checkpoint.load_plan(path),
                 lambda: checkpoint.load_batch(bpath),
                 lambda: quadrotor.hover_state((0.0, 0.0, 1.0))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert decode_poly_traj(msg, device="cpu").coeffs.device.type == "cpu"
    assert checkpoint.load_plan(path, device="cpu").opt_x.shape == (1, 9)
    stream = traj_server.sample_commands(traj)
    assert stream.pos.device.type == "cpu" and stream.pos.shape[0] == 1
    assert closed_loop.fly(traj).pos.device.type == "cpu"


def test_native_runtime_is_the_ports_own():
    """The port builds its own copy of the C++ runtime into its build
    directory and never loads the JAX package's library."""
    from svsdf_tpu_torch import native
    from svsdf_tpu_torch.ops.cuda_svsdf import BUILD_DIR
    assert native.SOURCE == PKG / "csrc" / "runtime.cpp"
    assert native.library_path().parent == BUILD_DIR
    assert BUILD_DIR.is_relative_to(ROOT / "build")
    assert native.available(), native.build_log()
    assert not native._load()._name.startswith(str(ROOT / "svsdf_tpu"))


def test_sharded_and_esdf_entry_points_default_to_cuda(monkeypatch):
    from svsdf_tpu_torch.parallel import multihost as mh
    from svsdf_tpu_torch.utils.gridmap import GridMap
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    for call in (lambda: pb.make_mesh(1, 1), lambda: mh.pod_mesh(),
                 lambda: mh.initialize("127.0.0.1:1", 1, 0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    occ = np.zeros((4, 4, 2), np.uint8)
    occ[1, 1, 0] = 1
    g = GridMap(resolution=1.0, xyz_min=np.zeros(3), occ=occ)
    for call in (g.generate_esdf, lambda: g.sdf_value(np.zeros((1, 3))),
                 lambda: g.sdf_value_with_grad(np.zeros(3))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # the host runs only when asked for
    assert g.generate_esdf(device="cpu").device.type == "cpu"
    mesh = pb.make_mesh(1, 1, device="cpu")
    h, t, o, x0 = problem(2, 4, 2)
    out = pb.sharded_plan_batch(shapes.make_shape("Circle"), mesh,
                                PlannerConfig(mem_size=BENCH_MEM_SIZE),
                                pb.default_stages(5, scan_dtype=None)[0][0],
                                2, max_iters=2)(x0, h, t, o)
    assert out[0].device.type == "cpu"
