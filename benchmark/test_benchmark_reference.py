"""The benchmark's frozen inputs against the port's own problem sets, and
its plain reference against the port's CPU path at small sizes (a test
may import both; the harness's reference imports nothing of the port)."""

import filecmp
import json
import os

import numpy as np
import pytest
import torch

from benchmark import problems, reference as ref, reference_map as rmap
from svsdf_tpu_torch import bench
from svsdf_tpu_torch.models import mesh_sdf, shapes
from svsdf_tpu_torch.ops import kernels as kops
from svsdf_tpu_torch.ops import minco
from svsdf_tpu_torch.ops.svsdf import SVSDFConfig, svsdf_query
from svsdf_tpu_torch.parallel import batch as pb
from svsdf_tpu_torch.planner import wavefront
from svsdf_tpu_torch.utils import mapgen
from svsdf_tpu_torch.utils import trajectory as trj
from svsdf_tpu_torch.utils.gridmap import GridMap
from svsdf_tpu_torch.utils.transforms import backward_t

HERE = os.path.dirname(os.path.abspath(__file__))
CPU = torch.device("cpu")
F64 = torch.float64


def _json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def prism(tmp_path_factory):
    cfg = _json("configs", "heart-prism.json")["robot"]
    path = str(tmp_path_factory.mktemp("robot") / "heart.obj")
    problems.write_heart_prism(path, cfg["contour_step"], cfg["half_height"])
    return path, cfg


# ---------------------------------------------------------------------------
# frozen inputs
# ---------------------------------------------------------------------------

def test_problems_equal_the_ports():
    t = dict(_json("traffic", "staged-large.json"), pieces=8)
    ours = problems.draw_problems(t, 16, np.random.default_rng(5))
    theirs = bench.problem(8, 64, 16, seed=5)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    tau = backward_t(torch.full((8,), 1.5, dtype=torch.float32)).numpy()
    assert np.array_equal(problems.tau_of(1.5, 8), tau)


def test_grid_problem_equals_the_ports():
    t = _json("traffic", "grid-field.json")
    g = bench.grid_setup(t["points"], device="cpu")
    d, h, tl, w = (torch.as_tensor(a) for a in problems.grid_knots(t))
    assert torch.equal(minco.solve(d, h, tl, w).coeffs, g.traj.coeffs)
    xs, ys = problems.grid_axes(dict(t, shift=0.0), np.random.default_rng(0))
    assert np.array_equal(xs, g.xs.numpy()) and np.array_equal(ys,
                                                               g.ys.numpy())


def test_prism_equals_the_ports(prism, tmp_path):
    path, _ = prism
    theirs = bench.write_prism_obj("sdHeart", str(tmp_path / "b.obj"))
    assert filecmp.cmp(path, theirs, shallow=False)


def test_forest_equals_the_ports():
    m = _json("traffic", "forest-large.json")["map"]
    assert np.array_equal(problems.forest_points(m),
                          mapgen.map_forest(res=m["res"], seed=m["seed"],
                                            n_trees=m["n_trees"],
                                            extent=m["extent"],
                                            keepout=m["keepout"]))


@pytest.mark.parametrize("name", ["sdHeart", "heart-prism"])
def test_configured_stages_are_default_stages_40(name):
    cfg = _json("configs", f"{name}.json")
    theirs = pb.default_stages(40)
    assert len(cfg["stages"]) == len(theirs)
    for s, t in zip(cfg["stages"], theirs):
        assert (SVSDFConfig(**s["svsdf"]), s["iters"], s["line_search"],
                s["ls_candidates"], s["frozen_ls"]) == t


# ---------------------------------------------------------------------------
# the reference against the port's CPU path
# ---------------------------------------------------------------------------

def _problem(b=4, seed=3):
    t = dict(_json("traffic", "staged-large.json"), pieces=8)
    h, tl, obs, x0 = (torch.as_tensor(a, dtype=F64) for a in
                      problems.draw_problems(t, b, np.random.default_rng(seed)))
    return h, tl, obs, x0


def test_minco_and_energy():
    h, tl, _, x0 = _problem()
    r = ref.Prec.reference()
    c, d = ref.decision_to_traj(r, x0, h, tl, 8)
    times = pb.forward_t(x0[:, :8])
    theirs = minco.solve(times, h, tl, x0[:, 8:].reshape(4, 7, 3))
    assert torch.allclose(c, theirs.coeffs, rtol=1e-9, atol=1e-9)
    assert torch.allclose(ref.energy(r, c, d), minco.energy(theirs),
                          rtol=1e-9)
    t = torch.rand(4, 9, dtype=F64) * d.sum(1, keepdim=True)
    assert torch.allclose(ref.eval_traj(r, c, d, t), trj.pos(theirs, t),
                          atol=1e-9)


@pytest.mark.parametrize("dtype", [F64, torch.float32, torch.bfloat16])
def test_bodies(prism, dtype):
    path, cfg = prism
    g = torch.linspace(-4, 4, 81, dtype=F64)
    px, py = (a.to(dtype) for a in torch.meshgrid(g, g, indexing="ij"))
    heart = shapes.make_shape("sdHeart").sdf_xy(px, py)
    assert torch.equal(ref.sd_heart(px, py), heart)
    mesh = mesh_sdf.shape_from_mesh(path, resolution=cfg["selfmapresu"],
                                    margin=cfg["grid_margin"])
    body = ref.MeshBody(path, cfg["selfmapresu"], cfg["grid_margin"])
    tol = 1e-6 if dtype == F64 else 0.0      # the port's grid is float32
    assert torch.allclose(body(px, py).double(), mesh.sdf_xy(px, py).double(),
                          rtol=0.0, atol=tol)


def test_oracle_and_cost():
    cfg = _json("configs", "sdHeart.json")
    svs = cfg["stages"][-1]["svsdf"]
    h, tl, obs, x0 = _problem()
    r = ref.Prec.reference()
    c, d = ref.decision_to_traj(r, x0, h, tl, 8)
    o = ref.Oracle(**{k: v for k, v in svs.items()
                      if k in ref.Oracle.__dataclass_fields__},
                   scan_bf16=True)
    ours = ref.svsdf(ref.sd_heart, ref.Traj(r, c, d), obs, o)
    theirs = svsdf_query(shapes.make_shape("sdHeart"),
                         trj.Trajectory(c, d), obs, SVSDFConfig(**svs)).sdf
    assert torch.allclose(ours, theirs, rtol=0.0, atol=1e-9)
    assert (ours < 0).any()                   # the interior solve ran


# ---------------------------------------------------------------------------
# the front end's reference against the port's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def forest():
    t = _json("traffic", "forest-large.json")
    pts = problems.forest_points(t["map"])
    occ, lo = rmap.voxelize(pts, t["voxel"], t["sta_threshold"])
    grid = GridMap.from_points(pts, t["voxel"], t["sta_threshold"])
    assert np.array_equal(occ, grid.occ.astype(bool))
    assert np.array_equal(lo, grid.xyz_min)
    shape = shapes.make_shape("sdHeart")
    st = rmap.stencils(ref.sd_heart, t["kernel_size"], t["yaw_num"],
                       t["voxel"], t["safemargin"], CPU)
    assert torch.equal(st, kops.rasterize_shape_kernels(
        shape, t["kernel_size"], t["yaw_num"], t["voxel"], t["safemargin"],
        device="cpu"))
    feas = rmap.feasibility(occ[:, :, 0], st.numpy())
    assert np.array_equal(feas, kops.feasibility_maps(
        grid.occ2d.copy(), st, device="cpu").numpy())
    return t, torch.as_tensor(feas)


def test_route(forest):
    t, feas = forest
    free = feas.any(0)
    cells = torch.nonzero(free)
    rng = np.random.default_rng(1)
    starts = cells[rng.integers(0, len(cells), 6)]
    goals = cells[rng.integers(0, len(cells), 6)]
    d = rmap.distance_field(free, goals)
    assert torch.equal(d, wavefront.distance_field(free, goals,
                                                   max_iters=10 ** 6,
                                                   device="cpu"))
    n = 4 * sum(free.shape)
    path, length, ok = rmap.descend(d, starts, n)
    p2, l2, ok2 = wavefront.extract_path(d, starts, n, device="cpu")
    assert torch.equal(path, p2) and torch.equal(length, l2)
    assert torch.equal(ok, ok2) and ok.any()
    assert torch.equal(rmap.yaw_bins(feas, path),
                       wavefront.assign_yaws_dp(feas, path, device="cpu"))
