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
from benchmark import roofline
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
DTYPES = [F64, torch.float32, torch.bfloat16]
#: the deformable robot of the repository's scenarios
#: (utils/fixtures.py's deformable_rhombus)
BREATHING = {"body": "sdRhombus", "scale": {
    "schedule": "breathing", "amp": 0.2, "rate": 0.8, "kernel_scale": 1.2}}


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


@pytest.mark.parametrize("dtype", DTYPES)
def test_bodies(prism, dtype):
    path, cfg = prism
    g = torch.linspace(-4, 4, 81, dtype=F64)
    px, py = (a.to(dtype) for a in torch.meshgrid(g, g, indexing="ij"))
    heart = shapes.make_shape("sdHeart").sdf_xy(px, py)
    assert torch.equal(ref.body_file("sdHeart").sdf(px, py), heart)
    mesh = mesh_sdf.shape_from_mesh(path, resolution=cfg["selfmapresu"],
                                    margin=cfg["grid_margin"])
    body = ref.MeshBody(path, cfg["selfmapresu"], cfg["grid_margin"])
    tol = 1e-6 if dtype == F64 else 0.0      # the port's grid is float32
    assert torch.allclose(body(px, py).double(), mesh.sdf_xy(px, py).double(),
                          rtol=0.0, atol=tol)


def _seeded_points(dtype, n=65536, seed=11):
    """n seeded body-frame points over [-7, 7]^2 (past both robots) and
    times in [0, 30] s, rounded to ``dtype``."""
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((3, n), generator=g, dtype=F64)
    return ((14.0 * u[0] - 7.0).to(dtype), (14.0 * u[1] - 7.0).to(dtype),
            (30.0 * u[2]).to(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["sdHeart", "sdRhombus"])
def test_analytic_bodies_equal_the_ports(name, dtype):
    """Bit for bit: each body file computes the port's operations in the
    port's order, its constants rounded to the points' type alike."""
    px, py, _ = _seeded_points(dtype)
    assert torch.equal(ref.body_file(name).sdf(px, py),
                       shapes.make_shape(name).sdf_xy(px, py))


def _breathing_shape():
    s = BREATHING["scale"]
    return shapes.make_scaled_shape(
        "sdRhombus", shapes.breathing_scale(s["amp"], s["rate"]),
        kernel_scale=s["kernel_scale"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_breathing_body_equals_the_ports(dtype):
    """s(t) f(q / s(t)) bit for bit at seeded (p, t), in bfloat16 with
    the schedule's constants and every step rounded as the program's
    bfloat16 scale table rounds them; without t, the kernel scale."""
    px, py, t = _seeded_points(dtype)
    body = ref.make_body({"robot": BREATHING})
    shape = _breathing_shape()
    assert torch.equal(body(px, py, t), shape.sdf_xy_t(px, py, t))
    assert torch.equal(body(px, py), shape.sdf_xy(px, py))
    assert not torch.equal(body(px, py, t), body(px, py, t + 1.0))


def test_breathing_tstar_equals_a_dense_scan():
    """The reference's min over time of the breathing body, a fine coarse
    scan and refinement rounds, against the least of 32001 exact samples
    (a rigid robot's reads 0.8 m away)."""
    h, tl, obs, x0 = _problem()
    r = ref.Prec.reference()
    traj = ref.Traj(r, *ref.decision_to_traj(r, x0, h, tl, 8))
    body = ref.make_body({"robot": BREATHING})
    o = ref.Oracle(coarse_n=1024, refine_rounds=3, refine_n=32)
    best, t_star = ref.tstar(body, traj, obs, o)
    ts = ref._times(traj.total, 32001)[:, None].expand(-1, obs.shape[1], -1)
    dense = ref._exact(body, traj, obs, ts.contiguous()).amin(-1)
    # the dense samples lie 3.75e-4 s apart, and where the least is a kink
    # (a corner of the rhombus) the dense least lies above it by up to
    # that spacing times the rate at which the SDF changes
    assert (best <= dense + 1e-12).all()
    assert (dense - best).max() < 5e-4
    assert torch.equal(best, ref._exact(body, traj, obs, t_star[..., None])
                       [..., 0])


ROBOTS = {"sdHeart": {"body": "sdHeart"}, "sdRhombus-breathing": BREATHING}


@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_oracle_and_cost(robot):
    cfg = _json("configs", "sdHeart.json")
    svs = cfg["stages"][-1]["svsdf"]
    h, tl, obs, x0 = _problem()
    r = ref.Prec.reference()
    c, d = ref.decision_to_traj(r, x0, h, tl, 8)
    o = ref.Oracle(**{k: v for k, v in svs.items()
                      if k in ref.Oracle.__dataclass_fields__},
                   scan_bf16=True)
    body = ref.make_body({"robot": ROBOTS[robot]})
    shape = (_breathing_shape() if "scale" in ROBOTS[robot]
             else shapes.make_shape(robot))
    ours = ref.svsdf(body, ref.Traj(r, c, d), obs, o)
    theirs = svsdf_query(shape, trj.Trajectory(c, d), obs,
                         SVSDFConfig(**svs)).sdf
    assert torch.allclose(ours, theirs, rtol=0.0, atol=1e-9)
    assert (ours < 0).any()                   # the interior solve ran


# ---------------------------------------------------------------------------
# the roofline's count
# ---------------------------------------------------------------------------

#: launch records and the least seconds the parent's roofline.py gave
#: them: (body, B, M, K, bfloat16, grid bytes) -> seconds
PINNED = [
    (("sdHeart", 16384, 64, 96, True, 0), 3.230240095522388e-05),
    (("sdHeart", 16384, 12, 32, True, 0), 4.147352835820896e-06),
    (("sdHeart", 512, 64, 128, False, 0), 2.6918667462686567e-06),
    (("grid", 1, 65536, 256, False, 164836), 2.0282902925373135e-05),
    (("grid", 16384, 48, 96, True, 164836), 6.422919259701493e-05),
    (("grid", 16384, 48, 128, False, 164836), 0.00012169741755223881),
]


def _record(body, b, m, k, bf16, grid_bytes, scaled=False):
    return {"body": body, "b": b, "m": m, "k": k, "bf16": bf16,
            "scaled": scaled, "grid_bytes": grid_bytes}


@pytest.mark.parametrize("rec,want", PINNED)
def test_rigid_launches_keep_their_least_time(rec, want):
    assert roofline.least_seconds(_record(*rec)) == want


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("b,m,k", [(16384, 64, 96), (1, 64, 128)])
def test_a_scaled_launch_adds_its_operations_and_scales(b, m, k, bf16):
    """3 operations a pose-point in the scan's type (q / s twice, s f)
    and the (B, K) float32 scale table read once."""
    rigid, scaled = (_record("sdRhombus", b, m, k, bf16, 0, s)
                     for s in (False, True))
    peak = roofline.PEAK_BF16_OPS if bf16 else roofline.PEAK_F32_OPS
    n = ref.body_file("sdRhombus").OPS
    assert n == 43
    ops_s = b * m * k * (n + 3) / peak
    nbytes = b * m * 2 * 4 + b * k * 5 * 4 + b * m * (3 * 4 + 8)
    assert roofline.ops_by_type(scaled)[not bf16] == n + 3
    assert roofline.least_seconds(scaled) == pytest.approx(
        max(ops_s, nbytes / roofline.PEAK_BYTES), rel=1e-15)
    assert roofline.least_seconds(rigid) == pytest.approx(
        max(b * m * k * n / peak, (nbytes - b * k * 4) / roofline.PEAK_BYTES),
        rel=1e-15)


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
    st = rmap.stencils(ref.make_body({"robot": {"body": "sdHeart"}}),
                       t["kernel_size"], t["yaw_num"],
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
