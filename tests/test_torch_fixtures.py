"""Port parity: the reference-fixture loaders (svsdf_tpu_torch/utils/
fixtures.py, pcd.py, config.py ``PlannerConfig.from_yaml``) against the
JAX package's, on files written into a temporary directory in the
reference's layout (src/plan_manager/{config,pcds,shapes}): PCD maps in
ASCII and binary, a per-shape YAML config, the start / goal file and a
mesh robot's .obj. Every loaded array and config equals JAX's to the bit;
the mesh scenario's robot has the JAX robot's grid.

The reference's own 13 maps and its robots' .obj files are not in the
repository, so nothing here loads them; ``load_any`` of a name without
a fixture raises as the JAX loader does.
"""

import dataclasses

import numpy as np
import pytest
import torch

from svsdf_tpu.utils import fixtures as jfixtures
from svsdf_tpu.utils.config import PlannerConfig as JPlannerConfig
from svsdf_tpu.utils.pcd import read_pcd as jread_pcd
from svsdf_tpu_torch.bench import write_prism_obj
from svsdf_tpu_torch.utils import fixtures
from svsdf_tpu_torch.utils.config import PlannerConfig
from svsdf_tpu_torch.utils.pcd import read_pcd

torch.set_num_threads(1)

YAML = """\
inputdata: shapes/{robot}.obj
poly_params: [0.5, -0.25, 30.0]
kernel_size: 9
kernel_yaw_num: 12
occupancy_resolution: 0.5
safety_hor: 0.6
weight_p: 55.5
mapBound: [-10.0, 10.0, -8.0, 8.0, 0.0, 3.0]
loadStartEnd: true
unknown_key: 3
"""


def _write_pcd(path, pts, mode):
    head = ("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
            "FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
            f"WIDTH {len(pts)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
            f"POINTS {len(pts)}\nDATA {mode}\n")
    with open(path, "wb") as f:
        f.write(head.encode())
        if mode == "ascii":
            f.write("".join(f"{x} {y} {z}\n" for x, y, z in pts).encode())
        else:
            f.write(np.asarray(pts, "<f4").tobytes())


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A reference checkout with two scenarios (ASCII and binary maps) and
    a mesh robot for the first."""
    r = tmp_path_factory.mktemp("reference")
    pm = r / "src" / "plan_manager"
    for sub in ("config", "pcds", "shapes"):
        (pm / sub).mkdir(parents=True)
    rng = np.random.default_rng(0)
    for name, mode in (("heartbot", "ascii"), ("sdHeart", "binary")):
        (pm / "config" / f"{name}.yaml").write_text(YAML.format(robot=name))
        pts = rng.uniform([-9, -7, 0], [9, 7, 2.5], (400, 3)).astype(
            np.float32)
        _write_pcd(pm / "pcds" / f"map_{name}.pcd", pts, mode)
        (pm / "pcds" / f"trajectory_{name}.txt").write_text(
            "Some header\nStart: -6.5 2.25 0.1\n  End: 7.0 -3.5 1.5e-1\n")
    # a config without a map is not a scenario
    (pm / "config" / "orphan.yaml").write_text(YAML.format(robot="x"))
    write_prism_obj("sdHeart", str(pm / "shapes" / "heartbot.obj"))
    return str(r)


@pytest.mark.parametrize("name", ["heartbot", "sdHeart"])
def test_read_pcd_matches_jax(root, name):
    path = f"{root}/src/plan_manager/pcds/map_{name}.pcd"
    got, want = read_pcd(path), jread_pcd(path)
    assert got.dtype == want.dtype == np.float32 and got.shape == (400, 3)
    np.testing.assert_array_equal(got, want)


def test_from_yaml_matches_jax(root):
    path = f"{root}/src/plan_manager/config/heartbot.yaml"
    got, want = PlannerConfig.from_yaml(path), JPlannerConfig.from_yaml(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.poly_params == (0.5, -0.25, 30.0) and got.weight_p == 55.5
    assert got.shape_name == "heartbot"


def test_start_end_and_listing_match_jax(root):
    path = f"{root}/src/plan_manager/pcds/trajectory_heartbot.txt"
    for a, b in zip(fixtures.load_start_end(path),
                    jfixtures.load_start_end(path)):
        np.testing.assert_array_equal(a, b)
    assert fixtures.list_scenarios(root) == jfixtures.list_scenarios(root) \
        == ["heartbot", "sdHeart"]


@pytest.mark.parametrize("name", ["heartbot", "sdHeart", "mesh_heartbot"])
def test_load_any_matches_jax(root, name):
    sc, jsc = fixtures.load_any(name, root), jfixtures.load_any(name, root)
    assert sc.name == jsc.name
    assert dataclasses.asdict(sc.config) == dataclasses.asdict(jsc.config)
    for a in ("map_points", "start", "goal"):
        np.testing.assert_array_equal(getattr(sc, a), getattr(jsc, a))
    if not name.startswith("mesh_"):
        assert sc.shape is None and jsc.shape is None
        return
    jg = jsc.shape.body_sdf.__self__
    assert sc.shape.name == jsc.shape.name == "mesh:heartbot"
    assert (sc.shape.tx, sc.shape.ty, sc.shape.yaw0) == (
        jsc.shape.tx, jsc.shape.ty, jsc.shape.yaw0)
    assert (sc.shape.grid.nx, sc.shape.grid.ny) == (jg.nx, jg.ny)
    np.testing.assert_array_equal(sc.shape.grid.values,
                                  np.asarray(jg.values, np.float32))


def test_missing_fixtures_raise_as_in_jax(root):
    with pytest.raises(FileNotFoundError):
        fixtures.mesh_scenario("sdHeart", root)      # no shapes/sdHeart.obj
    with pytest.raises(FileNotFoundError):
        jfixtures.mesh_scenario("sdHeart", root)
    with pytest.raises(FileNotFoundError):
        fixtures.load_any("orphan", root)
    # the synthetic and deformable names need no checkout
    assert fixtures.load_any("synthetic_Circle").name == "synthetic_Circle"
    assert fixtures.load_any("deformable_star").shape.time_varying
