"""The benchmark's manifest and sources: names, units and keys as the
benchmark's contract allows them, every cell's files present, and no
file of the harness or the reference importing JAX or the JAX package
(or, for the reference and its body files, the program)."""

import ast
import json
import os
import re

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
#: top-level module names no file run on the card may import
FORBIDDEN = {"jax", "jaxlib", "flax", "svsdf_tpu"}
#: the reference and the inputs import nothing of the program either
PLAIN = ("reference.py", "reference_map.py", "problems.py", "roofline.py")


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_limits(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(manifest["paths"]) <= 16
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
               and ".." not in p for p in manifest["paths"])
    assert len(manifest["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") for w in
               manifest["command"])
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51
    assert len(json.dumps(manifest)) <= 64 * 1024


def test_names_units_and_lines(manifest):
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in manifest[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), names
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert c["file"].startswith(tuple(p + "/" for p in
                                          manifest["paths"]))
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_has_its_files(manifest):
    cfg_names = {c["name"] for c in manifest["configs"]}
    used = {w["config"] for w in manifest["workloads"]}
    assert used == cfg_names
    for c in manifest["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in manifest["workloads"]:
        assert w["config"] in cfg_names
        with open(os.path.join(HERE, "traffic", w["traffic"] + ".json")) as f:
            traffic = json.load(f)
        assert traffic["rate_metric"] in {m["name"] for m in
                                          manifest["end_to_end"]}
        assert os.path.isfile(os.path.join(HERE, "limits",
                                           w["name"] + ".json"))
        reported = [m for m in manifest["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert {"setup_s", traffic["rate_metric"]} <= {m["name"] for m in
                                                       reported}
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in manifest["per_layer"])
    from benchmark import run
    for m in manifest["per_layer"]:
        # the reader of its kind: the name before the first dot
        assert os.path.isfile(os.path.join(
            HERE, "metrics", m["name"].split(".")[0] + ".py")), m
        assert callable(run.reader(m["name"]))


def _imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _sources():
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_file_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = _imports(path) & FORBIDDEN
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    bodies = sorted(os.path.join("bodies", f)
                    for f in os.listdir(os.path.join(HERE, "bodies"))
                    if f.endswith(".py"))
    assert "bodies/sdHeart.py" in bodies
    for f in PLAIN + tuple(bodies):
        mods = _imports(os.path.join(HERE, f))
        assert "svsdf_tpu_torch" not in mods and not mods & FORBIDDEN, f


def test_top_level_names_compare_whole():
    from benchmark import run
    assert "svsdf_tpu_torch".split(".")[0] not in run.FORBIDDEN
    assert set(run.FORBIDDEN) == FORBIDDEN
