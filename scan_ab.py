#!/usr/bin/env python3
"""Time this tree's coarse-scan kernel against another tree's, in turns,
on one NVIDIA card, in each of its four forms.

    python3 scan_ab.py OTHER_TREE [--log SMOKE_LOG] [--variants] [--out FILE]
    python3 scan_ab.py --variants [--out FILE]
    python3 scan_ab.py --sass [--out FILE]

OTHER_TREE is a second checkout of the repository (for instance the
parent commit unpacked with ``git archive`` into a git-ignored
directory); its ``svsdf_tpu_torch/ops/cuda_svsdf.py`` builds its own
kernel from its own sources into its own ``build/kernels/``. The cases
(body, form, B, M, K): chip_smoke.py's phase-3 shapes (main, e2e, single
plan, grid query) for sdHeart in float32 and in bfloat16, every body at
512x64x96 in float32 and in bfloat16, the deformable sdHeart (both scan
types) at 512x64x96, and every shape and form that the ``path_scans``
lines of a chip_smoke.py log (``--log``) name. At each, both kernels are
first held bit for bit against the plain version on seeded inputs, then
each kernel's device time per launch is read with torch.profiler in the
order other, this, this, other. At sdHeart's 512x64x96 and grid shapes
this kernel is also timed at every lane count S <= min(32, K), which
``launch_geometry`` chooses among, in turns (S ascending, then
descending), in both scan types. Prints one JSON line per case, a
summary line, the card's name and power limit; writes all of it to
``--out`` as JSON.

``--variants`` times the deformable float32 form (each deformable
scenario's robot: sdHeart, sdRhombus, star) at the single plan's shapes
(1x768x128, 1x512x128, where its launches fall) and at 512x64x96, in
turns (the builds in order, then in reverse), in this tree's build, the
other tree's if given, and diagnostic builds of this tree's source, each
edited as text into ``build/scan_variants/<name>/`` (a variant is a
measurement, not a kernel: the package never loads one):

  * ``ieee_div``: the divisions q / s as IEEE divisions (div.rn.f32 with
    its reciprocal estimate, range check and slow-path branch each), the
    route before the scale records: what one reciprocal a pose saves;
  * ``recompute_nb``: the argmin's neighbours evaluated again by two
    lanes after the butterfly, not taken from the lanes that hold them:
    what the shuffles save at ceil(K / S) <= 4;
  * ``ieee_root``: the bodies' square roots as sqrt.rn (its slow-path
    branch included): what the branch-free ``root_rn`` saves;
  * ``floor``: the same staging (scale records included), point loads,
    butterfly, shuffles and stores, with the whole evaluation (pose
    transform, division, body) replaced by one subtraction on the loaded
    point and pose: the least time a launch of this shape and these bytes
    takes on the card.

Every build but ``floor`` is first held bit for bit against the plain
version on seeded inputs.

``--sass`` instead compiles this tree's kernel to a cubin with the
wrapper's nvcc flags and reads it with cuobjdump (no card needed): for
each body and form, its SASS instruction count and its loops (a
backward branch and the instructions it spans), largest first, with the
opcodes in each. The scan's unrolled loop holds four poses in every
form (four evaluations in float32, two packed ones in bfloat16), so its
count over 4 is the static instructions a pose costs, and its MUFU
count over 4 the special-function instructions a pose issues.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import chip_smoke as smoke

ROOT = Path(__file__).resolve().parent
#: (source text, replacement) edits of each diagnostic build of the
#: deformable float32 form
VARIANTS = {
    "ieee_div": (
        ("  div_by_scale(qx, qy, sr);\n",
         "  qx = qx / sr.x;\n  qy = qy / sr.x;\n"),),
    "recompute_nb": (
        ("      if (K <= 4 * lanes) {", "      if (K < 0) {"),),
    "ieee_root": (
        ("Fs vsqrt(Fs x) { return Fs(root_rn(x.v)); }",
         "Fs vsqrt(Fs x) { return Fs(sqrtf(x.v)); }"),),
    "floor": (
        ("  const T dx = px - cx;\n",
         "  if constexpr (kScaled && std::is_same<T, float>::value) {\n"
         "    return px - cx;\n  }\n  const T dx = px - cx;\n"),),
}
#: the diagnostic builds that compute another function than the plain
#: version's
INEXACT = ("floor",)
#: (B, M, K) at which --variants times the deformable float32 form
VARIANT_SHAPES = smoke.PLANNER_SHAPES + (smoke.BODY_TIME_SHAPE,)
#: (S, threads) geometries --variants times this tree's deformable
#: float32 form at, at the single plan's shapes, beside launch_geometry's
GEOMETRIES = ((32, 128), (32, 64), (32, 32), (16, 128), (16, 64), (8, 128))


def load_other(tree: str):
    """The other tree's cuda_svsdf module, under its own name."""
    path = os.path.join(tree, "svsdf_tpu_torch", "ops", "cuda_svsdf.py")
    spec = importlib.util.spec_from_file_location("other_cuda_svsdf", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_variant(label: str, edits, folder: str):
    """This tree's cuda_svsdf module under the name ``label``, building
    this tree's kernel source with the (text, replacement) ``edits``
    applied, each text found exactly once, into build/<folder>/. Its
    build() still has to be called."""
    spec = importlib.util.spec_from_file_location(
        label, ROOT / "svsdf_tpu_torch" / "ops" / "cuda_svsdf.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    src = mod.SOURCE.read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"{label}: source text not found once: {old}")
        src = src.replace(old, new)
    mod.BUILD_DIR = ROOT / "build" / folder
    mod.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    mod.SOURCE = mod.BUILD_DIR / "coarse_scan.cu"
    mod.SOURCE.write_text(src)
    return mod


def variant_module(name: str):
    """The diagnostic build ``name`` of VARIANTS (not built yet)."""
    return build_variant(f"scan_variant_{name}", VARIANTS[name],
                         f"scan_variants/{name}")


def deformable_robots():
    """{body: shape} of the deformable scenarios' robots."""
    from svsdf_tpu_torch.utils import fixtures
    robots = {}
    for scenario in fixtures.list_deformable_scenarios():
        robot = fixtures.deformable_scenario(scenario).shape
        robots[robot.name] = robot
    return robots


def variant_rows(torch, builds: dict, reps: int):
    """The deformable float32 form of each build (name -> cuda_svsdf
    module, ``this`` among them) timed in turns at VARIANT_SHAPES with
    each deformable robot; the builds not in INEXACT first held bit for bit
    against the plain version."""
    this = builds["this"]
    rows = []
    robots = deformable_robots()
    cases = [(name, sh) for name in robots for sh in VARIANT_SHAPES]
    for i, (name, (b, m, k)) in enumerate(cases):
        shape = robots[name]
        inp = smoke.scan_inputs(torch, b, m, k, seed=7500 + i)
        ts = smoke.pose_times(torch, b, k, seed=7500 + i)
        for label, mod in builds.items():
            if label not in INEXACT:
                smoke.compare_scan(torch, mod, shape, inp, 1e-5, None, ts)
        ms = {}
        for order in (list(builds), list(builds)[::-1]):
            for label in order:
                mod = builds[label]
                t, _ = smoke.device_ms(
                    torch, lambda: mod.coarse_scan(shape, *inp, ts=ts),
                    reps=reps)
                if t is None:
                    raise RuntimeError("torch.profiler saw no device time")
                ms.setdefault(label, []).append(t)
        med = {label: statistics.median(v) for label, v in ms.items()}
        bound, by = smoke.scan_bound_ms(shape, b, m, k)
        row = {"shape": name, "form": "scaled_float32", "B": b, "M": m,
               "K": k, "geometry": this.launch_geometry(b, m, k), "ms": ms,
               "bound_ms": bound, "bound_by": by,
               "vs_this": {label: v / med["this"] for label, v in
                           med.items()}}
        if (b, m, k) in smoke.PLANNER_SHAPES:
            row["this_ms_by_geometry"] = geometry_ms(torch, this, shape,
                                                     inp, ts, reps)
        if "floor" in med:
            row["floor_ms"] = med["floor"]
            row["this_over_floor_ms"] = med["this"] - med["floor"]
        rows.append(row)
        print("[scan_variants] " + json.dumps(row), flush=True)
    return rows


def geometry_ms(torch, cs, shape, inp, ts, reps):
    """{"S x threads": [ms, ms]} of the deformable float32 form at each of
    GEOMETRIES, in turns (in order, then in reverse), each launch first
    held bit for bit against the plain version."""
    b, m = inp[0].shape[:2]
    scale = cs.pose_scale(shape, ts)
    want = cs.coarse_scan_reference(shape, *inp, ts=ts)

    def run(s, threads):
        grid = (-(-m // (threads // s)), b)
        return cs.launch(shape, *inp, s, threads, grid, scale=scale)

    out = {}
    for s, threads in GEOMETRIES:
        if not all(torch.equal(x, y) for x, y in zip(run(s, threads), want)):
            raise AssertionError(f"S={s}, {threads} threads: not bit for "
                                 "bit")
    for s, threads in GEOMETRIES + GEOMETRIES[::-1]:
        t, _ = smoke.device_ms(torch, lambda: run(s, threads), reps=reps)
        out.setdefault(f"{s}x{threads}", []).append(t)
    return out


def shapes_from_log(path: str):
    """(body, form, B, M, K) of every path_scans line of a chip_smoke.py
    log."""
    found = []
    with open(path) as f:
        for line in f:
            if line.startswith("[path_scans] "):
                for item in json.loads(line[len("[path_scans] "):])["shapes"]:
                    name, form, bmk = item.split()
                    found.append((name, form, *map(int, bmk.split("x"))))
    return found


#: an instruction line of cuobjdump -sass: /*addr*/ text ;
_SASS_LINE = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
#: a label line (nvdisasm style), naming the next instruction's address
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
#: the target of a branch: an address, or a label in backquotes
_SASS_BRA = re.compile(r"\bBRA(?:\.\S+)?\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")


#: poses the scan's unrolled loop evaluates, in every form
POSES_PER_UNROLLED_LOOP = 4


def kernel_form(mangled: str) -> str:
    """'<body> <form>' of a coarse_scan_kernel<Shape, T, kScaled>
    instance from its mangled name: the body struct's length-prefixed
    name, in the file's anonymous namespace ('NS_', nvcc's substitution
    for it, or g++'s 'N12_GLOBAL__N_1') or not, then T, float ('f') or
    Bf2, and kScaled, 'Lb0E' or 'Lb1E'. Any other kernel keeps its
    mangled name; a coarse_scan_kernel instance that does not parse
    raises."""
    if "coarse_scan_kernel" not in mangled:
        return mangled
    m = re.search(r"coarse_scan_kernelI(NS\d*_|N12_GLOBAL__N_1)?(\d+)",
                  mangled)
    if m:
        n, end = int(m.group(2)), m.end()
        body = mangled[end:end + n]
        rest = re.match(r"%s(f|\w*?Bf2E)Lb([01])E" % ("E" if m.group(1)
                                                      else ""),
                        mangled[end + n:])
    if not (m and rest and re.fullmatch(r"[A-Za-z_]\w*", body)):
        raise ValueError(f"unparsed coarse_scan_kernel instance {mangled}")
    return "%s %s%s" % (body, "scaled_" if rest.group(2) == "1" else "",
                        "float32" if rest.group(1) == "f" else "bfloat16")


def parse_sass(text: str):
    """{body: {"instructions": n, "loops": [...]}} from cuobjdump -sass;
    a loop is a backward branch and the instructions from its target to
    it, with the opcode counts (predicates and modifiers dropped)."""
    kernels, name, instrs, labels, pending = {}, None, [], {}, []

    def close():
        if name is None:
            return
        addrs = [a for a, _ in instrs]
        loops = []
        for a, text in instrs:
            br = _SASS_BRA.search(text)
            if not br:
                continue
            target = labels.get(br.group(1)) if br.group(1) \
                else int(br.group(2), 16)
            if target is None or target >= a:
                continue
            body = [t for x, t in instrs if target <= x <= a]
            ops = collections.Counter(
                re.sub(r"^@!?U?P\S+\s+", "", t).split()[0].split(".")[0]
                for t in body)
            ops.pop("NOP", None)
            loops.append({"start": hex(target), "end": hex(a),
                          "instructions": sum(ops.values()),
                          "ops": dict(ops.most_common())})
        loops.sort(key=lambda lp: -lp["instructions"])
        kernels[kernel_form(name)] = {
            "instructions": sum(1 for _, t in instrs
                                if not t.lstrip().startswith("NOP")),
            "span": [hex(addrs[0]), hex(addrs[-1])] if addrs else None,
            "per_pose": (loops[0]["instructions"] / POSES_PER_UNROLLED_LOOP
                         if loops else None),
            "mufu_per_pose": (loops[0]["ops"].get("MUFU", 0)
                              / POSES_PER_UNROLLED_LOOP if loops else None),
            "loops": loops}

    for line in text.splitlines():
        fn = re.search(r"Function\s*:\s*(\S+)", line)
        if fn:
            close()
            name, instrs, labels, pending = fn.group(1), [], {}, []
            continue
        lab = _SASS_LABEL.match(line)
        if lab:
            pending.append(lab.group(1))
            continue
        ins = _SASS_LINE.match(line)
        if ins and name is not None:
            addr = int(ins.group(1), 16)
            for lb in pending:
                labels[lb] = addr
            pending = []
            instrs.append((addr, ins.group(2)))
    close()
    return kernels


def sass_report(cs) -> dict:
    """Compile cs.SOURCE to a cubin with the wrapper's flags (no host
    code, no ptxas log) and parse cuobjdump -sass of it."""
    nvcc = cs._nvcc()
    drop = {"-shared", "-fPIC", "-Xcompiler", "-v", "-Xptxas"}
    flags = [f for f in cs.NVCC_FLAGS if f not in drop]
    cubin = cs.BUILD_DIR / "coarse_scan.cubin"
    cubin.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([nvcc, *flags, "-cubin", "-o", str(cubin),
                    str(cs.SOURCE)], check=True, capture_output=True,
                   text=True)
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(nvcc), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(cubin)], check=True,
                         capture_output=True, text=True).stdout
    return {"flags": flags, "kernels": parse_sass(out)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", nargs="?", help="root of the other checkout")
    ap.add_argument("--log", help="a chip_smoke.py log: time its path shapes")
    ap.add_argument("--out", default="build/scan_ab.json")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--sass", action="store_true",
                    help="count the kernel's SASS instructions instead")
    ap.add_argument("--variants", action="store_true",
                    help="time the deformable float32 form's diagnostic "
                         "builds too")
    args = ap.parse_args()

    if args.sass:
        from svsdf_tpu_torch.ops import cuda_svsdf as this
        report = sass_report(this)
        for body, k in report["kernels"].items():
            print("[sass] " + json.dumps(
                {"body": body, "instructions": k["instructions"],
                 "per_pose": k["per_pose"],
                 "mufu_per_pose": k["mufu_per_pose"],
                 "loops": [{key: lp[key] for key in ("instructions", "ops")}
                           for lp in k["loops"][:3]]}), flush=True)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        return 0
    if args.other is None and not args.variants:
        ap.error("give OTHER_TREE, --variants or both (or --sass)")

    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("scan_ab.py needs a CUDA card")
    from svsdf_tpu_torch.models import shapes
    from svsdf_tpu_torch.ops import cuda_svsdf as this

    builds = {"this": this}
    if args.other is not None:
        other = load_other(args.other)
        if os.path.samefile(other.SOURCE, this.SOURCE):
            raise ValueError("the other tree is this tree")
        builds = {"other": other, **builds}
    if args.variants:
        builds.update((name, variant_module(name)) for name in VARIANTS)
    with ThreadPoolExecutor(len(builds)) as pool:      # one nvcc a build
        list(pool.map(lambda mod: mod.build(), builds.values()))
    card = smoke.smi_line()
    variants = variant_rows(torch, builds, args.reps) if args.variants \
        else []
    if args.other is None:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"summary": {"card": card}, "variants": variants}, f,
                      indent=1)
        print(card, flush=True)
        return 0
    # the deformable scenarios' robots by body, for the scaled forms
    robots = deformable_robots()
    table_shapes = (smoke.MAIN_SHAPES + smoke.E2E_SHAPES
                    + smoke.PLANNER_SHAPES + (smoke.GRID_SHAPE,))
    bodies = tuple(shapes.shape_names()) + ("Polygon",)
    sweep = (smoke.BODY_TIME_SHAPE, smoke.GRID_SHAPE)
    cases = []
    for form in ("float32", "bfloat16"):
        cases += [("sdHeart", form, *sh) for sh in table_shapes]
        cases += [(name, form, *smoke.BODY_TIME_SHAPE) for name in bodies]
    cases += [(name, form, *smoke.BODY_TIME_SHAPE) for name in robots
              for form in ("scaled_float32", "scaled_bfloat16")]
    cases += [(name, "scaled_float32", *sh) for name in robots
              for sh in smoke.PLANNER_SHAPES]
    if args.log:
        cases += shapes_from_log(args.log)
    cases = list(dict.fromkeys(cases))            # first seen, once each

    rows = []
    for i, (name, form, b, m, k) in enumerate(cases):
        scaled, bf16 = form.startswith("scaled"), form.endswith("bfloat16")
        shape = robots[name] if scaled else shapes.make_shape(name)
        dt = "bfloat16" if bf16 else None
        inp = smoke.scan_inputs(torch, b, m, k, seed=7000 + i)
        ts = smoke.pose_times(torch, b, k, seed=7000 + i)
        kw = dict(scan_dtype=dt, ts=ts)
        for mod in (other, this):
            smoke.compare_scan(torch, mod, shape, inp, 1e-5, dt, ts)
        turns = {}
        for label, mod in (("other", other), ("this", this), ("this", this),
                           ("other", other)):
            ms, _ = smoke.device_ms(
                torch, lambda: mod.coarse_scan(shape, *inp, **kw),
                reps=args.reps)
            if ms is None:
                raise RuntimeError("torch.profiler saw no device time")
            turns.setdefault(label, []).append(ms)
        by_lanes = {}
        if name == "sdHeart" and not scaled and (b, m, k) in sweep:
            lanes = [s for s in (1, 2, 4, 8, 16, 32) if s <= k]
            for s in lanes + lanes[::-1]:
                geo = this.block_shape(b, m, s)
                by_lanes.setdefault(s, []).append(smoke.device_ms(
                    torch, lambda: this.launch(shape, *inp, s, *geo,
                                               bf16=bf16),
                    reps=args.reps)[0])
        bound, by = smoke.scan_bound_ms(shape, b, m, k, bf16=bf16)
        row = {"shape": name, "form": form, "B": b, "M": m, "K": k,
               "geometry": this.launch_geometry(b, m, k),
               "other_ms": turns["other"], "this_ms": turns["this"],
               "speedup": statistics.median(turns["other"])
               / statistics.median(turns["this"]),
               "slower_beyond_spread": min(turns["this"])
               > max(turns["other"]),
               "bound_ms": bound, "bound_by": by,
               "this_share_of_bound": bound
               / statistics.median(turns["this"]),
               "this_ms_by_lanes": by_lanes, "bitwise": True}
        rows.append(row)
        print("[ab] " + json.dumps(row), flush=True)
    slower = [f"{r['shape']} {r['form']} {r['B']}x{r['M']}x{r['K']}"
              for r in rows if r["slower_beyond_spread"]]
    summary = {"shapes": len(rows), "slower_beyond_spread": slower,
               "speedup_min": min(r["speedup"] for r in rows),
               "speedup_max": max(r["speedup"] for r in rows),
               "card": card}
    print("[ab_summary] " + json.dumps(summary), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"summary": summary, "rows": rows, "variants": variants},
                  f, indent=1)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
