#!/usr/bin/env python3
"""Time this tree's coarse-scan grid body (a mesh robot's scan) in turns
on one NVIDIA card: against another tree's, and against diagnostic builds
of its own source that show which part of it sets its time.

    python3 grid_ab.py [OTHER_TREE] [--variants] [--out FILE] [--reps N]

scan_ab.py makes its shapes by name (``models/shapes.py make_shape``),
which knows no mesh robot; this script builds chip_smoke.py's mesh robots
(``MESH_ROBOTS``: the sdHeart prism and the r = 1.0 cylinder, written by
``bench.write_prism_obj`` and read by this tree's ``shape_from_mesh``)
and hands the same shape to every build. The builds:

  * ``this``: this tree's kernel;
  * ``other``: OTHER_TREE's, a second checkout of the repository (for
    instance the parent commit unpacked with ``git archive`` into a
    git-ignored directory), whose ``svsdf_tpu_torch/ops/cuda_svsdf.py``
    builds its own kernel into its own ``build/kernels/``;
  * with ``--variants``, this tree's source edited as text, each into
    ``build/grid_variants/<name>/`` (a variant is a measurement, not a
    kernel):
      - ``one_record``: every lane reads corner record 0 (the same
        instructions, one cache line): the most that any faster read of
        the grid, such as staging it in shared memory, could gain;
      - ``no_root``: the distance term without its square root (step *
        d2): the roots' share of the time;
      - ``ieee_root``: the roots as sqrt.rn (its slow-path branch
        included): what the branch-free ``root_rn`` saves;
      - ``fp32_floor``: the floor index without the conversion pipe (x +
        2^23 rounded toward -inf is 2^23 + floor(x); its bits less 2^23's
        are the int, the sum less 2^23 the float; exact under 2^23 cells
        a side): what cvt.rmi and its way back cost;
      - ``unroll8``: the scan loop unrolled by 8 poses, not 4: what more
        reads in flight would gain;
      - ``l2_only``: the records read through L2 only (ld.global.cg):
        what the L1 cache gives.

The cases: each robot in float32 and bfloat16 at chip_smoke.py's
``GRID_BODY_SHAPES`` (the prism batch's 512x64x96 and 512x64x128, the
grid query's 1x65536x256). At each, every build that computes the plain
version's function (all but ``one_record`` and ``no_root``) is first held
bit for bit against the plain version on seeded inputs, then each build's
device time per launch is read with torch.profiler, the builds in order
and then in reverse (other, this, ..., this, other). Prints one JSON line
per case, a summary line and the card's name and power limit; writes all
of it to ``--out`` as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import chip_smoke as smoke
from scan_ab import build_variant, load_other

#: (source text, replacement) edits of each diagnostic build
VARIANTS = {
    "one_record": (
        ("return __ldg(g.records + (unsigned)(ix * g.ry + iy));",
         "return __ldg(g.records + (unsigned)(ix * g.ry + iy)"
         " * (unsigned)(g.step < 0.0f));"),),
    "no_root": (
        ("return v + g.step * (d2 > 0.0f ? root_rn(d2) : 0.0f);",
         "return v + g.step * d2;"),
        ("const Bf2 out = Bf2(g.step) * sel(d2 > zero, root_rn(d2), zero);",
         "const Bf2 out = Bf2(g.step) * d2;")),
    "ieee_root": (
        ("return v + g.step * (d2 > 0.0f ? root_rn(d2) : 0.0f);",
         "return v + g.step * safe_sqrt(d2);"),
        ("const Bf2 out = Bf2(g.step) * sel(d2 > zero, root_rn(d2), zero);",
         "const Bf2 out = Bf2(g.step) * safe_sqrt(d2);")),
    "fp32_floor": (
        ("""  i = __float2int_rd(x);
  return (float)i;""",
         """  float s;
  asm("add.rm.f32 %0, %1, 0f4B000000;" : "=f"(s) : "f"(fmaxf(x, 0.0f)));
  i = __float_as_int(s) - 0x4b000000;
  return s - 8388608.0f;"""),),
    "unroll8": (
        ("""    for (; k + 3 * lanes < K; k += 4 * lanes, r += 2 * lanes) {""",
         """    for (; k + 7 * lanes < K; k += 8 * lanes, r += 4 * lanes) {
      float2 fv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) fv[u] = f(r + u * lanes);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        take(fv[u].x, k + 2 * u * lanes, best, arg);
        take(fv[u].y, k + (2 * u + 1) * lanes, best, arg);
      }
    }
    for (; k + 3 * lanes < K; k += 4 * lanes, r += 2 * lanes) {"""),
        ("""    for (; k + 3 * lanes < K; k += 4 * lanes) {""",
         """    for (; k + 7 * lanes < K; k += 8 * lanes) {
      float fv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) fv[u] = f(k + u * lanes);
#pragma unroll
      for (int u = 0; u < 8; ++u) take(fv[u], k + u * lanes, best, arg);
    }
    for (; k + 3 * lanes < K; k += 4 * lanes) {""")),
    "l2_only": (
        ("return __ldg(g.records + (unsigned)(ix * g.ry + iy));",
         "return __ldcg(g.records + (unsigned)(ix * g.ry + iy));"),),
}
#: the diagnostic builds that compute another function than the plain
#: version's
INEXACT = ("one_record", "no_root")


def variant_module(name: str):
    """This tree's cuda_svsdf module, under its own name, building the
    variant's source into build/grid_variants/<name>/."""
    return build_variant(f"grid_variant_{name}", VARIANTS[name],
                         f"grid_variants/{name}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", nargs="?", help="root of the other checkout")
    ap.add_argument("--variants", action="store_true",
                    help="time the diagnostic builds too")
    ap.add_argument("--out", default="build/grid_ab.json")
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    if args.other is None and not args.variants:
        ap.error("give OTHER_TREE, --variants or both")

    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("grid_ab.py needs a CUDA card")
    from svsdf_tpu_torch.bench import write_prism_obj
    from svsdf_tpu_torch.models import mesh_sdf
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
    tmp = tempfile.TemporaryDirectory()
    robots = {key: mesh_sdf.shape_from_mesh(write_prism_obj(
        body, os.path.join(tmp.name, f"{key}.obj"), extent=extent))
        for key, (body, extent) in smoke.MESH_ROBOTS.items()}
    rows = []
    for i, (key, dt, (b, m, k)) in enumerate(
            (key, dt, sh) for key in robots for dt in (None, "bfloat16")
            for sh in smoke.GRID_BODY_SHAPES):
        shape = robots[key]
        inp = smoke.scan_inputs(torch, b, m, k, seed=8000 + i)
        for name, mod in builds.items():
            if name not in INEXACT:
                smoke.compare_scan(torch, mod, shape, inp, 1e-5, dt)
        ms = {}
        for order in (list(builds), list(builds)[::-1]):
            for name in order:
                mod = builds[name]
                t, _ = smoke.device_ms(
                    torch, lambda: mod.coarse_scan(shape, *inp,
                                                   scan_dtype=dt),
                    reps=args.reps)
                if t is None:
                    raise RuntimeError("torch.profiler saw no device time")
                ms.setdefault(name, []).append(t)
        bound, by = smoke.scan_bound_ms(shape, b, m, k, bf16=dt is not None)
        med = {name: statistics.median(v) for name, v in ms.items()}
        row = {"robot": key, "grid": f"{shape.grid.nx}x{shape.grid.ny}",
               "form": "grid_" + smoke.form_of(this, shape, dt),
               "B": b, "M": m, "K": k,
               "geometry": this.launch_geometry(b, m, k), "ms": ms,
               "bound_ms": bound, "bound_by": by,
               "share_of_bound": {name: bound / v for name, v in med.items()}}
        if "other" in ms:
            row["speedup"] = med["other"] / med["this"]
            row["slower_beyond_spread"] = min(ms["this"]) > max(ms["other"])
        rows.append(row)
        print("[grid_ab] " + json.dumps(row), flush=True)
    tmp.cleanup()
    summary = {"cases": len(rows), "builds": list(builds), "card": card}
    if args.other is not None:
        summary.update(
            slower_beyond_spread=[
                f"{r['robot']} {r['form']} {r['B']}x{r['M']}x{r['K']}"
                for r in rows if r["slower_beyond_spread"]],
            speedup_min=min(r["speedup"] for r in rows),
            speedup_max=max(r["speedup"] for r in rows))
    print("[grid_ab_summary] " + json.dumps(summary), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"summary": summary, "rows": rows}, f, indent=1)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
