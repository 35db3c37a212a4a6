#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (svsdf_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each (any failure raises and the exit code is not 0):
  1. environment: torch / CUDA versions, the card's name and power limit;
  2. build: compiles svsdf_tpu_torch/csrc/coarse_scan.cu into
     build/kernels/ with nvcc (sm_90a), and beside it (a second nvcc,
     started together) scan_ab.py's ``floor`` build of the same source
     into build/scan_variants/floor/, which phase 3 times and the package
     never loads, and svsdf_tpu_torch/csrc/minco_cr.cu (the MINCO CR
     kernels, a third nvcc); then holds the grid body's branch-free
     square roots
     against the correctly rounded root at every positive float32 and
     bfloat16 input (grid_roots: no mismatch), and the deformable float32
     form's division by a pose's scale against the IEEE quotient at every
     float32 dividend of 4096 divisors (scale_division: no mismatch);
  3. kernel vs plain: the coarse-scan kernel against its plain PyTorch
     version on the card, on the parity cases of the JAX package's
     tests/test_pallas_svsdf.py for every shape body (the 17 analytic
     shapes, Polygon and the grid body of the two mesh robots of phase
     14, the grid body also on points in the grid's edge cells, where
     the bfloat16 clip reaches the last cell, and past the grid), in
     float32 and in the bfloat16 form, and the
     deformable form (a ScaledShape: each pose at its own scale) for
     sdHeart, sdRhombus and star in both scan types; then timed at the
     main and e2e paths' shapes, the single plan's (1x768x128,
     1x512x128), the grid query's (1x65536x256) and every body at
     512x64x96, and sdHeart's bfloat16, deformable and deformable
     bfloat16 forms at 512x64x96 and its bfloat16 form at the grid
     shape, the deformable float32 form with each deformable scenario's
     robot (sdHeart, sdRhombus, star) at 512x64x96 and the single plan's
     shapes, with the floor build's time at the single plan's shapes (the
     least a launch of that shape takes: scaled_scan_times), and the
     grid body (the sdHeart prism) in both forms at 512x64x96, 512x64x128
     and the grid shape (grid_body_times: each with its launch geometry,
     the corner records' size): the kernel's device time
     (torch.profiler) and the wrapper's
     and the plain version's time per call (CUDA events), printed in the
     kernel table's JSON line; the launch geometry of each timed shape
     and the bound's basis on lines of their own;
  3b. the MINCO CR kernels (ops/cuda_minco.py): the forward solve and
     the backward (transposed solve and band gradient) at the staged
     path's shapes (16384 and 65536 plans x N = 8 x D = 3, float32),
     each against block_cr's plain version, then timed by CUDA events
     beside its byte and operation bounds (cuda_minco.work), the plain
     version's time and the library's (torch.linalg.solve of the dense
     system) (minco_cr_times, one line each);
  4. main path: the bench's plans section in this process
     (svsdf_tpu_torch.bench.plans_run, B=512 only): plan_batch_staged at
     n=8, M=64, sdHeart, PlannerConfig(mem_size=8), first at
     default_stages(40) — the JAX package's bench.py configuration, whose
     scans run in bfloat16 — then at default_stages(40, scan_dtype=None)
     (float32 scans): each one warm-up, then 3 timed runs on perturbed
     inputs, each closed by a host readback, plans/s, the median cost
     and its re-score on bench.HIFI; each form's launch count over its
     run must be > 0. Then the bench's plans_profile section: one more
     solve of each under torch.profiler, the device's busy share and the
     kernels that fill it;
  5. checks: the same solve at B=32 with the kernel and with the plain
     scan on the card (median final cost within 1e-3 relative), and one
     cost/gradient evaluation on the card (float32) against the host
     (float64);
  6. batched end to end: the bench's e2e section in this process
     (svsdf_tpu_torch.bench.bench_e2e): plan_batch_e2e on the forest
     map, sdHeart, B=512, n=8, 48 obstacles, default_stages(40):
     bfloat16 scans, 2-D front end, no refine rounds — one warm-up, then
     3 timed runs on fresh start/goal draws, each closed by a host
     readback (every front end must reach its goal), then the front end
     timed alone against a whole run. Then one run under torch.profiler.
     The float32 variant (scan_dtype=None) follows, the same section;
  7. online replanning: OnlineReplanner on each synthetic scenario with
     its default stages (default_stages_lowlat(50): bfloat16 scans; 3-D
     front end, route shaping, 2 certify-refine rounds), one replan each
     (must succeed), and 3 jittered replans on synthetic_sdTrapezoid for
     the p50; then the JAX package's product operating point
     (bench.py::_real_replan: n_pieces=12, n_obs=160, default_stages(80),
     14 refine rounds, tightness 8) on the forest map with sdHeart, one
     replan and 3 jittered ones. Each replan prints its certify-refine
     re-solves (L-BFGS solves past the staged ones);
  8. checks of the new paths: plan_batch_e2e at B=32 with 2 refine
     rounds and the 3-D front end, and one synthetic_Polygon replan, each
     with the kernel and with the plain scan (cost and certificate within
     1e-3 relative); feasibility_maps on the card against the host;
  9. the single-plan pipeline: Planner.plan with its defaults (100 mid-end
     and 200 back-end iterations, 2 certify rounds, 3 retries, float32) on
     each synthetic scenario at scripts/run_scenarios.py's SVSDF settings,
     a first plan, and on Circle a warm one on the same planner; each
     must succeed, certify, end at the goal and pass
     tests/test_golden_scenarios.py's cost gate
     (0.3x to 1.5x) against the JAX package's row of scenario_results.json,
     printed beside it (cost and certificate; its times were taken on a
     TPU or a CPU). Then one Circle plan under torch.profiler;
 10. the ten bodies without a scenario (sdUnevenCapsule, star, sdTunnel,
     sdCutDisk, sdRhombus, sdHorseshoe, sdRoundedCross, sdOrientedVesica,
     sdPie, sdPie2) on a path: one plan_batch_staged solve each at B=32
     (bench problem(8, 64, 32), default_stages(40, scan_dtype=None)), each
     with a finite median cost;
 11. the grid query, the bench's grid section in this process
     (svsdf_tpu_torch.bench.bench_grid_queries): svsdf_grid
     of sdHeart along the 6-piece MINCO trajectory (bench.grid_setup) on
     256 x 256 points, SVSDFConfig(coarse_n=256, refine_rounds=3),
     with_inside=False; 8 batches a run, each with its axes perturbed by
     U(-0.1, 0.1), one warm-up, 3 timed runs closed by a host readback:
     queries/s, then one run under torch.profiler (the scan's share of
     the device time), and the field against the host's float64 plain
     run (limit 1e-3 m);
 12. deformable robots: Planner.plan with shape=sc.shape (a ScaledShape)
     on the three deformable scenarios at scripts/run_scenarios.py's
     SVSDF settings, each gated as in phase 9 against its
     scenario_results.json row, the certificate printed beside the
     row's, and the deformable form timed at each shape those plans
     launched it at (deformable_scan_times: launches x (ms - bound));
     then each deformable robot through one plan_batch_staged
     solve at B=32 with default_stages(40) (the deformable bfloat16
     form);
 13. the LMBM back end: Planner(solver="lmbm") on synthetic_Circle (its
     back end runs), gated as in phase 9;
 14. mesh robots (models/mesh_sdf.py, the kernel's grid body): (a) the
     sdHeart prism and the r = 1.0 cylinder written as .obj files
     (bench.py write_prism_obj) into a temporary directory and read by
     shape_from_mesh before phase 3 (grid size, bytes, host seconds);
     (c) plan_batch_staged with the sdHeart prism at phase 4's setting,
     default_stages(40) (bfloat16 scans) then float32, one warm-up and 3
     timed runs (the float32 variant 1) closed by a host readback
     (plans/s, median cost beside phase 4's analytic sdHeart), each
     form's launch count > 0,
     then the B=32 solve with the kernel and with the plain scan on the
     card (median cost within 1e-3 relative); (d) Planner.plan with the
     cylinder (config inputdata: its .obj) on synthetic_Circle's map at
     scripts/run_scenarios.py's SVSDF settings, gated as in phase 9,
     beside phase 9's analytic Circle plan, then the cylinder's
     OnlineReplanner replan on the same map with the kernel and with the
     plain scan (cost and certificate within 1e-3 relative); (e) the grid
     query of phase
     11 with the sdHeart prism (queries/s; the field within 1e-3 m of the
     host's float64 plain run); (f) the 3-D swept volume of (d)'s plan:
     the cylinder's volumetric grid (grid_sdf_3d, resolution 0.15,
     margin 1.0), the swept field on the card (eps 0.25, 128 poses)
     against the host's (within 1e-5 m), marching tetrahedra, a
     watertight mesh, written to chiprun_out/;
 15. the deployment loop (deployment_loop): (a) one replan with phase 7's
     synthetic_sdTrapezoid replanner, then a live back-end solve from its
     trajectory under the live dashboard (chiprun_out/live.html), one
     opti_cost entry an iteration run; (b) the trajectory through the
     PolyTraj JSON (coefficients bit for bit), a MincoTraj of the live
     solve's parameters re-solved on the card (positions within 1e-5 m
     of the live solve's trajectory over 200 times; the same round trip
     from parameters read back off the replanned trajectory is reported
     for the kernel, the plain version and a float64 solve, unlimited)
     and a plan checkpoint (bit for bit); (c) sample_commands and odom_from_commands
     on the card against a host float64 run of the same trajectory
     (within 1e-5 of max(1, |value|); yaw and yaw_rate * dt within 1e-4
     rad), fly against the host's float64 flight (positions within 1e-4
     m), the launches a tick and a flight's own from device traces of
     the flight's first 5 and 10 ticks (the second into chiprun_out/),
     then phase 4's last bfloat16 trajectories (B=512) flown in lockstep,
     each lane's tracking error finite; (d) render_depth_batch at the
     reference camera at 16 poses along the flight, of the scenario's map
     cloud, and at 16 poses along phase 7's forest replan, of the forest
     map (56,412 points), each against the host's render (the same pixels
     set but for 0.1% on a rounding boundary, each depth equal); (e) the
     synthetic_Circle Planner, and the reference-size sdHeart Planner on
     the forest map with its fine-yaw planners (18, 36 and 72 yaw bins),
     each built in-process only, then cold and warm on a fresh memo
     directory (kernels, stencils and feasibility equal to the bit); (f)
     each step a profiling.stage, and PROFILE.report();
 16. the host runtime and multi-process planning: (a) the C++ host
     runtime (svsdf_tpu_torch/csrc/runtime.cpp) built with g++ into
     build/kernels/ (runtime_build: seconds, available, which must be
     true); A* natively and in Python on the maps of phase 9's five
     synthetic Planners and the reference-size forest Planner (sdHeart,
     21x21 kernels, 18 yaw bins) at every guard of their ladders, the
     same cells, bins and expansions (runtime_astar: ms of each route);
     phase 7's forest cloud voxelized natively and with numpy, marching
     squares of phase 11's field natively and in Python, esdf2d against
     ops/esdf.py on the card (runtime_host_loops); (b) generate_path of
     every Planner of phases 9, 12, 13 and 14d (which plan with native A*
     by default) natively and with the Python loop, the same result
     (runtime_planner_front: the seconds of each); (c) sharded_plan_batch
     on phase 4's problem at default_stages(40)'s fast stage (bfloat16,
     K=96, 40 iterations, 2 line-search steps) in two-rank gloo worlds
     with both ranks on the card (parallel/local_world.py, a time limit
     after which every rank is killed) at mesh (2, 1) and (1, 2), and
     sharded_plan_batch_e2e at (2, 1) on phase 6's forest problem, and at
     (1, 2) the solve again at tests/test_parallel.py's setting (float32,
     15 iterations, 4 line-search steps), each against the same call in
     this process (sharded_single_process, with each solve's median moved
     by one ulp of x0 beside): (2, 1) no all_reduce and the solve's every
     lane to the bit, the e2e run's front end and median cost within 2e-3
     (the card's torch.cumsum sums a long row in another order at another
     row count, so lanes move); (1, 2) the first evaluation within 1e-6,
     as many all_reduce calls on each rank and the same results on both,
     and at tests/test_parallel.py's setting the median cost within 2e-3
     (sharded: wall s of each rank, plans/s, all_reduce calls a solve,
     the medians and the lanes within 2e-3), rank 0's kernel held bit for
     bit at every shape it launched (path_scans); (d)
     sharded_value_and_grad at mesh (1, 1) in an NCCL world of one rank,
     equal to make_cost_fn and its gradient to the bit, and an NCCL
     all_reduce of them (sharded_nccl).
The disk memo's root is a fresh temporary directory for the whole run.
Every line carries elapsed_s, the seconds since the script started.
Phase 3's parity cases cover every body, the ten of phase 10 included,
each bit for bit, and time each body at 512x64x96 against its bound.
The coarse-scan launches are counted over each path (phases 4, 6, 7, 9,
each solve of 10, 11, 12, 13, each path of 14 and 15, each rank's run of
16) from 0, in all and by
form, and after
each path the kernel is held bit for bit against its plain version, on
seeded inputs (and seeded pose times for a deformable robot), at every
shape, form and (B, M, K) that path launched it at. The same lines
(path_scans) give the MINCO CR kernels' launches on the path, from their
counter by direction and by (direction, dtype, BxNxD), and hold each
kernel against block_cr's plain version at every such shape. Then the
kernel table as one JSON line (one entry a form, and one for each form
of the grid body), the MINCO CR kernels' line (their times and launches
by path), the nvidia-smi line, and as the last line {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
import statistics
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

from svsdf_tpu_torch.bench import (KERNEL_NAME, device_events, profile_solve,
                                   smi_line)
from svsdf_tpu_torch.ops import block_cr, cuda_minco

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

#: H100 SXM peaks: HBM bytes/s (NVIDIA H100 datasheet), and float32
#: operations issued per second outside the tensor cores: 132 SMs x 128
#: lanes x 1.98 GHz. The datasheet's 67e12 float32 FLOP/s counts each
#: fused multiply-add as two operations; the kernel is built with
#: -fmad=false, so no multiply pairs with an add and every operation the
#: bound counts issues alone
HBM_BYTES_PER_S = 3.35e12
ISSUED_FP32_OPS_PER_S = 33.5e12
#: bfloat16 operations outside the tensor cores: packed __nv_bfloat162
#: instructions carry two a lane at the float32 issue rate (the bfloat16
#: form's work is the same function; the least time counts it packed)
ISSUED_BF16_OPS_PER_S = 2 * ISSUED_FP32_OPS_PER_S
#: the deformable form's operations per evaluation past the body's: the
#: two divisions q / s and the product s * body
OPS_SCALED = 3

#: operations per SDF evaluation of the coarse-scan kernel, counted
#: from csrc/coarse_scan.cu (pose transform 11, running-min compare 1,
#: body: Circle 6, sdHeart 31, sdArc 20, sdTrapezoid 36, sdRoundedX and
#: bigX 15, sdMoon 35, sdUnevenCapsule 27, star 43, sdTunnel 29,
#: sdCutDisk 31, sdRhombus 31, sdHorseshoe 34, sdRoundedCross 32,
#: sdOrientedVesica 28, sdPie and sdPie2 30; sqrt, abs, min/max, compare
#: and select count one each). A Polygon of E edges: 27 per edge plus 8
#: (OPS_POLYGON).
OPS_PER_EVAL = {"Circle": 18, "sdHeart": 43, "sdArc": 32,
                "sdTrapezoid": 48, "sdRoundedX": 27, "bigX": 27,
                "sdMoon": 47, "sdUnevenCapsule": 39, "star": 55,
                "sdTunnel": 41, "sdCutDisk": 43, "sdRhombus": 43,
                "sdHorseshoe": 46, "sdRoundedCross": 44,
                "sdOrientedVesica": 40, "sdPie": 42, "sdPie2": 42}
OPS_POLYGON = (27, 8 + 12)
#: the grid body's (a mesh robot's) operations per evaluation: the
#: function's work as models/mesh_sdf.py GridSDF2D.sdf_xy states it, four
#: corners gathered at clamped indices; the kernel's corner records
#: (GridSDF2D.corner_records) do the clamps once a grid, which the bound
#: does not take as saved: it counts the function, not one
#: implementation's instructions. Grid coordinates 4,
#: clips 4, floors, indices and fractions 8, the corners' clamped indices
#: and addresses 16 and their four 4-byte gathers 4, the weights 6, the
#: bilinear sum 7, the overshoots 8, their squares and sum 7, the guarded
#: root, the step and the sum 5 (69); with the pose transform 11 and the
#: compare 1. OPS_GRID_BF16 of them are bfloat16 operations in the
#: bfloat16 form (the function's own types, as the plain version runs
#: them): the pose transform 11, coordinates 4, clips 4, floors and
#: fractions 4, weights 6, overshoots 8, squares and sum 7, the guarded
#: root and the step product 4. The rest are float32 or integer work at
#: the float32 rate: the int conversions 4, the corners' indices,
#: addresses and gathers 20, the products with the float32 field and
#: their sum 7, the last sum 1 and the compare of float32 values 1
OPS_GRID = 81
OPS_GRID_BF16 = 48
#: the pose transform's operations: a Polygon's bfloat16 form runs only
#: these in bfloat16 (the plain version promotes its edges to float32)
OPS_POSE = 11


def is_mesh(shape) -> bool:
    """Whether the kernel runs ``shape`` on its grid body."""
    from svsdf_tpu_torch.ops import cuda_svsdf as cs
    return cs.body_id(shape) == cs.GRID_BODY_ID


def ops_per_eval(shape) -> int:
    if shape.name == "Polygon":
        return OPS_POLYGON[0] * len(shape.vertices) + OPS_POLYGON[1]
    if is_mesh(shape):
        return OPS_GRID
    return OPS_PER_EVAL[shape.name]


def ops_by_type(shape, bf16: bool) -> tuple[int, int]:
    """(bfloat16, float32) operations per evaluation of ``shape``'s scan
    in the bfloat16 form if ``bf16``, else in float32: each counted at
    the type the function computes it in."""
    n = ops_per_eval(shape) + OPS_SCALED * int(shape.time_varying)
    if not bf16:
        return 0, n
    if is_mesh(shape):
        return OPS_GRID_BF16, n - OPS_GRID_BF16
    if shape.name == "Polygon":
        return OPS_POSE, n - OPS_POSE
    return n, 0


#: (B, M, K) of the main path's coarse scans, timed in phase 3: the fast
#: stage (K=96), the polish stage (K=128) and its three GSIP rounds on
#: the 6 most interior points with 2, 6 and 18 boundary samples (K=32)
MAIN_SHAPES = ((512, 64, 96), (512, 64, 128), (512, 12, 32), (512, 36, 32),
               (512, 108, 32))
#: (B, M, K) of the end-to-end path's scans with 48 obstacles, timed in
#: phase 3: the fast stage, the polish stage, the certificate at K=192
E2E_SHAPES = ((512, 48, 96), (512, 48, 128), (512, 48, 192))
#: (B, M, K) of the single plan's scans, timed in phase 3: the back end on
#: 768 padded obstacles and the certificate on 512
PLANNER_SHAPES = ((1, 768, 128), (1, 512, 128))
#: (B, M, K) of the grid query's scan (phase 11), timed in phase 3
GRID_SHAPE = (1, 65536, 256)
#: (B, M, K) at which phase 3 times the grid body (the sdHeart prism) in
#: both forms: the prism batch's fast and polish stages (phase 14c) and
#: the grid query's scan (phase 14e)
GRID_BODY_SHAPES = ((512, 64, 96), (512, 64, 128), GRID_SHAPE)
#: the bodies phase 3 checks on its first parity cases; every other body
#: runs the same cases after them
FIRST_BODIES = ("sdHeart", "Circle", "sdArc")
#: the bodies without a synthetic scenario: phase 10 drives each through
#: a staged solve
STAGED_BODIES = ("sdUnevenCapsule", "star", "sdTunnel", "sdCutDisk",
                 "sdRhombus", "sdHorseshoe", "sdRoundedCross",
                 "sdOrientedVesica", "sdPie", "sdPie2")
#: (B, M, K) at which phase 3 times every body
BODY_TIME_SHAPE = (512, 64, 96)
#: scripts/run_scenarios.py's SVSDF settings, with which the JAX package
#: recorded scenario_results.json (gsip_fori is accepted and ignored)
RUN_SCENARIOS_SVS = dict(coarse_n=128, refine_rounds=2, gsip_iters=6,
                         gsip_coarse_n=64, gsip_refine_rounds=1,
                         gsip_topk=16, refine_interp_n=512, gsip_fori=True)
#: tests/test_golden_scenarios.py's cost gate against the recorded row:
#: lo * recorded < cost < hi * recorded
COST_GATE = (0.3, 1.5)
#: the mesh robots of phase 14: the analytic body whose zero contour is
#: extruded into a prism .obj, and the half-width of the contour's grid
MESH_ROBOTS = {"heart_prism": ("sdHeart", 6.0), "cylinder": ("Circle", 2.0)}
#: the export_swept_3d settings of scripts/run_scenarios.py: the robot's
#: volumetric grid (resolution, margin), the sweep's step and poses
SWEPT_3D = dict(resolution=0.15, margin=1.0, eps=0.25, n_t=128)


#: the script's start, on the host's clock
T_START = time.perf_counter()


def say(phase: str, **kv) -> None:
    """One line of a phase, with the seconds since the script started."""
    kv["elapsed_s"] = round(time.perf_counter() - T_START, 2)
    print(f"[{phase}] " + json.dumps(kv), flush=True)


def scan_inputs(torch, b, m, k, seed):
    """Points uniform in [-6, 6]^2 and a wiggly pose path per plan
    (tests/test_pallas_svsdf.py::_case, with a per-plan phase)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-6, 6, (b, m, 2))
    t = np.linspace(0.0, 1.0, k)[None]
    ph = rng.uniform(0, 1, (b, 1))
    xy = np.stack([8 * t - 4 + 0 * ph, 2 * np.sin(5 * t + ph)], -1)
    yaw = 2.0 * np.sin(3 * t + ph)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")
    yaw_t = f32(yaw)
    return f32(pts), f32(xy), torch.cos(yaw_t), torch.sin(yaw_t)


def pose_times(torch, b, k, seed):
    """Pose times of a plan's table, 0..T with T in [8, 16) per plan
    (a deformable robot's scale reads them)."""
    import numpy as np
    total = np.random.default_rng(seed).uniform(8.0, 16.0, (b, 1))
    ts = total * np.linspace(0.0, 1.0, k)[None]
    return torch.as_tensor(ts, dtype=torch.float32, device="cuda")


def compare_scan(torch, cs, shape, inputs, atol, scan_dtype=None, ts=None):
    """Kernel vs plain on the card: (max abs err, bitwise), in the form
    that ``scan_dtype`` and the shape give (the pose times ``ts`` feed a
    deformable robot's scales). The kernel's argmin must point at a pose
    whose reference value is the minimum within atol, and its neighbour
    values must be the reference's at that argmin -+ 1 (clipped). The
    kernel is built to agree with the plain version bit for bit, so any
    difference at all fails."""
    pts, xy, c, s = inputs
    mn_k, ar_k, fm_k, fp_k = cs.coarse_scan(shape, pts, xy, c, s,
                                            scan_dtype=scan_dtype, ts=ts)
    mn_r, ar_r, fm_r, fp_r = cs.coarse_scan_reference(
        shape, pts, xy, c, s, scan_dtype=scan_dtype, ts=ts)
    dt = cs.scan_type(scan_dtype)
    cast = (lambda v: v) if dt is None else (lambda v: v.to(dt))
    f_ref = cs.scan_matrix(shape, *map(cast, inputs),
                           cast(ts) if shape.time_varying else None
                           ).to(torch.float32)                # (B, M, K)
    torch.cuda.synchronize()
    k = f_ref.shape[-1]
    if not bool(((ar_k >= 0) & (ar_k < k)).all()):
        raise AssertionError(f"{shape.name}: argmin out of [0, {k})")
    at = lambda idx: torch.gather(f_ref, -1, idx[..., None])[..., 0]
    err = float((mn_k - mn_r).abs().max())
    arg_err = float((at(ar_k) - mn_r).abs().max())
    nerr = float(torch.maximum(
        (fm_k - at(torch.clamp(ar_k - 1, 0, k - 1))).abs().max(),
        (fp_k - at(torch.clamp(ar_k + 1, 0, k - 1))).abs().max()))
    if not err <= atol:
        raise AssertionError(f"{shape.name}: min differs by {err}")
    if not arg_err <= atol:
        raise AssertionError(f"{shape.name}: argmin off the minimum by "
                             f"{arg_err}")
    if not nerr <= atol:
        raise AssertionError(f"{shape.name}: neighbours differ by {nerr}")
    bitwise = bool(torch.equal(mn_k, mn_r) and torch.equal(ar_k, ar_r)
                   and torch.equal(fm_k, fm_r) and torch.equal(fp_k, fp_r))
    if not bitwise:
        raise AssertionError(f"{shape.name}: kernel and plain version are "
                             "not bit for bit equal")
    return max(err, arg_err, nerr), bitwise


def time_ms(torch, fn, reps=200):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(torch, fn, reps=50, tries=3):
    """torch.profiler over ``reps`` calls of ``fn``: (mean device time of
    one coarse-scan kernel launch in ms, launches seen). A session that
    saw no launch of the kernel is repeated, up to ``tries`` sessions;
    then (None, 0)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        scan = [us for name, us in device_events(prof)
                if KERNEL_NAME in name]
        if scan and sum(scan) > 0:
            return sum(scan) / len(scan) / 1e3, len(scan)
    return None, 0


def scan_bound_ms(shape, b, m, k, bf16=False):
    """Least time for the scan: bytes (points, poses (and a deformable
    robot's scales) read once; min, argmin (int64), two neighbours
    written once; a mesh robot's grid read once) over HBM rate vs
    operations over the issued rate of their type (``ops_by_type``).
    Returns (ms, 'bytes' | 'operations')."""
    scaled = shape.time_varying
    nbytes = (b * m * 2 * 4 + b * (4 + int(scaled)) * k * 4
              + b * m * (3 * 4 + 8))
    if is_mesh(shape):
        nbytes += shape.grid.field.nbytes
    n16, n32 = ops_by_type(shape, bf16)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = b * m * k * (n16 / ISSUED_BF16_OPS_PER_S
                         + n32 / ISSUED_FP32_OPS_PER_S) * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def form_of(cs, shape, scan_dtype):
    """The kernel form a launch of ``shape`` at ``scan_dtype`` runs."""
    import torch
    return cs.form(cs.scan_type(scan_dtype) == torch.bfloat16,
                   shape.time_varying)


def entry_of(cs, shape, scan_dtype):
    """The kernel table's entry a launch counts under: its form, or the
    grid body's entry of its form for a mesh robot."""
    fm = form_of(cs, shape, scan_dtype)
    return f"grid_{fm}" if is_mesh(shape) else fm


def grid_edge_inputs(torch, shape, b, m, k, seed):
    """Inputs that reach a mesh robot's grid edges: a fifth of the
    body-frame points in the last cells of x, a fifth of y (where the
    bfloat16 clip reaches n - 1 and the corner past it is read clamped),
    a fifth in the first cells, a fifth up to 4 m past the grid, the rest
    inside; poses near the identity."""
    import numpy as np
    g = shape.grid
    rng = np.random.default_rng(seed)
    lo = np.asarray([g.x0, g.y0])
    hi = lo + g.step * (np.asarray([g.nx, g.ny]) - 1)
    q = rng.uniform(lo, hi, (b, m, 2))
    band = lambda n: rng.uniform(0.0, 2.5 * g.step, (b, n))
    n5 = m // 5
    q[:, :n5, 0] = hi[0] - band(n5)
    q[:, n5:2 * n5, 1] = hi[1] - band(n5)
    q[:, 2 * n5:3 * n5, 0] = lo[0] + band(n5)
    q[:, 3 * n5:4 * n5] = rng.uniform(lo - 4, hi + 4, (b, n5, 2))
    c, s = math.cos(shape.yaw0), math.sin(shape.yaw0)
    pts = np.stack([c * q[..., 0] - s * q[..., 1] + shape.tx,
                    s * q[..., 0] + c * q[..., 1] + shape.ty], -1)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")
    yaw = f32(rng.uniform(-0.01, 0.01, (b, k)))
    return (f32(pts), f32(rng.uniform(-0.05, 0.05, (b, k, 2))),
            torch.cos(yaw), torch.sin(yaw))


class ShapeLog:
    """Records the shape, form and (B, M, K) of every kernel launch while
    active, by wrapping the wrapper's launch function (the count stays
    the wrapper's own); ``check`` then holds the kernel against its plain
    version at each of them, and ``worst`` keeps each form's largest
    error."""

    #: the largest error seen by any check, by form
    worst: dict = {}
    #: the MINCO CR kernels' launches of every checked path, by
    #: '<direction> <dtype> BxNxD'
    minco_by_path: dict = {}

    def __init__(self, cs):
        self.cs, self.seen, self.counts = cs, {}, {}
        self._orig = cs._launch
        self.minco = {}
        self._minco_orig = cuda_minco._launch

    def __enter__(self):
        def logged(shape, points, xy, cos, sin, scan_dtype=None, ts=None):
            key = (shape.name, shape.tx, shape.ty, shape.yaw0,
                   shape.vertices, form_of(self.cs, shape, scan_dtype),
                   points.shape[0], points.shape[1], xy.shape[1])
            self.seen.setdefault(key, (shape, scan_dtype))
            self.counts[key] = self.counts.get(key, 0) + 1
            return self._orig(shape, points, xy, cos, sin, scan_dtype, ts)

        def minco_logged(bands, rhs, xf, refine, transpose):
            key = ("forward" if xf is None else "backward",
                   str(bands.dtype).removeprefix("torch."), bands.shape[0],
                   bands.shape[1] // 6, rhs.shape[-1])
            self.minco[key] = self.minco.get(key, 0) + 1
            return self._minco_orig(bands, rhs, xf, refine, transpose)
        self.cs._launch = logged
        cuda_minco._launch = minco_logged
        self._minco_start = dict(cuda_minco.launches)
        return self

    def _stop(self):
        self.cs._launch = self._orig
        if cuda_minco._launch is not self._minco_orig:
            cuda_minco._launch = self._minco_orig
            self.minco_counter = {k: v - self._minco_start[k]
                                  for k, v in cuda_minco.launches.items()}

    def __exit__(self, *exc):
        self._stop()

    def minco_by_shape(self):
        """{'<direction> <dtype> BxNxD': MINCO CR launches}."""
        return {f"{k[0]} {k[1]} {k[2]}x{k[3]}x{k[4]}": v
                for k, v in sorted(self.minco.items())}

    def summary(self, form=None):
        """'<shape> <form> BxMxK' of every launch, of ``form`` only if
        given."""
        return sorted(self.by_shape(form))

    def by_shape(self, form=None):
        """{'<shape> <form> BxMxK': launches}, of ``form`` only if given."""
        out = {}
        for k, n in self.counts.items():
            if form in (None, k[5]):
                name = f"{k[0]} {k[5]} {k[6]}x{k[7]}x{k[8]}"
                out[name] = out.get(name, 0) + n
        return out

    def check(self, torch, path, seed):
        """Kernel vs plain, bit for bit, on seeded inputs at every shape,
        form and (B, M, K) the path launched; returns the largest
        error."""
        worst = 0.0
        for i, (key, (shape, scan_dtype)) in enumerate(self.seen.items()):
            b, m, k = key[6:]
            ts = pose_times(torch, b, k, seed + i)
            err, _ = compare_scan(torch, self.cs, shape,
                                  scan_inputs(torch, b, m, k, seed + i), 1e-5,
                                  scan_dtype, ts)
            worst = max(worst, err)
            entry = entry_of(self.cs, shape, scan_dtype)
            ShapeLog.worst[entry] = max(ShapeLog.worst.get(entry, 0.0), err)
        # the MINCO CR kernels at every (direction, dtype, B, N, D) the
        # path launched them at, against the plain version; the counter
        # must agree with the launches seen
        minco_err = 0.0
        for i, key in enumerate(sorted(self.minco)):
            minco_err = max(minco_err, minco_check(torch, *key, seed + i))
        seen = {dr: sum(v for k, v in self.minco.items() if k[0] == dr)
                for dr in ("forward", "backward")}
        if seen != self.minco_counter:
            raise AssertionError(f"{path}: MINCO CR launches {seen} seen, "
                                 f"{self.minco_counter} counted")
        ShapeLog.minco_by_path[path] = self.minco_by_shape()
        say("path_scans", path=path, cases=len(self.seen),
            shapes=self.summary(), launches=self.by_shape(),
            max_abs_err=worst, bitwise=True,
            minco_launches=self.minco_counter,
            minco_shapes=self.minco_by_shape(), minco_max_rel_err=minco_err)
        return worst


class SectionLog(ShapeLog):
    """A ShapeLog around one of the bench's sections (svsdf_tpu_torch.bench)
    that stops recording when the section reads its launch counts
    (bench._check_launched): it sees the launches the counts cover, the
    warm-up and the timed runs, and not the re-score's nor a profiled
    run's."""

    def __enter__(self):
        from svsdf_tpu_torch import bench
        super().__enter__()
        read = bench._check_launched

        def closing(*args):
            self._stop()
            return read(*args)
        self._patch = mock.patch.object(bench, "_check_launched", closing)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()
        super().__exit__(*exc)


def time_scan(torch, cs, shape, inp, scan_dtype, ts, bound):
    """One shape and form of the scan timed: the kernel's device time
    (profiler; where it saw none, the wrapper's time per call by CUDA
    events), the wrapper's and the plain version's, and the bound."""
    b, m = inp[0].shape[:2]
    k = inp[1].shape[1]
    kw = dict(scan_dtype=scan_dtype, ts=ts)
    wrapper = time_ms(torch, lambda: cs.coarse_scan(shape, *inp, **kw))
    kernel, seen = device_ms(torch, lambda: cs.coarse_scan(shape, *inp, **kw))
    plain = time_ms(torch, lambda: cs.coarse_scan_reference(shape, *inp,
                                                            **kw))
    return {"B": b, "M": m, "K": k,
            "ms": kernel if kernel is not None else wrapper,
            "ms_source": "profiler" if kernel is not None else "events",
            "wrapper_ms": wrapper, "profiled_launches": seen,
            "plain_ms": plain, "bound_ms": bound[0], "bound_by": bound[1]}


def excess(t, by_shape):
    """launches x (ms - bound) at the timed row ``t`` (time_scan): the
    launches of its body at its (B, M, K) from a path's counts by shape
    (ShapeLog.by_shape); with a measured floor, also against the bound
    that takes it (``bound_with_floor_ms``)."""
    n = sum(v for key, v in by_shape.items()
            if key.endswith(f" {t['B']}x{t['M']}x{t['K']}")
            and key.split()[0] == t["shape"])
    out = {"launches": n, "ms": n * (t["ms"] - t["bound_ms"])}
    if "bound_with_floor_ms" in t:
        out["ms_over_floor_bound"] = n * (t["ms"] - t["bound_with_floor_ms"])
    return out


def path_scan_times(torch, cs, log, seed):
    """Each shape, form and (B, M, K) a path launched (a ShapeLog) timed
    on seeded inputs (time_scan), with its launches on that path and
    launches x (ms - bound)."""
    rows = []
    for i, (key, (shape, dt)) in enumerate(log.seen.items()):
        b, m, k = key[6:]
        row = time_scan(torch, cs, shape,
                        scan_inputs(torch, b, m, k, seed + i), dt,
                        pose_times(torch, b, k, seed + i),
                        scan_bound_ms(shape, b, m, k, bf16=dt is not None))
        n = log.counts[key]
        rows.append(dict(row, shape=shape.name, form=key[5], launches=n,
                         launches_x_ms_over_bound=n * (row["ms"]
                                                       - row["bound_ms"])))
    return rows


def timed(torch, fn):
    """(result, wall seconds) with the device synchronised on both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def rel_diff(a, b):
    """max |a - b| / max(1, |b|) over the elements."""
    return float(((a - b).abs() / b.abs().clamp_min(1.0)).max())


#: (B, N, D) at which the MINCO CR kernels are timed, in float32: the
#: staged path's true costs (B = 16384) and frozen line searches (4B)
#: at N = 8 pieces, D = 3
MINCO_TIMED = ((16384, 8, 3), (65536, 8, 3))
#: H100 SXM float32 FLOP/s outside the tensor cores (datasheet; an FMA
#: counts two, as the MINCO kernels' operation counts do: they build
#: with FMA)
FP32_FLOPS = 67e12
#: the MINCO kernels against the plain version: relative to the plain
#: output's largest magnitude (both in the refined CR's accuracy class,
#: tests/test_torch_cuda_minco_cr.py)
MINCO_TOL = {"float32": 2e-5, "float64": 1e-12}


def minco_inputs(torch, b, n, d, dtype, seed):
    """MINCO's normalized-time system of B random plans (bands (B, 6N,
    13), rhs (B, 6N, D)) on the card, built in float64 and cast."""
    import numpy as np
    from svsdf_tpu_torch.ops import minco
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device="cuda")
    head = np.zeros((b, 3, d))
    head[:, 0] = rng.uniform(-1, 1, (b, d))
    head[:, 1] = rng.uniform(-0.5, 0.5, (b, d))
    tail = np.zeros((b, 3, d))
    tail[:, 0] = rng.uniform(5, 9, (b, d))
    bands, rhs = minco.build_bands_norm(
        t(rng.uniform(0.6, 2.0, (b, n))), t(head), t(tail),
        t(rng.uniform(0, 8, (b, n - 1, d))))
    return bands.to(dtype), rhs.to(dtype)


def minco_check(torch, direction, dtype, b, n, d, seed):
    """The MINCO CR kernel of one direction against block_cr's plain
    version on seeded inputs: the largest error over the plain outputs'
    largest magnitude; raises past MINCO_TOL."""
    dt = getattr(torch, dtype)
    bands, rhs = minco_inputs(torch, b, n, d, dt, seed)
    x = block_cr._cr_core(bands, rhs, block_cr.REFINE, False)
    if direction == "forward":
        pairs = [(cuda_minco.forward(bands, rhs, block_cr.REFINE), x)]
    else:
        xb = torch.randn(rhs.shape, dtype=dt, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(seed))
        pairs = zip(cuda_minco.backward(bands, x.contiguous(), xb,
                                        block_cr.REFINE),
                    block_cr.plain_backward(bands, x, xb))
    err = max(float((k - p).abs().max() / p.abs().max()) for k, p in pairs)
    if not err <= MINCO_TOL[dtype]:
        raise AssertionError(f"MINCO CR {direction} {dtype} {b}x{n}x{d}: "
                             f"{err} from the plain version")
    return err


def dense_of(torch, bands):
    """(B, 6N, 6N) matrix of band storage: row i, column i + d - 6."""
    b, n6, nd = bands.shape
    m = torch.zeros((b, n6, n6 + nd - 1), dtype=bands.dtype,
                    device=bands.device)
    idx = torch.arange(n6, device=bands.device)
    for dd in range(nd):
        m[:, idx, idx + dd] = bands[:, :, dd]
    return m[:, :, nd // 2:n6 + nd // 2]


def minco_phase(torch):
    """Both MINCO CR kernels at MINCO_TIMED in float32: each checked
    against the plain version, then timed (CUDA events) beside their
    byte and operation bounds, the plain version's time and the library's
    (torch.linalg.solve of the dense (B, 6N, 6N) system; backward: of its
    transpose, then the band gradient from the outer product)."""
    rows = []
    for b, n, d in MINCO_TIMED:
        bands, rhs = minco_inputs(torch, b, n, d, torch.float32, b)
        x = block_cr._cr_core(bands, rhs, block_cr.REFINE, False)
        x = x.contiguous()
        xb = torch.randn_like(rhs)
        m = dense_of(torch, bands)
        mt = m.transpose(-1, -2).contiguous()
        runs = {
            "forward": (lambda: cuda_minco.forward(bands, rhs,
                                                   block_cr.REFINE),
                        lambda: block_cr._cr_core(bands, rhs,
                                                  block_cr.REFINE, False),
                        lambda: torch.linalg.solve(m, rhs)),
            "backward": (lambda: cuda_minco.backward(bands, x, xb,
                                                     block_cr.REFINE),
                         lambda: block_cr.plain_backward(bands, x, xb),
                         lambda: block_cr.band_gradient(
                             torch.linalg.solve(mt, xb), x))}
        for direction, (kernel, plain, library) in runs.items():
            err = minco_check(torch, direction, "float32", b, n, d, b + 1)
            ops, nbytes = cuda_minco.work(n, d, block_cr.REFINE,
                                          direction == "backward")
            by_ops = b * ops / FP32_FLOPS * 1e3
            by_bytes = b * nbytes / HBM_BYTES_PER_S * 1e3
            ms = time_ms(torch, kernel, reps=50)
            rows.append(dict(
                direction=direction, B=b, N=n, D=d, dtype="float32", ms=ms,
                bound_ms=max(by_ops, by_bytes),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                ops_ms=by_ops, bytes_ms=by_bytes,
                plain_ms=time_ms(torch, plain, reps=5),
                library_ms=time_ms(torch, library, reps=5),
                geometry=cuda_minco.geometry(
                    torch.cuda.current_device(), n, d, torch.float32,
                    direction == "backward"),
                max_rel_err=err))
    return rows


#: phase 16's sharded solve: phase 4's problem at the fast stage of
#: default_stages(40) (bfloat16 scans, K=96), 40 iterations, 2 line-search
#: steps
SHARDED = dict(n=8, m_obs=64, batch=512, iters=40, ls=2)
#: the runs of each two-rank world's mesh: "solve" at SHARDED's settings,
#: "solve_jax" at tests/test_parallel.py:143-157's (float32 scans, 15
#: iterations, 4 line-search steps), "e2e" sharded_plan_batch_e2e
SHARDED_RUNS = {(2, 1): ("solve", "e2e"), (1, 2): ("solve", "solve_jax")}
#: the settings (scan type, iterations, line-search steps) of each solve
SOLVE_SETTINGS = {"solve": ("bfloat16", SHARDED["iters"], SHARDED["ls"]),
                  "solve_jax": (None, 15, 4)}
#: one rank's job, and every rank's, under one time limit (seconds)
RANK_TIMEOUT = 420


class CountAllReduce:
    """Counts torch.distributed.all_reduce calls while active."""

    def __init__(self):
        import torch.distributed as dist
        self.dist, self.calls = dist, 0

    def __enter__(self):
        self._orig = self.dist.all_reduce

        def counted(*a, **k):
            self.calls += 1
            return self._orig(*a, **k)
        self.dist.all_reduce = counted
        return self

    def __exit__(self, *exc):
        self.dist.all_reduce = self._orig


def sharded_inputs():
    """Phase 4's problem (numpy) and the sharded solve's settings."""
    from svsdf_tpu_torch.bench import BENCH_MEM_SIZE, problem
    from svsdf_tpu_torch.models import shapes
    from svsdf_tpu_torch.parallel import batch as pb
    from svsdf_tpu_torch.utils.config import PlannerConfig
    return (shapes.make_shape("sdHeart"), PlannerConfig(mem_size=BENCH_MEM_SIZE),
            pb.default_stages(SHARDED["iters"])[0][0],
            problem(SHARDED["n"], SHARDED["m_obs"], SHARDED["batch"]))


def e2e_inputs(e2e):
    """Phase 6's forest problem: seeded start/goal draws, its stages."""
    import numpy as np
    from svsdf_tpu_torch.bench import e2e_draws
    from svsdf_tpu_torch.parallel import batch as pb
    s, g = e2e_draws(e2e.cells, SHARDED["batch"], np.random.default_rng(16))
    return (s, g, pb.default_stages(SHARDED["iters"]), 8, 48,
            e2e.grid.resolution, e2e.grid.xyz_min[:2].astype(np.float32))


def solve_call(pb, mesh, name, inputs):
    """sharded_plan_batch at ``name``'s SOLVE_SETTINGS on ``mesh``:
    (its SVSDF stage, a call of the whole batch)."""
    import dataclasses
    heart, cfg, fast, (h, tl, obs, x0) = inputs
    dtype, iters, ls = SOLVE_SETTINGS[name]
    svs = dataclasses.replace(fast, scan_dtype=dtype)
    run = pb.sharded_plan_batch(heart, mesh, cfg, svs, SHARDED["n"], iters,
                                ls)
    return svs, lambda x=x0: run(x, h, tl, obs)


def sharded_rank(n_scn, n_obs, runs):
    """Phase 16 (c), one rank of a two-rank gloo world on the card (both
    ranks on cuda:0) at mesh (n_scn, n_obs): each of ``runs``, a solve
    (SOLVE_SETTINGS) of phase 4's problem after its first cost evaluation,
    or "e2e", sharded_plan_batch_e2e on phase 6's forest problem; each
    run's wall seconds, all_reduce calls and launches by form, its outputs
    gathered to numpy, and on rank 0 the kernel held against the plain
    scan at every shape the rank launched."""
    import torch
    import torch.distributed as dist
    from svsdf_tpu_torch.ops import cuda_svsdf as cs
    from svsdf_tpu_torch.parallel import batch as pb
    from svsdf_tpu_torch.parallel import multihost as mh

    inputs = sharded_inputs()
    heart, cfg, _, (h, tl, obs, x0) = inputs
    mesh = pb.make_mesh(n_scn, n_obs)
    out = {"rank": dist.get_rank(), "coords": mesh.coords}
    for i, name in enumerate(runs):
        if name == "e2e":
            from svsdf_tpu_torch.bench import e2e_setup
            setup = e2e_setup()
            s, g, stages, n_e, obs_e, res_e, xy_e = e2e_inputs(setup)
            run = pb.sharded_plan_batch_e2e(setup.shape, mesh, cfg, stages,
                                            n_e, obs_e, res_e, xy_e)
            call = lambda: run(setup.feas, setup.occ_pts, s, g)  # noqa: E731
            f0 = None
        else:
            svs, call = solve_call(pb, mesh, name, inputs)
            f0 = mh.fetch_global(pb.sharded_value_and_grad(
                heart, mesh, cfg, svs, SHARDED["n"])(x0, h, tl, obs)[0], mesh)
        mh.barrier()
        cs.reset_launches()
        with ShapeLog(cs) as log, CountAllReduce() as c:
            res, wall = timed(torch, call)
        row = {"wall_s": wall, "all_reduce": c.calls, "f0": f0,
               "form_launches": dict(cs.coarse_scan.form_launches),
               "shapes": log.summary()}
        fields = (res._asdict() if hasattr(res, "_asdict") else
                  dict(zip(("x", "cost", "iters", "converged"), res)))
        row.update({k: mh.fetch_global(v, mesh) for k, v in fields.items()})
        if dist.get_rank() == 0:
            row["max_abs_err"] = log.check(
                torch, f"sharded {name} {n_scn}x{n_obs}", 16000 + 100 * i)
            row["worst"] = dict(ShapeLog.worst)
        out[name] = row
    return out


def nccl_rank():
    """Phase 16 (d), a world of one rank on NCCL: sharded_value_and_grad at
    mesh (1, 1) against make_cost_fn and its gradient, and an NCCL
    all_reduce of them, each to the bit."""
    import torch
    import torch.distributed as dist
    from svsdf_tpu_torch import convert
    from svsdf_tpu_torch.parallel import batch as pb
    from svsdf_tpu_torch.planner import back_end
    from svsdf_tpu_torch.utils import lbfgs

    heart, cfg, fast, (h, tl, obs, x0) = sharded_inputs()
    mesh = pb.make_mesh(1, 1, device="cuda")
    f, g = pb.sharded_value_and_grad(heart, mesh, cfg, fast, SHARDED["n"])(
        x0, h, tl, obs)
    prob, x = convert.problem_from_numpy(h, tl, obs, x0)
    fr, gr = lbfgs.value_and_grad(back_end.make_cost_fn(
        heart, prob, cfg, fast, SHARDED["n"]))(x)
    buf = torch.cat([f[:, None], g], 1)
    red = buf.clone()
    dist.all_reduce(red)
    torch.cuda.synchronize()
    return {"backend": dist.get_backend(), "world": dist.get_world_size(),
            "f_equal": bool(torch.equal(f, fr)),
            "g_equal": bool(torch.equal(g, gr)),
            "all_reduce_equal": bool(torch.equal(red, buf))}


def same_segments(a, b, atol):
    """Whether two marching-squares outputs hold the same segments as
    unordered sets (a one-to-one nearest match, endpoints within atol)."""
    import numpy as np

    def canon(segs):
        rows = [np.concatenate([p, q] if tuple(p) <= tuple(q) else [q, p])
                for p, q in ((np.asarray(u, float), np.asarray(v, float))
                             for u, v in segs)]
        return np.asarray(rows).reshape(-1, 4)

    ca, cb = canon(a), canon(b)
    if ca.shape != cb.shape:
        return False, float("inf")
    worst, used = 0.0, set()
    order = np.lexsort(cb.T[::-1])
    cb_sorted = cb[order]
    for row in ca:
        # candidates near this row's first coordinate
        lo = np.searchsorted(cb_sorted[:, 0], row[0] - atol, "left")
        hi = np.searchsorted(cb_sorted[:, 0], row[0] + atol, "right")
        d = np.abs(cb_sorted[lo:hi] - row).max(-1) if hi > lo else []
        if not len(d):
            return False, float("inf")
        j = int(np.argmin(d))
        worst = max(worst, float(d[j]))
        used.add(lo + j)
    return len(used) == len(ca) and worst <= atol, worst


def runtime_phase(torch, astar_cases, forest_map, forest_ends, field_case):
    """Phase 16 (a) and (b): the C++ host runtime built and held against
    the host's Python and numpy versions, and the Planners of phases 9,
    12, 13 and 14d on native A* against the Python loop."""
    import numpy as np
    from svsdf_tpu_torch import native
    from svsdf_tpu_torch.ops import esdf as esdf_ops
    from svsdf_tpu_torch.planner import astar
    from svsdf_tpu_torch.planner.pipeline import Planner
    from svsdf_tpu_torch.utils.config import PlannerConfig
    from svsdf_tpu_torch.utils.gridmap import GridMap
    from svsdf_tpu_torch.viz import swept_surface as sw

    t0 = time.perf_counter()
    lib, log = native.build()
    build_s = time.perf_counter() - t0
    if not native.available():
        raise AssertionError(f"native runtime unavailable: "
                             f"{native.build_log()}")
    say("runtime_build", seconds=build_s, available=True,
        library=os.path.relpath(lib, ROOT), compiler_log=log.strip())

    def same(a, b):
        return (a.success == b.success and a.expansions == b.expansions
                and np.array_equal(a.path, b.path)
                and np.array_equal(a.yaw_bins, b.yaw_bins))

    def astar_both(label, grid, feas, trans, start, goal, k):
        args = (grid, feas, trans, np.asarray(start), np.asarray(goal), k)
        cc, cc_s = timed(torch, lambda: astar.search(*args, use_native=True))
        py, py_s = timed(torch, lambda: astar.search(*args,
                                                     use_native=False))
        if not same(cc, py):
            raise AssertionError(f"{label}: native A* differs from the "
                                 "Python loop")
        return dict(success=cc.success, cells=len(cc.path),
                    expansions=cc.expansions, native_ms=cc_s * 1e3,
                    python_ms=py_s * 1e3)

    # (a) A* on the five synthetic maps and the reference-size forest map
    rows = []
    planners = [(label, pl, sc.start, sc.goal) for label, pl, sc
                in astar_cases if label.startswith("synthetic_")]
    forest = Planner(PlannerConfig(), forest_map)
    planners.append(("forest_sdHeart", forest,
                     np.r_[forest_ends[0], 0.0], np.r_[forest_ends[1], 0.0]))
    for label, pl, start, goal in planners:
        for guard in pl.guard_ladder:
            rows.append(dict(map=label, kernel=int(pl._kernels.shape[-1]),
                             yaw_bins=int(pl.feas.shape[0]), guard=guard,
                             **astar_both(label, pl.grid, pl.feas,
                                          pl._trans_feas(guard), start, goal,
                                          pl.config.kernel_yaw_num)))
    say("runtime_astar", maps=len(planners), searches=rows)
    # voxelization of phase 7's forest cloud
    pts = np.asarray(forest_map, np.float64)
    g_cc, cc_s = timed(torch, lambda: GridMap.from_points(pts, 1.0, 1))
    with mock.patch.object(native, "available", lambda: False):
        g_py, py_s = timed(torch, lambda: GridMap.from_points(pts, 1.0, 1))
    if not np.array_equal(g_cc.occ, g_py.occ):
        raise AssertionError("native voxelization differs from numpy")
    # marching squares on the grid query's field (phase 11)
    xs, ys, field = field_case
    seg_cc, mcc_s = timed(torch, lambda: sw.marching_squares(xs, ys, field))
    with mock.patch.object(native, "available", lambda: False):
        seg_py, mpy_s = timed(torch, lambda: sw.marching_squares(xs, ys,
                                                                 field))
    seg_ok, seg_err = same_segments(seg_cc, seg_py, 1e-5)
    if not (seg_ok and len(seg_cc) > 0):
        raise AssertionError(f"native marching squares differs: "
                             f"{len(seg_cc)} vs {len(seg_py)}, {seg_err}")
    # the 2-D ESDF against ops/esdf.py on the card
    occ2d = g_cc.occ2d
    d_cc, ecc_s = timed(torch, lambda: native.esdf2d(occ2d, 1.0))
    d_dev, edev_s = timed(torch, lambda: esdf_ops.esdf(occ2d[..., None],
                                                       1.0)[..., 0])
    esdf_err = float(np.abs(d_cc - d_dev.cpu().numpy()).max())
    if not esdf_err <= 1e-4:
        raise AssertionError(f"native esdf2d vs ops/esdf.py {esdf_err}")
    say("runtime_host_loops", voxelize=dict(
            points=len(pts), grid=list(g_cc.occ.shape), equal=True,
            native_ms=cc_s * 1e3, numpy_ms=py_s * 1e3),
        marching_squares=dict(field=list(field.shape),
                              segments=len(seg_cc), same_segments=True,
                              max_endpoint_diff=seg_err,
                              native_ms=mcc_s * 1e3, python_ms=mpy_s * 1e3),
        esdf2d=dict(grid=list(occ2d.shape), max_abs_err_vs_card=esdf_err,
                    native_ms=ecc_s * 1e3, card_ms=edev_s * 1e3))

    # (b) the Planners of phases 9, 12, 13, 14d: native A* by default
    fronts = []
    for label, pl, sc in astar_cases:
        cc, cc_s = timed(torch, lambda: pl.generate_path(sc.start, sc.goal))
        with mock.patch.object(native, "available", lambda: False):
            py, py_s = timed(torch, lambda: pl.generate_path(sc.start,
                                                             sc.goal))
        if not same(cc, py):
            raise AssertionError(f"{label}: the Planner's native A* differs "
                                 "from the Python loop")
        fronts.append(dict(planner=label, front_native_s=cc_s,
                           front_python_s=py_s, cells=len(cc.path),
                           expansions=cc.expansions))
    say("runtime_planner_front", planners=fronts)
    return {"astar": rows, "fronts": fronts}


def sharded_phase(torch, e2e):
    """Phase 16 (c) and (d): the two-rank gloo worlds on the card against
    the same calls in this process, and NCCL in a world of one. Returns
    the worlds' launches by (path, form)."""
    import numpy as np
    from svsdf_tpu_torch.parallel import batch as pb
    from svsdf_tpu_torch.parallel import local_world

    inputs = sharded_inputs()
    heart, cfg, _, (h, tl, obs, x0) = inputs
    batch = SHARDED["batch"]
    mesh1 = pb.make_mesh(1, 1)
    # the same calls in one process on the same card, each run twice (a
    # warm-up), and the solves once more from x0 moved up by one ulp: how
    # far a rounding-sized change of the input moves each solve's median
    refs = {}
    for name in SOLVE_SETTINGS:
        svs, call = solve_call(pb, mesh1, name, inputs)
        f0 = pb.sharded_value_and_grad(heart, mesh1, cfg, svs, SHARDED["n"])(
            x0, h, tl, obs)[0].cpu()
        call()
        res, wall = timed(torch, call)
        ulp = call(np.nextafter(x0, np.float32(np.inf)))[1].cpu()
        cost = res[1].cpu()
        refs[name] = dict(f0=f0, cost=cost, x=res[0].cpu(), wall_s=wall,
                          ulp_median_rel=abs(float(ulp.median())
                                             - float(cost.median()))
                          / abs(float(cost.median())))
    s, g, stages, n_e, obs_e, res_e, xy_e = e2e_inputs(e2e)
    run_e2e = pb.sharded_plan_batch_e2e(e2e.shape, mesh1, cfg, stages, n_e,
                                        obs_e, res_e, xy_e)
    run_e2e(e2e.feas, e2e.occ_pts, s, g)
    res, wall = timed(torch, lambda: run_e2e(e2e.feas, e2e.occ_pts, s, g))
    refs["e2e"] = dict(f0=None, cost=res.cost.cpu(), x=res.x.cpu(),
                       front_ok=res.front_ok.cpu(), wall_s=wall,
                       ulp_median_rel=None)
    say("sharded_single_process", B=batch, runs={
        k: dict(wall_s=v["wall_s"], plans_per_s=batch / v["wall_s"],
                median_cost=float(v["cost"].median()),
                ulp_moved_median_rel=v["ulp_median_rel"])
        for k, v in refs.items()})

    launches = {}
    for (n_scn, n_obs), runs in SHARDED_RUNS.items():
        t0 = time.perf_counter()
        ranks = local_world.run(
            2, "chip_smoke.py:sharded_rank",
            dict(n_scn=n_scn, n_obs=n_obs, runs=runs), backend="gloo",
            device="cuda", timeout=RANK_TIMEOUT)
        world_s = time.perf_counter() - t0
        tag = f"{n_scn}x{n_obs}"
        for name in runs:
            rs = [r[name] for r in ranks]
            got, ref = rs[0], refs[name]
            if not all(np.array_equal(r["x"], got["x"]) for r in rs[1:]):
                raise AssertionError(f"{tag} {name}: the ranks gather "
                                     "different results")
            cost = torch.as_tensor(got["cost"])
            lanes_differ = int((cost != ref["cost"]).sum())
            bitwise = bool(lanes_differ == 0
                           and np.array_equal(got["x"], ref["x"].numpy()))
            median_rel = abs(float(cost.median()) - float(
                ref["cost"].median())) / abs(float(ref["cost"].median()))
            lane_rel = ((cost - ref["cost"]).abs()
                        / ref["cost"].abs()).numpy()
            first = (None if got["f0"] is None else rel_diff(
                torch.as_tensor(got["f0"]), ref["f0"]))
            calls = [r["all_reduce"] for r in rs]
            if n_obs == 1 and any(calls):
                raise AssertionError(f"{tag} {name}: all_reduce {calls} "
                                     "with nothing to reduce")
            if n_obs == 1 and name != "e2e" and not bitwise:
                # scenarios split: nothing is reassociated
                raise AssertionError(f"{tag} {name}: {lanes_differ} lanes "
                                     "differ from the single process")
            if name == "e2e" and not (
                    np.array_equal(got["front_ok"], ref["front_ok"].numpy())
                    and median_rel <= 2e-3):
                # torch.cumsum on the card sums a row of >= 300 entries in
                # another order at 256 rows than at 512 (the front end's
                # arc lengths): the states move by ulps, some lanes'
                # solves with them
                raise AssertionError(f"{tag} e2e: median cost {median_rel}")
            if n_obs > 1 and not (first <= 1e-6 and calls[0] == calls[1] > 0):
                raise AssertionError(f"{tag} {name}: first evaluation "
                                     f"{first}, all_reduce {calls}")
            if name == "solve_jax" and not median_rel <= 2e-3:
                raise AssertionError(f"{tag} {name}: median cost "
                                     f"{median_rel}")
            for r in rs:
                for fm, k in r["form_launches"].items():
                    key = (f"sharded_{name}_{tag}", fm)
                    launches[key] = launches.get(key, 0) + k
            if sum(sum(r["form_launches"].values()) for r in rs) <= 0:
                raise AssertionError(f"{tag} {name}: no coarse-scan launch")
            walls = [r["wall_s"] for r in rs]
            say("sharded", mesh=tag, run=name, settings=SOLVE_SETTINGS.get(
                    name, "default_stages(40)"), ranks=2, backend="gloo",
                device="cuda:0 (both ranks)", B=batch, wall_s=walls,
                plans_per_s=batch / max(walls),
                single_process_wall_s=ref["wall_s"],
                all_reduce_per_solve=calls, first_eval_rel=first,
                median_cost=float(cost.median()),
                single_process_median_cost=float(ref["cost"].median()),
                median_rel=median_rel,
                ulp_moved_median_rel=ref["ulp_median_rel"],
                lanes_differ=lanes_differ,
                lanes_within_2e3=float((lane_rel <= 2e-3).mean()),
                bitwise_with_single_process=bitwise,
                form_launches=[r["form_launches"] for r in rs],
                world_s=world_s)
            say("path_scans", path=f"sharded {name} {tag} (rank 0)",
                shapes=got["shapes"], max_abs_err=got["max_abs_err"],
                bitwise=True)
            for entry, err in got["worst"].items():
                ShapeLog.worst[entry] = max(ShapeLog.worst.get(entry, 0.0),
                                            err)
    # (d) NCCL in a world of one
    t0 = time.perf_counter()
    (nccl,) = local_world.run(1, "chip_smoke.py:nccl_rank", {}, backend="nccl",
                              device="cuda", timeout=RANK_TIMEOUT)
    if not (nccl["backend"] == "nccl" and nccl["f_equal"] and nccl["g_equal"]
            and nccl["all_reduce_equal"]):
        raise AssertionError(f"NCCL world of one: {nccl}")
    say("sharded_nccl", world_s=time.perf_counter() - t0, **nccl)
    return launches


def deployment_loop(torch, rp, sc, fleet, scene, memo_cases, dev,
                    out_dir):
    """Phase 15, the deployment loop on ``dev`` against the host: (a) a
    replan with ``rp`` (phase 7's synthetic_sdTrapezoid replanner) and a
    live back-end solve of its trajectory under the live dashboard; (b)
    the trajectory through the wire formats and a checkpoint; (c) its
    command stream, odometry and closed-loop flight against a host float64
    run of the same functions, the launches of 5 and of 10 ticks traced,
    then the flight of ``fleet`` (B trajectories) in lockstep; (d) depth
    images against the host's: of the scenario's map along the flight, and
    of ``scene`` = (name, cloud (P, 3), trajectory) at 16 poses along the
    trajectory's command stream; (e) the disk memo: each of ``memo_cases``
    = (name, config, map points, fine-yaw factors), a ``Planner`` and its
    fine-yaw planners built in-process only, then cold and warm on a fresh
    root; (f) the stage profile, and (in (c)) a device trace of the
    flight's first 10 ticks into ``out_dir``.
    Every step is a ``profiling.stage``. Raises when a step misses its
    limit; returns {step: its line's readings}."""
    import numpy as np
    from svsdf_tpu_torch.io import (MincoTraj, PolyTraj, decode_minco_traj,
                                    decode_poly_traj, encode_minco_traj,
                                    encode_poly_traj)
    from svsdf_tpu_torch.ops import minco
    from svsdf_tpu_torch.planner import back_end, traj_server
    from svsdf_tpu_torch.planner.pipeline import Planner
    from svsdf_tpu_torch.sim import closed_loop, kinematic
    from svsdf_tpu_torch.sim import depth_camera as dc
    from svsdf_tpu_torch.utils import cache, checkpoint, profiling
    from svsdf_tpu_torch.utils import trajectory as trj
    from svsdf_tpu_torch.utils.debugbus import BUS
    from svsdf_tpu_torch.utils.transforms import backward_t
    from svsdf_tpu_torch.viz.dashboard import LiveDashboard

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def clock(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    def host64(tr):
        return trj.Trajectory(tr.coeffs.detach().cpu().double(),
                              tr.durations.detach().cpu().double())

    def near(a, b, limit, what):
        err = rel_diff(a.detach().double().cpu(), b)
        if not err <= limit:
            raise AssertionError(f"{what}: {err} past {limit}")
        return err

    profiling.PROFILE.clear()
    lines = {}
    tmp = tempfile.TemporaryDirectory()
    try:
        # (a) plan: a replan, then a live back-end solve from it
        with profiling.stage("15a_plan"):
            r, replan_s = clock(lambda: rp.replan(sc.start[:2], sc.goal[:2]))
            if not (r.success and math.isfinite(r.cost) and r.cert_min > 0):
                raise AssertionError(f"deployment replan: success "
                                     f"{r.success} cert {r.cert_min}")
            traj = trj.Trajectory(r.traj.coeffs.to(dev),
                                  r.traj.durations.to(dev))
            ends = torch.cat([torch.zeros_like(traj.durations[:, :1]),
                              traj.total_duration[:, None]], 1)
            pva = torch.stack([trj.eval_at(traj, ends, k)[0]
                               for k in range(3)], 1)    # (2, 3, 3)
            head, tail = pva[0], pva[1]
            wps = traj.coeffs[0, 1:, 0, :]
            x0 = torch.cat([backward_t(traj.durations[0]),
                            wps.reshape(-1)])[None]
            BUS.series.clear()
            BUS.events.clear()
            BUS.clear_stop()
            BUS.resume()
            with LiveDashboard(BUS, os.path.join(out_dir, "live.html"),
                               interval_s=0.25) as live:
                res, live_s = clock(lambda: back_end.optimize(
                    rp.shape, head[None], tail[None],
                    torch.as_tensor(r.obstacles)[None], x0, cfg=rp.config,
                    max_iters=40, live=True, device=dev))
            steps = [st for (_, st, _) in BUS.series["opti_cost"]]
            n_it = int(res.n_iters[0])
            # one entry an iteration run; the counter skips the rest of a
            # stage that converges early and ends one past the last
            if not (steps and all(a < b for a, b in zip(steps, steps[1:]))
                    and steps[-1] + 1 == n_it and live.renders >= 1
                    and bool(torch.isfinite(res.cost).all())):
                raise AssertionError(f"live solve: {len(steps)} entries, "
                                     f"counter {n_it}, {live.renders} "
                                     "renders")
            lines["deploy_plan"] = dict(
                scenario=sc.name, replan_s=replan_s, success=r.success,
                cost=r.cost, cert_min=r.cert_min, pieces=traj.num_pieces,
                duration_s=float(traj.total_duration[0]),
                live_solve_s=live_s, live_cost=float(res.cost[0]),
                opti_cost_entries=len(steps), iteration_counter=n_it,
                renders=live.renders, dashboard="chiprun_out/live.html")

        # (b) wire: PolyTraj JSON, MincoTraj re-solved here, a checkpoint
        with profiling.stage("15b_wire"):
            wire = PolyTraj.from_json(encode_poly_traj(r.traj).to_json())
            back = decode_poly_traj(wire, device=dev)
            poly_exact = (torch.equal(back.coeffs.cpu(), r.traj.coeffs)
                          and torch.equal(back.durations.cpu(),
                                          r.traj.durations))

            def minco_gap(sent, got):
                ts = torch.linspace(0.0, float(sent.total_duration[0]), 200,
                                    device=dev)[None]
                return float((trj.pos(got, ts) - trj.pos(sent, ts))
                             [..., :2].abs().max())

            # the live solve's MINCO parameters (its times, waypoints and
            # end states), as a deployment's MincoTraj carries them: the
            # receiver's re-solve is the sender's solve of the same inputs
            n_live = res.traj.durations.shape[1]
            mmsg = MincoTraj.from_dict(json.loads(json.dumps(
                encode_minco_traj(res.traj.durations[0], head, tail,
                                  res.opt_x[0, n_live:].reshape(n_live - 1, 3)
                                  ).to_dict())))
            minco_err = minco_gap(res.traj, decode_minco_traj(mmsg,
                                                              device=dev))
            # parameters read back off the replanned trajectory (its
            # knots, its end states) instead: any float32 receiver lands
            # a few float32 steps at the trajectory's magnitude away, so
            # these readings (the kernel's, the plain version's, a float64
            # solve's rounded to float32) are reported, not limited
            rmsg = encode_minco_traj(traj.durations[0], head, tail, wps)
            rederived = {"kernel": minco_gap(traj, decode_minco_traj(
                rmsg, device=dev))}
            with mock.patch.object(cuda_minco, "forward",
                                   lambda b, r, k: block_cr._cr_core(
                                       b, r, k, False)):
                rederived["plain"] = minco_gap(traj, decode_minco_traj(
                    rmsg, device=dev))
            s64 = minco.solve(traj.durations.double(), head[None].double(),
                              tail[None].double(), wps[None].double())
            rederived["float64"] = minco_gap(traj, trj.Trajectory(
                s64.coeffs.float(), traj.durations))
            path = checkpoint.save_plan(os.path.join(tmp.name, "plan.npz"),
                                        res.opt_x, res.traj,
                                        scenario=sc.name,
                                        cost=float(res.cost[0]))
            ck = checkpoint.load_plan(path, device=dev)
            ck_exact = (torch.equal(ck.opt_x, res.opt_x)
                        and torch.equal(ck.traj.coeffs, res.traj.coeffs)
                        and torch.equal(ck.traj.durations,
                                        res.traj.durations))
            if not (poly_exact and minco_err <= 1e-5 and ck_exact):
                raise AssertionError(f"wire: PolyTraj exact {poly_exact}, "
                                     f"MincoTraj {minco_err} m, checkpoint "
                                     f"exact {ck_exact}")
            lines["deploy_wire"] = dict(
                polytraj_json_bytes=len(wire.to_json()),
                polytraj_bitwise=poly_exact, minco_max_err_m=minco_err,
                minco_rederived_err_m=rederived,
                minco_json_bytes=len(json.dumps(mmsg.to_dict())),
                checkpoint_bitwise=ck_exact,
                checkpoint_bytes=os.path.getsize(path))

        # (c) commands, odometry and flight against the host in float64
        with profiling.stage("15c_flight"):
            h = host64(r.traj)
            cmds, cmds_s = clock(lambda: traj_server.sample_commands(traj))
            cmds_h = traj_server.sample_commands(h)
            errs = {f: near(getattr(cmds, f), getattr(cmds_h, f), 1e-5, f)
                    for f in ("t", "pos", "vel", "acc", "jerk")}
            errs["yaw"] = float(traj_server._wrap(
                cmds.yaw.double().cpu() - cmds_h.yaw).abs().max())
            errs["yaw_rate_dt"] = float(
                ((cmds.yaw_rate.double().cpu() - cmds_h.yaw_rate)
                 * 0.01).abs().max())
            # the yaw target is the angle of a look-ahead vector as short
            # as 0.1 m between two float32 positions of a 50 m map (~3e-6 m
            # each): ~6e-5 rad of float32 rounding
            if not max(errs["yaw"], errs["yaw_rate_dt"]) <= 1e-4:
                raise AssertionError(f"command yaw vs host: {errs}")
            errs["odom_quat"] = near(
                kinematic.odom_from_commands(cmds).quat,
                kinematic.odom_from_commands(cmds_h).quat, 1e-5, "odom")
            log, fly_s = clock(lambda: closed_loop.fly(traj))
            log_h, fly_host_s = clock(lambda: closed_loop.fly(h))
            fly_err = float((log.pos.double().cpu() - log_h.pos).abs().max())
            if not fly_err <= 1e-4:
                raise AssertionError(f"flight vs host: {fly_err} m")
            # the launches of the flight's first 5 and 10 ticks (~2 MB of
            # trace a tick: the whole flight's would not fit the output);
            # every tick runs the same launches, so the difference over the
            # 5 more ticks is a tick's and the rest is a flight's own
            traced = []
            for n, into in ((5, tmp.name), (10, out_dir)):
                prefix = trj.Trajectory(traj.coeffs[:, :1], torch.clamp(
                    traj.durations[:, :1], max=(n - 0.5) * 0.01))
                with profiling.device_trace(into) as tprof:
                    closed_loop.fly(prefix)
                    sync()
                traced.append((int(traj_server.n_ticks(
                    prefix, traj_server.TrajServerConfig())[0]),
                    device_events(tprof)))
            (t5, k5), (t10, k10) = traced
            per_tick = (len(k10) - len(k5)) / (t10 - t5)
            ticks = log.pos.shape[1]
            err = log.track_err[0]
            lines["deploy_flight"] = dict(
                ticks=ticks, commands_s=cmds_s, command_err_vs_host=errs,
                track_err_max_m=float(err.max()),
                track_err_final_m=float(err[-1]), flight_s=fly_s,
                host_f64_flight_s=fly_host_s, pos_err_vs_host_m=fly_err,
                traced_ticks=[t5, t10], traced_launches=[len(k5), len(k10)],
                launches_per_tick=per_tick,
                fixed_launches=len(k5) - per_tick * t5,
                traced_device_busy_s=[sum(us for _, us in k) / 1e6
                                      for k in (k5, k10)])
            flog, fleet_s = clock(lambda: closed_loop.fly(fleet))
            lane_max = flog.track_err.max(dim=1).values
            if not bool(torch.isfinite(flog.track_err).all()):
                raise AssertionError("fleet: a lane's tracking error is not "
                                     "finite")
            nb, fticks = flog.pos.shape[:2]
            lines["deploy_fleet"] = dict(
                flights=nb, ticks=fticks, fleet_s=fleet_s,
                flight_ticks_per_s=nb * fticks / fleet_s,
                # lanes whose Trajectory.total_duration (torch.sum) is
                # not the server's ordered sum on this device
                sum_order_lanes_differing=int(
                    (fleet.total_duration
                     != traj_server.total_duration(fleet)).sum()),
                lane_track_err_max_m=dict(
                    median=float(lane_max.median()),
                    max=float(lane_max.max())))

        # (d) depth images against the host's: the scenario's map along
        # the flight, then ``scene``'s cloud along its trajectory
        with profiling.stage("15d_sensing"):
            cam = dc.CameraModel()
            reps = 5

            def images(name, cloud, pos, yaw):
                """16 images of ``cloud`` at poses along (pos, yaw) (T, 3),
                (T,) on the card and on the host: their readings."""
                ks = np.linspace(0, len(yaw) - 1, 16).astype(int)
                poses = [dc.sensing_pose_from_odom(pos[k], float(yaw[k]))
                         for k in ks]
                Rb = np.stack([p[0] for p in poses])
                tb = np.stack([p[1] for p in poses])
                cloud = torch.as_tensor(np.asarray(cloud, np.float32))
                render = lambda c: dc.render_depth_batch(c, Rb, tb, cam)
                cloud_d = cloud.to(dev)
                render(cloud_d)
                imgs, wall = clock(lambda: [render(cloud_d)
                                            for _ in range(reps)][-1])
                imgs_h = render(cloud)
                set_d, set_h = (imgs > 0).cpu(), imgs_h > 0
                edge = int((set_d != set_h).sum())
                both = set_d & set_h
                same = bool(torch.equal(imgs.cpu()[both], imgs_h[both]))
                if not (int(set_h.sum()) > 0 and same
                        and edge <= 0.001 * int(set_h.sum())):
                    raise AssertionError(f"depth of {name} vs host: {edge} "
                                         f"pixels set on one side, depths "
                                         f"equal {same}")
                pts = sum(len(dc.depth_to_points(im, R, t, cam, stride=2))
                          for im, R, t in zip(imgs, Rb, tb))
                return dict(cloud=name, cloud_points=len(cloud),
                            images=len(ks), ms_per_image=wall / reps
                            / len(ks) * 1e3, pixels_set=int(set_h.sum()),
                            pixels_set_one_side=edge, depths_bitwise=same,
                            stride2_cloud_points=pts)

            name, cloud, straj = scene
            scmds = traj_server.sample_commands(trj.Trajectory(
                straj.coeffs.to(dev), straj.durations.to(dev)))
            lines["deploy_sensing"] = dict(
                size=[cam.height, cam.width],
                clouds=[images(sc.name, sc.map_points, log.pos[0].cpu()
                               .numpy(), cmds.yaw[0].cpu().numpy()),
                        images(name, cloud, scmds.pos[0].cpu().numpy(),
                               scmds.yaw[0].cpu().numpy())])

        # (e) the disk memo: each case's Planner and fine-yaw planners
        # built in-process only (no disk), then cold and warm on a fresh
        # root, then in-process again
        with profiling.stage("15e_memo"):
            def build(cfg, pts, factors):
                p = Planner(cfg, pts, device=dev)
                return [(q._kernels, q._stencils(q.guard_ladder[0]),
                         torch.as_tensor(q.feas))
                        for q in [p] + [p._get_fine_planner(f)
                                        for f in factors]]

            def equal(a, b):
                return all(torch.equal(x.cpu(), y.cpu())
                           for pa, pb in zip(a, b) for x, y in zip(pa, pb))

            lines["deploy_memo"] = dict(cases=[])
            root = os.environ.get("SVSDF_TORCH_CACHE_DIR")
            for name, cfg, pts, factors in memo_cases:
                memo = tempfile.TemporaryDirectory()
                os.environ["SVSDF_TORCH_CACHE_DIR"] = memo.name
                try:
                    with mock.patch.object(cache, "memo_prefix",
                                           lambda shape: None):
                        ref, nodisk_s = clock(lambda: build(cfg, pts,
                                                            factors))
                    cold, cold_s = clock(lambda: build(cfg, pts, factors))
                    warm, warm_s = clock(lambda: build(cfg, pts, factors))
                    with mock.patch.object(cache, "memo_prefix",
                                           lambda shape: None):
                        _, nodisk2_s = clock(lambda: build(cfg, pts,
                                                           factors))
                    files = [os.path.join(memo.name, f)
                             for f in os.listdir(memo.name)]
                    disk_bytes = sum(os.path.getsize(f) for f in files)
                finally:
                    if root is None:
                        del os.environ["SVSDF_TORCH_CACHE_DIR"]
                    else:
                        os.environ["SVSDF_TORCH_CACHE_DIR"] = root
                    memo.cleanup()
                exact = equal(cold, warm) and equal(ref, cold)
                if not (exact and len(files) == 2 * len(cold)):
                    raise AssertionError(f"memo of {name}: warm equals cold "
                                         f"equals in-process {exact}, "
                                         f"{len(files)} entries")
                lines["deploy_memo"]["cases"].append(dict(
                    case=name, kernel_size=cfg.kernel_size,
                    yaw_bins=[cfg.kernel_yaw_num * f for f in (1, *factors)],
                    in_process_s=nodisk_s, cold_build_s=cold_s,
                    warm_build_s=warm_s, in_process_again_s=nodisk2_s,
                    entries=len(files), bytes=disk_bytes,
                    warm_bitwise=exact))

        # (f) the stage profile and (c)'s device trace
        traces = sorted(glob.glob(os.path.join(out_dir, "*.pt.trace.json")),
                        key=os.path.getmtime)
        lines["deploy_profile"] = dict(
            report=profiling.PROFILE.report().splitlines(),
            trace=os.path.relpath(traces[-1], ROOT),
            trace_bytes=os.path.getsize(traces[-1]))
    finally:
        tmp.cleanup()
    return lines


def main() -> int:
    import numpy as np
    import torch

    # -- 1. environment ------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card")
    # a fresh disk memo (utils/cache.py): every run's planners build cold
    memo_root = tempfile.TemporaryDirectory()
    os.environ["SVSDF_TORCH_CACHE_DIR"] = memo_root.name
    from svsdf_tpu_torch import convert
    from svsdf_tpu_torch.bench import (BENCH_MEM_SIZE, bench_e2e,
                                       bench_grid_queries,
                                       bench_plans_profile, e2e_draws,
                                       e2e_setup, grid_setup, plans_run,
                                       problem, write_prism_obj)
    from svsdf_tpu_torch.models import mesh_sdf, shapes
    from svsdf_tpu_torch.ops import cuda_svsdf as cs
    from svsdf_tpu_torch.ops import kernels as kops
    from svsdf_tpu_torch.ops.svsdf import SVSDFConfig, svsdf_grid
    from svsdf_tpu_torch.parallel import batch as pb
    from svsdf_tpu_torch.planner import back_end
    from svsdf_tpu_torch.planner.online import (OnlineReplanner,
                                                front_end_maps)
    from svsdf_tpu_torch.planner.pipeline import Planner
    from svsdf_tpu_torch.utils import fixtures, mapgen
    from svsdf_tpu_torch.utils import trajectory as trj
    from svsdf_tpu_torch.utils.config import PlannerConfig
    from svsdf_tpu_torch.viz import swept_surface as sw

    card = smi_line()
    kind = torch.cuda.get_device_name(0)
    say("env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, device=kind, smi=card,
        count=torch.cuda.device_count())

    # -- 2. build ------------------------------------------------------
    # the kernel, and scan_ab.py's floor build of its source (phase 3's
    # least time of a deformable launch), one nvcc each, started together
    import scan_ab
    floor_build = scan_ab.variant_module("floor")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        floor_job = pool.submit(floor_build.build)
        minco_job = pool.submit(cuda_minco.build)
        lib, log = cs.build()
        build_s = time.perf_counter() - t0
        floor_job.result()
        minco_lib, minco_log = minco_job.result()
    say("build", seconds=round(build_s, 3),
        with_floor_build_s=round(time.perf_counter() - t0, 3),
        library=os.path.relpath(lib, ROOT),
        ptxas=[ln.strip() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln],
        minco_library=os.path.relpath(minco_lib, ROOT),
        minco_ptxas=[ln.strip() for ln in minco_log.splitlines()
                     if "registers" in ln or "spill" in ln])
    # the grid body's branch-free roots at every positive input
    roots = cs.root_mismatches("cuda")
    say("grid_roots", float32_mismatches=roots[0],
        bfloat16_mismatches=roots[1])
    if roots != (0, 0):
        raise AssertionError(f"the grid body's roots are not exact: {roots}")
    # the deformable float32 form's division by a pose's scale at every
    # dividend of the schedules' divisors (the card tests add every pair
    # of significands: cs.div_pair_mismatches, a minute more)
    t0 = time.perf_counter()
    division = cs.div_mismatches("cuda")
    say("scale_division", divisors=len(cs.division_divisors("cuda")),
        every_dividend_mismatches=division,
        seconds=time.perf_counter() - t0)
    if division != 0:
        raise AssertionError("the deformable float32 form's quotients are "
                             f"not the IEEE ones: {division} mismatches")

    # -- 14 (a). the mesh robots, which phase 3 checks too -------------
    mesh_dir = tempfile.TemporaryDirectory()
    mesh_obj, mesh = {}, {}
    for key, (body, extent) in MESH_ROBOTS.items():
        t0 = time.perf_counter()
        mesh_obj[key] = write_prism_obj(
            body, os.path.join(mesh_dir.name, f"{key}.obj"), extent=extent)
        t1 = time.perf_counter()
        mesh[key] = mesh_sdf.shape_from_mesh(mesh_obj[key])
        g = mesh[key].grid
        say("mesh_robot", robot=mesh[key].name, body=body,
            grid=f"{g.nx}x{g.ny}", grid_bytes=g.field.nbytes,
            step=g.step, obj_s=t1 - t0,
            shape_from_mesh_s=time.perf_counter() - t1)

    # -- 3. kernel vs plain on the card --------------------------------
    cases = []
    for name in FIRST_BODIES:
        for pp in ((0.0, 0.0, 0.0), (0.3, -0.2, 25.0)):
            shape = shapes.make_shape(name, poly_params=pp)
            for m in (7, 1024, 2000):
                cases.append((shape, 1, m, 37, 1e-5))
    cases.append((shapes.make_shape("sdHeart"), 1, 4096, 64, 1e-4))
    heart = shapes.make_shape("sdHeart")
    # every other body (Polygon: the fallback thin rectangle); the paths'
    # own shapes are checked after each path (ShapeLog.check)
    all_bodies = tuple(shapes.shape_names()) + ("Polygon",)
    for name in all_bodies:
        if name in FIRST_BODIES:
            continue
        for pp in ((0.0, 0.0, 0.0), (0.3, -0.2, 25.0)):
            shape = shapes.make_shape(name, poly_params=pp)
            for m in (7, 1024, 2000):
                cases.append((shape, 1, m, 37, 1e-5))
    # the grid body: both mesh robots under both pre-transforms
    for key, robot in mesh.items():
        for pp in ((0.0, 0.0, 0.0), (0.3, -0.2, 25.0)):
            shape = mesh_sdf.mesh_shape(key, robot.grid, pp)
            for m in (7, 1024, 2000):
                cases.append((shape, 1, m, 37, 1e-5))
    # the bfloat16 form on every case above; the deformable forms of the
    # deformable scenarios' robots in both scan types on the same inputs
    cases = ([c + (None,) for c in cases]
             + [c + ("bfloat16",) for c in cases])
    for scenario in fixtures.list_deformable_scenarios():
        robot = fixtures.deformable_scenario(scenario).shape
        for pp in ((0.0, 0.0, 0.0), (0.3, -0.2, 25.0)):
            shape = shapes.make_scaled_shape(robot.name, robot.scale_fn,
                                             poly_params=pp)
            for dt in (None, "bfloat16"):
                for m in (7, 1024, 2000):
                    cases.append((shape, 1, m, 37, 1e-5, dt))
    per_body = {}
    for i, (shape, b, m, k, atol, dt) in enumerate(cases):
        err, bitwise = compare_scan(torch, cs, shape,
                                    scan_inputs(torch, b, m, k, seed=i), atol,
                                    dt, pose_times(torch, b, k, seed=i))
        fm = form_of(cs, shape, dt)
        entry = entry_of(cs, shape, dt)
        ShapeLog.worst[entry] = max(ShapeLog.worst.get(entry, 0.0), err)
        row = per_body.setdefault((shape.name, fm), {
            "cases": [], "max_abs_err": 0.0, "bitwise": True})
        row["cases"].append(f"{b}x{m}x{k} pre={shape.tx},{shape.ty},"
                            f"{shape.yaw0:.4f}")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["bitwise"] = row["bitwise"] and bitwise
    # the grid body on its edges: the bfloat16 clamp zone, past the grid
    for i, (key, robot) in enumerate(mesh.items()):
        for pp in ((0.0, 0.0, 0.0), (0.3, -0.2, 25.0)):
            shape = mesh_sdf.mesh_shape(key, robot.grid, pp)
            for dt in (None, "bfloat16"):
                for b, m, k in ((2, 600, 37), (1, 2000, 96)):
                    err, bitwise = compare_scan(
                        torch, cs, shape, grid_edge_inputs(
                            torch, shape, b, m, k, seed=90 + i), 1e-5, dt)
                    entry = entry_of(cs, shape, dt)
                    ShapeLog.worst[entry] = max(
                        ShapeLog.worst.get(entry, 0.0), err)
                    row = per_body[(shape.name, form_of(cs, shape, dt))]
                    row["cases"].append(f"edges {b}x{m}x{k} pre={shape.tx},"
                                        f"{shape.ty},{shape.yaw0:.4f}")
                    row["max_abs_err"] = max(row["max_abs_err"], err)
    for (name, fm), row in per_body.items():     # one line per body, form
        say("scan", shape=name, form=fm, **row)
    timings = []
    for path, (b, m, k) in ([("main", sh) for sh in MAIN_SHAPES]
                            + [("e2e", sh) for sh in E2E_SHAPES]
                            + [("planner", sh) for sh in PLANNER_SHAPES]
                            + [("grid", GRID_SHAPE)]):
        inp = scan_inputs(torch, b, m, k, seed=99)
        timings.append(dict(path=path, **time_scan(
            torch, cs, heart, inp, None, None, scan_bound_ms(heart, b, m, k))))
    # sdHeart's other forms: at the main path's shape, the bfloat16 form
    # at the grid query's; the deformable float32 form with each
    # deformable scenario's robot there and at the single plan's shapes
    # (where the deformable Planner.plan runs launch it)
    scaled = scan_ab.deformable_robots()
    scaled_heart = scaled["sdHeart"]
    form_times = {}
    for fm, shape, dt, (b, m, k) in (
            ("bfloat16", heart, "bfloat16", BODY_TIME_SHAPE),
            *(("scaled_float32", robot, None, sh) for robot in scaled.values()
              for sh in (BODY_TIME_SHAPE, *PLANNER_SHAPES)),
            ("scaled_bfloat16", scaled_heart, "bfloat16", BODY_TIME_SHAPE),
            ("bfloat16", heart, "bfloat16", GRID_SHAPE)):
        inp = scan_inputs(torch, b, m, k, seed=97)
        row = time_scan(torch, cs, shape, inp, dt, pose_times(torch, b, k, 97),
                        scan_bound_ms(shape, b, m, k, bf16=dt is not None))
        form_times.setdefault(fm, []).append(dict(form=fm, shape=shape.name,
                                                  **row))
    # the floor: the same launch with the evaluation cut to one operation
    # (scan_ab.py VARIANTS), where the single plan's launches fall; the
    # bound there is the larger of the issue-rate bound and the floor
    floor_ms = {}
    for b, m, k in PLANNER_SHAPES:
        inp = scan_inputs(torch, b, m, k, seed=97)
        ts = pose_times(torch, b, k, 97)
        t, _ = device_ms(torch, lambda: floor_build.coarse_scan(
            scaled_heart, *inp, ts=ts))
        if t is None:
            raise RuntimeError("torch.profiler saw no floor launch")
        floor_ms[(b, m, k)] = t
    for row in form_times["scaled_float32"]:
        floor = floor_ms.get((row["B"], row["M"], row["K"]))
        if floor is not None:
            row.update(floor_ms=floor,
                       bound_with_floor_ms=max(row["bound_ms"], floor),
                       bound_basis="floor" if floor > row["bound_ms"]
                       else row["bound_by"])
    say("scaled_scan_times", floor_route="scan_ab.py VARIANTS['floor']",
        rows=form_times["scaled_float32"])
    # the grid body (the sdHeart prism) in both forms at the prism batch's
    # shapes and the grid query's, each with the launch geometry it took
    heart_mesh = mesh["heart_prism"]
    for dt in (None, "bfloat16"):
        for b, m, k in GRID_BODY_SHAPES:
            inp = scan_inputs(torch, b, m, k, seed=96)
            row = time_scan(torch, cs, heart_mesh, inp, dt, None,
                            scan_bound_ms(heart_mesh, b, m, k,
                                          bf16=dt is not None))
            fm = "grid_" + form_of(cs, heart_mesh, dt)
            form_times.setdefault(fm, []).append(dict(
                form=fm, geometry=cs.launch_geometry(b, m, k), **row))
    say("grid_body_times", robot=heart_mesh.name, route="corner_records",
        grid=f"{heart_mesh.grid.nx}x{heart_mesh.grid.ny}",
        record_cells=heart_mesh.grid.record_cells(),
        records_bytes=heart_mesh.grid.corner_records("cuda").nbytes,
        rows=form_times["grid_float32"] + form_times["grid_bfloat16"])
    # every body at one shape: kernel (profiler), plain (events), bound
    body_times = []
    inp = scan_inputs(torch, *BODY_TIME_SHAPE, seed=98)
    for name in all_bodies:
        shape = shapes.make_shape(name)
        kernel, seen = device_ms(torch, lambda: cs.coarse_scan(shape, *inp))
        wrapper = time_ms(torch, lambda: cs.coarse_scan(shape, *inp))
        plain = time_ms(torch, lambda: cs.coarse_scan_reference(shape, *inp),
                        reps=50)
        bound, by = scan_bound_ms(shape, *BODY_TIME_SHAPE)
        body_times.append({"shape": name,
                           "ms": kernel if kernel is not None else wrapper,
                           "ms_source": "profiler" if kernel is not None
                           else "events", "wrapper_ms": wrapper,
                           "plain_ms": plain, "bound_ms": bound,
                           "bound_by": by})

    # the inputs of the rows above that are not readings: the launch
    # geometry (S, threads, grid) each shape gets, and the bound's basis
    say("scan_geometry", shapes=[
        {"path": t["path"], "B": t["B"], "M": t["M"], "K": t["K"],
         "geometry": cs.launch_geometry(t["B"], t["M"], t["K"])}
        for t in timings])
    say("bound_basis", issued_fp32_ops_per_s=ISSUED_FP32_OPS_PER_S,
        issued_bf16_ops_per_s=ISSUED_BF16_OPS_PER_S,
        scaled_extra_ops_per_eval=OPS_SCALED,
        hbm_bytes_per_s=HBM_BYTES_PER_S,
        ops_per_eval={name: ops_per_eval(shapes.make_shape(name))
                      for name in all_bodies},
        grid_body_ops_per_eval=OPS_GRID,
        grid_body_bf16_ops_per_eval=OPS_GRID_BF16,
        grid_bytes={r.name: r.grid.field.nbytes for r in mesh.values()},
        polygon_bf16_ops_per_eval=OPS_POSE)

    # -- 3 (b). the MINCO CR kernels -----------------------------------
    minco_times = minco_phase(torch)
    for row in minco_times:
        say("minco_cr_times", **row)

    # -- 4. main path --------------------------------------------------
    # the bench's plans section (svsdf_tpu_torch.bench.plans_run) in this
    # process: it resets the counts, solves, reads them and re-scores; the
    # kernel is then held at every shape; then its plans_profile section
    n, m_obs, batch, iters = 8, 64, 512, 40
    cfg = PlannerConfig(mem_size=BENCH_MEM_SIZE)

    def main_path(scan_dtype, form, seed):
        """plans_run and bench_plans_profile at ``scan_dtype`` (B=512
        only). Returns (median cost, the path's launches, its ShapeLog, the
        last run's trajectories)."""
        with SectionLog(cs) as log:
            res, out = plans_run(n, m_obs, iters, scan_dtype, (batch,))
        launches = res["scan_launches"][form]
        log.check(torch, f"main {form}", seed=seed)
        say("main_path", B=batch, n=n, M=m_obs,
            median_wall_s=res.pop("plan_batch_wall_s"),
            kernel_launches=sum(res["scan_launches"].values()),
            launches_per_solve=launches / 4, **res)
        # where one solve's time goes: device busy share and kernel counts
        say("main_path_profile", **bench_plans_profile(scan_dtype, (batch,)))
        return res["median_final_cost"], launches, log, out.traj

    # the JAX package's bench.py configuration (bfloat16 scans), then the
    # float32 variant the earlier readings were taken at; phase 15 flies
    # the bfloat16 run's last trajectories
    bf16_cost, bf16_launches, bf16_log, fleet = main_path(
        "bfloat16", "bfloat16", seed=1100)
    stages = pb.default_stages(iters, scan_dtype=None)
    main_cost, launches, main_log, _ = main_path(None, "float32", seed=1000)

    # -- 5. checks -----------------------------------------------------
    small = 32
    hs, ts_, os_, xs = problem(n, m_obs, small)
    prob_s, x_s = convert.problem_from_numpy(hs, ts_, os_, xs)
    with_kernel = pb.plan_batch_staged(heart, x_s, prob_s, cfg, stages, n)
    c_kernel = float(with_kernel.cost.median())
    with mock.patch.object(cs, "coarse_scan", cs.coarse_scan_reference):
        with_plain = pb.plan_batch_staged(heart, x_s, prob_s, cfg, stages, n)
    c_plain = float(with_plain.cost.median())
    rel = abs(c_kernel - c_plain) / abs(c_plain)
    if not rel <= 1e-3:
        raise AssertionError(f"kernel vs plain scan solve: rel {rel}")
    # one cost + gradient on the card (f32) vs on the host (f64)
    polish = stages[1][0]
    full_d, _ = back_end.make_cost_pair_fn(heart, prob_s, cfg, polish, n)
    prob_h, x_h = convert.problem_from_numpy(hs, ts_, os_, xs, device="cpu",
                                             dtype=torch.float64)
    full_h, _ = back_end.make_cost_pair_fn(heart, prob_h, cfg, polish, n)
    f_d, g_d, _ = full_d(x_s)
    f_h, g_h, _ = full_h(x_h)
    f_rel = float(((f_d.double().cpu() - f_h).abs() / f_h.abs()).max())
    g_rel = float(((g_d.double().cpu() - g_h).norm(dim=1)
                   / g_h.norm(dim=1)).max())
    if not (f_rel <= 1e-4 and g_rel <= 1e-2):
        raise AssertionError(f"card vs host cost: f {f_rel}, g {g_rel}")
    say("checks", B=small, median_cost_kernel=c_kernel,
        median_cost_plain=c_plain, rel_diff=rel,
        exact=c_kernel == c_plain, cost_f32_vs_f64_rel=f_rel,
        grad_f32_vs_f64_rel=g_rel)

    # -- 6. batched end to end -----------------------------------------
    e2e = e2e_setup()
    res_e = e2e.grid.resolution
    xy_min_e = e2e.grid.xyz_min[:2].astype(np.float32)
    n_e, obs_e, batch_e = 8, 48, 512

    def run_e2e(s, g, stages_, **kw):
        return pb.plan_batch_e2e(e2e.shape, e2e.feas, e2e.occ_pts, s, g, cfg,
                                 stages_, n_e, obs_e, res_e, xy_min_e, **kw)

    def e2e_path(scan_dtype, form, seed):
        """The bench's e2e section (svsdf_tpu_torch.bench.bench_e2e) at
        ``scan_dtype`` in this process: it resets the counts, runs, and
        reads them; the kernel is then held at every shape the path
        launched. Returns (the path's launches by form, its ShapeLog)."""
        with SectionLog(cs) as log:
            res = bench_e2e(scan_dtype)
        by_form = res["scan_launches"]
        log.check(torch, f"e2e {form}", seed=seed)
        if res["plan_batch_size"] != batch_e:
            raise AssertionError(f"the e2e path ran at B="
                                 f"{res['plan_batch_size']}, not {batch_e}")
        if min(res["front_ok_share"]) < 1.0:
            raise AssertionError("e2e front end missed goals: "
                                 f"{res['front_ok_share']}")
        front = {k: res.pop(k) for k in ("front_end_s", "whole_s",
                                         "front_end_share")}
        say("e2e", B=batch_e, n=n_e, n_obs=obs_e, iters=iters,
            median_wall_s=statistics.median(res["wall_s"]),
            e2e_plans_per_s=res.pop("e2e_per_s"),
            kernel_launches=sum(by_form.values()),
            launches_per_run=by_form[form] / 4, **res)
        # the front end alone against whole runs, alternated
        say("e2e_front_end", scan=form, **front,
            solve_and_certificate_share=1.0 - front["front_end_share"])
        return by_form, log

    # bench.py::bench_e2e's configuration: default_stages(40), bfloat16
    # scans; one more run under the profiler; then the float32 variant
    e2e_stages = pb.default_stages(iters)
    e2e_by_form, e2e_log = e2e_path("bfloat16", "bfloat16", seed=2000)
    s, g = e2e_draws(e2e.cells, batch_e, np.random.default_rng(0))
    say("e2e_profile", scan="bfloat16", B=batch_e, **profile_solve(
        lambda: float(run_e2e(s, g, e2e_stages).cost.sum())))
    e2e_f32_by_form, e2e_f32_log = e2e_path(None, "float32", seed=2500)

    # -- 7. online replanning ------------------------------------------
    # the JAX package's settings: bfloat16 scans
    product = pb.default_stages(80)

    def replan_once(rp, label, start, goal, stages_, solves):
        """One replan that must succeed; the L-BFGS solves past the
        staged ones are certify-refine re-solves."""
        solves.reset_mock()
        r = rp.replan(start, goal)
        finite = bool(np.isfinite(r.cost) and np.isfinite(r.cert_min)
                      and torch.isfinite(r.traj.coeffs).all())
        if not (r.success and finite):
            raise AssertionError(f"{label}: replan failed")
        return r, solves.call_count - len(stages_)

    def jittered(rp, label, start, goal, stages_, solves, setting):
        """3 replans with start and goal jittered by +-0.25 resolution
        (bench.py::_real_replan's draw): the p50 latency."""
        jr = np.random.default_rng(0)
        jit_r = 0.25 * rp.config.occupancy_resolution
        lat, certs, refine = [], [], []
        for _ in range(3):
            st_ = np.asarray(start) + jr.uniform(-jit_r, jit_r, 2)
            gl_ = np.asarray(goal) + jr.uniform(-jit_r, jit_r, 2)
            t0 = time.perf_counter()
            rj, nr = replan_once(rp, label, st_, gl_, stages_, solves)
            lat.append(time.perf_counter() - t0)
            certs.append(rj.cert_min)
            refine.append(nr)
        say("replan_latency", scenario=label, setting=setting, latency_s=lat,
            replan_p50_s=statistics.median(lat), cert_min=certs,
            refine_solves=refine)

    cs.reset_launches()
    with ShapeLog(cs) as replan_log, mock.patch.object(
            pb.lbfgs, "minimize", wraps=pb.lbfgs.minimize) as solves:
        for name in fixtures.list_synthetic_scenarios():
            sc = fixtures.synthetic_scenario(name)
            rp = OnlineReplanner(sc.config, sc.map_points)
            r, nr = replan_once(rp, sc.name, sc.start[:2], sc.goal[:2],
                                rp.stages, solves)
            say("replan", scenario=sc.name, build_breakdown=rp.build_breakdown,
                n_obs=rp.n_obs, success=r.success, cost=r.cost,
                cert_min=r.cert_min, refine_solves=nr)
            if name == "sdTrapezoid":
                deploy_rp, deploy_sc = rp, sc      # phase 15 replans here
                jittered(rp, sc.name, sc.start[:2], sc.goal[:2], rp.stages,
                         solves, "synthetic gate map, OnlineReplanner's "
                         "default stages (default_stages_lowlat(50), "
                         "bfloat16 scans), n_pieces=8, n_obs capped by the "
                         "map")
        # the JAX package's product operating point (bench.py::_real_replan:
        # n_pieces=12, n_obs=160, default_stages(80), 14 refine rounds,
        # tightness 8), on the forest map with sdHeart: its reference map
        # is not in the repo
        forest_map = mapgen.map_forest(res=0.5, seed=3, n_trees=14)
        rp = OnlineReplanner(PlannerConfig(), forest_map, n_pieces=12,
                             n_obs=160, stages=product, refine_rounds=14,
                             refine_iters=12, tightness_weight=8.0)
        pair = e2e.cells[np.random.default_rng(0).integers(
            0, len(e2e.cells), 2)]
        start_f, goal_f = (e2e.grid.xyz_min[:2] + (pair + 0.5) * res_e)
        forest_ends = (start_f, goal_f)           # phase 16's A* runs here
        r, nr = replan_once(rp, "forest_sdHeart", start_f, goal_f, product,
                            solves)
        forest_traj = r.traj                  # phase 15 senses along it
        say("replan", scenario="forest_sdHeart",
            build_breakdown=rp.build_breakdown, n_obs=rp.n_obs,
            success=r.success, cost=r.cost, cert_min=r.cert_min,
            refine_solves=nr)
        jittered(rp, "forest_sdHeart", start_f, goal_f, product, solves,
                 "forest map, bench.py::_real_replan's settings")
    replan_by_form = dict(cs.coarse_scan.form_launches)
    if replan_by_form["bfloat16"] <= 0:
        raise AssertionError("the replan path launched no bfloat16 "
                             "coarse-scan kernel")
    say("replan_launches", kernel_launches=cs.coarse_scan.launches,
        form_launches=cs.coarse_scan.form_launches)
    replan_log.check(torch, "replan", seed=3000)

    # -- 8. checks of the new paths ------------------------------------
    lowlat = pb.default_stages_lowlat(50, scan_dtype=None)
    cfg_f = PlannerConfig(mem_size=BENCH_MEM_SIZE, kernel_size=15,
                          kernel_yaw_num=8)
    feas3, trans3, cc3 = front_end_maps(e2e.shape, e2e.grid.occ2d, cfg_f)
    if not torch.equal(feas3, e2e.feas):
        raise AssertionError("front_end_maps feas differs from the e2e set-up")
    s32, g32 = e2e_draws(e2e.cells, 32, np.random.default_rng(7))

    def refine_e2e():
        return run_e2e(s32, g32, stages, refine_rounds=2, trans_feas=trans3,
                       cell_cost=cc3, cert_margin=0.25 * cfg_f.safety_hor)

    sc = fixtures.synthetic_scenario("Polygon")
    rp = OnlineReplanner(sc.config, sc.map_points, stages=lowlat)
    replan = lambda: rp.replan(sc.start[:2], sc.goal[:2])
    with mock.patch.object(pb.lbfgs, "minimize",
                           wraps=pb.lbfgs.minimize) as solves:
        e_k = refine_e2e()
    e_refine = solves.call_count - len(stages)
    r_k = replan()
    with mock.patch.object(cs, "coarse_scan", cs.coarse_scan_reference):
        e_p, r_p = refine_e2e(), replan()
    e_cost, e_cert = rel_diff(e_k.cost, e_p.cost), rel_diff(e_k.cert_min,
                                                            e_p.cert_min)
    r_cost = abs(r_k.cost - r_p.cost) / max(1.0, abs(r_p.cost))
    r_cert = abs(r_k.cert_min - r_p.cert_min) / max(1.0, abs(r_p.cert_min))
    if not max(e_cost, e_cert, r_cost, r_cert) <= 1e-3:
        raise AssertionError(f"kernel vs plain: e2e {e_cost} {e_cert}, "
                             f"replan {r_cost} {r_cert}")
    if not bool(e_k.front_ok.all()):
        raise AssertionError("3-D front end missed a goal")
    # feasibility on the card against the host
    ker_d = kops.rasterize_shape_kernels(e2e.shape, 15, 8, 1.0, 0.5)
    ker_h = kops.rasterize_shape_kernels(e2e.shape, 15, 8, 1.0, 0.5,
                                         device="cpu")
    feas_d = kops.feasibility_maps(e2e.grid.occ2d.copy(), ker_d)
    feas_h = kops.feasibility_maps(e2e.grid.occ2d.copy(), ker_h, device="cpu")
    if not (torch.equal(ker_d.cpu(), ker_h)
            and torch.equal(feas_d.cpu(), feas_h)):
        raise AssertionError("feasibility maps differ between card and host")
    say("checks_e2e", B=32, refine_rounds=2, refine_solves=e_refine,
        e2e_cost_rel=e_cost, e2e_cert_rel=e_cert,
        e2e_exact=bool(torch.equal(e_k.cost, e_p.cost)
                       and torch.equal(e_k.cert_min, e_p.cert_min)),
        e2e_median_cert=float(e_k.cert_min.median()),
        replan_cost=[r_k.cost, r_p.cost], replan_cert=[r_k.cert_min,
                                                       r_p.cert_min],
        replan_exact=r_k.cost == r_p.cost and r_k.cert_min == r_p.cert_min,
        feasibility_equal=True, feasible_cells=int(feas_d.sum()))

    # -- 9. single-plan pipeline ---------------------------------------
    svs_rs = SVSDFConfig(**RUN_SCENARIOS_SVS)
    with open(os.path.join(ROOT, "scenario_results.json")) as f:
        recorded = {r["name"]: r for r in json.load(f)}
    lo, hi = COST_GATE

    def gated_plan(planner, sc, rec):
        """One Planner.plan that must succeed, certify, end at the goal
        and pass the cost gate against the recorded row: (result, wall
        seconds, goal error in m)."""
        res, wall = timed(torch, lambda: planner.plan(sc.start, sc.goal))
        ok = bool(res.success and res.certified
                  and lo * rec["final_cost"] < res.final_cost
                  < hi * rec["final_cost"])
        end = trj.pos(res.traj, res.traj.total_duration[:, None])
        goal_err = float((end[0, 0, :2].cpu()
                          - torch.as_tensor(sc.goal[:2])).norm())
        if not (ok and goal_err < 0.05
                and torch.isfinite(res.traj.coeffs).all()):
            raise AssertionError(
                f"{sc.name}: plan success={res.success} certified="
                f"{res.certified} cost={res.final_cost} (recorded "
                f"{rec['final_cost']}) goal_err={goal_err}")
        return res, wall, goal_err

    def stage_s(r):
        return {k: v for k, v in r.timings.items() if k != "attempt_log"}

    def recorded_row(rec):
        return dict(recorded={k: rec.get(k) for k in (
            "success", "certified", "min_cert_sdf", "astar_len", "mid_cost",
            "final_cost")}, cost_gate=[lo * rec["final_cost"],
                                       hi * rec["final_cost"]])

    first_plans = {}
    # the Planners of phases 9, 12, 13 and 14d, whose A* phase 16 holds
    astar_cases = []
    cs.reset_launches()
    with ShapeLog(cs) as plan_log:
        for name in fixtures.list_synthetic_scenarios():
            sc = fixtures.synthetic_scenario(name)
            planner, build_s = timed(torch, lambda: Planner(
                sc.config, sc.map_points, svs_cfg=svs_rs))
            astar_cases.append((sc.name, planner, sc))
            rec = recorded[sc.name]
            runs = []
            # a first plan, then on Circle (a back end runs) a warm one.
            # A warm plan differs from the first only in that the
            # planner's caches serve the map products and the obstacle
            # bucket, code that is the same for every body, so it launches
            # the scan at its first plan's shapes: one warm plan reaches
            # all of it, at a fifth of the time of five
            for _ in range(2 if name == "Circle" else 1):
                runs.append(gated_plan(planner, sc, rec))
            res, first_s, goal_err = runs[0]
            first_plans[sc.name] = res
            warm = {}
            if name == "Circle":        # the scenario that runs a back end
                profiled = (planner, sc)
                w, warm_s, _ = runs[1]
                warm = dict(warm_plan_s=warm_s, warm_timings=stage_s(w),
                            warm_final_cost=w.final_cost)
            say("planner", scenario=sc.name, build_s=build_s,
                first_plan_s=first_s, timings=stage_s(res), **warm,
                astar_len=len(res.astar_path), success=res.success,
                certified=res.certified, min_cert_sdf=res.min_cert_sdf,
                mid_cost=res.mid_cost, final_cost=res.final_cost,
                goal_err_m=goal_err, **recorded_row(rec))
    planner_launches = cs.coarse_scan.launches
    if planner_launches <= 0:
        raise AssertionError("the planner path launched no coarse-scan kernel")
    say("planner_launches", kernel_launches=planner_launches)
    plan_log.check(torch, "planner", seed=4000)
    planner, sc = profiled
    say("planner_profile", scenario=sc.name, **profile_solve(
        lambda: planner.plan(sc.start, sc.goal)))

    # -- 10. the other bodies on a staged solve ------------------------
    h10, t10, o10, x10 = problem(8, 64, 32)
    prob10, x10_t = convert.problem_from_numpy(h10, t10, o10, x10)
    body_launches = {}
    body_logs = {}
    for i, name in enumerate(STAGED_BODIES):
        shape = shapes.make_shape(name)
        cs.reset_launches()
        with ShapeLog(cs) as body_log:
            out, wall = timed(torch, lambda: pb.plan_batch_staged(
                shape, x10_t, prob10, cfg, stages, 8))
        body_launches[name] = cs.coarse_scan.launches
        body_logs[name] = body_log.summary()
        med = float(out.cost.median())
        if body_launches[name] <= 0 or not (
                math.isfinite(med) and torch.isfinite(out.opt_x).all()):
            raise AssertionError(f"{name}: staged solve launches "
                                 f"{body_launches[name]}, median cost {med}")
        say("body_path", shape=name, B=32, wall_s=wall, median_cost=med,
            kernel_launches=body_launches[name])
        body_log.check(torch, f"staged {name}", seed=5000 + 100 * i)

    # -- 11. the grid query --------------------------------------------
    gq = grid_setup()
    svs_grid = SVSDFConfig(coarse_n=256, refine_rounds=3)
    n_grid = len(gq.xs) * len(gq.ys)
    grid_batches = 8
    shifts = torch.as_tensor(np.random.default_rng(1).uniform(
        -0.1, 0.1, (grid_batches, 2, len(gq.xs))).astype(np.float32),
        device="cuda")

    def grid_run(ds, shape=gq.shape):
        """svsdf_grid of ``shape`` on each batch's perturbed axes, summed
        on the card, closed by one host readback."""
        acc = torch.zeros((), device="cuda")
        for d in ds:
            acc = acc + svsdf_grid(shape, gq.traj, gq.xs + d[0],
                                   gq.ys + d[1], svs_grid).sum()
        return float(acc)

    with SectionLog(cs) as grid_log:
        grid_res = bench_grid_queries()
    grid_launches = sum(grid_res["scan_launches"].values())
    grid_log.check(torch, "grid", seed=6000)
    grid_prof = profile_solve(lambda: grid_run(shifts))
    field = svsdf_grid(gq.shape, gq.traj, gq.xs, gq.ys, svs_grid)
    gh = grid_setup(device="cpu", dtype=torch.float64)
    t0 = time.perf_counter()
    field_h = svsdf_grid(gh.shape, gh.traj, gh.xs, gh.ys, svs_grid)
    host_s = time.perf_counter() - t0
    grid_err = float((field.double().cpu() - field_h).abs().max())
    if not (field.shape == (1, len(gq.xs), len(gq.ys))
            and bool(torch.isfinite(field).all()) and grid_err <= 1e-3):
        raise AssertionError(f"grid query field: shape {tuple(field.shape)}, "
                             f"max abs err vs host float64 {grid_err}")
    grid_field = (gq.xs.cpu().numpy(), gq.ys.cpu().numpy(),
                  field[0].cpu().numpy())
    say("grid_query", points=n_grid, batches_per_run=grid_batches,
        coarse_n=svs_grid.coarse_n, refine_rounds=svs_grid.refine_rounds,
        wall_s=grid_res["wall_s"], queries_per_s=grid_res["queries_per_s"],
        grid_batch_s=grid_res["grid_batch_s"], kernel_launches=grid_launches,
        scan_share_of_device=grid_prof["scan_device_s"]
        / grid_prof["device_busy_s"], profile=grid_prof,
        max_abs_err_vs_host_f64=grid_err, host_f64_s=host_s)

    # -- 12. deformable robots ----------------------------------------
    cs.reset_launches()
    with ShapeLog(cs) as deform_log:
        for name in fixtures.list_deformable_scenarios():
            sc = fixtures.deformable_scenario(name)
            planner, build_s = timed(torch, lambda: Planner(
                sc.config, sc.map_points, svs_cfg=svs_rs, shape=sc.shape))
            astar_cases.append((sc.name, planner, sc))
            rec = recorded[sc.name]
            res, plan_s, goal_err = gated_plan(planner, sc, rec)
            say("deformable", scenario=sc.name, build_s=build_s,
                plan_s=plan_s, timings=stage_s(res),
                astar_len=len(res.astar_path), success=res.success,
                certified=res.certified, min_cert_sdf=res.min_cert_sdf,
                mid_cost=res.mid_cost, final_cost=res.final_cost,
                goal_err_m=goal_err, **recorded_row(rec))
    deform_launches = cs.coarse_scan.form_launches["scaled_float32"]
    if deform_launches <= 0:
        raise AssertionError("the deformable plans launched no deformable "
                             "coarse-scan kernel")
    say("deformable_launches", kernel_launches=cs.coarse_scan.launches,
        form_launches=cs.coarse_scan.form_launches)
    deform_log.check(torch, "deformable planner", seed=7000)
    # the deformable form timed where those plans launched it
    deform_shape_times = path_scan_times(torch, cs, deform_log, seed=7100)
    say("deformable_scan_times", rows=deform_shape_times)
    # each deformable robot through a staged solve with bfloat16 scans
    cs.reset_launches()
    with ShapeLog(cs) as deform_staged_log:
        for name in fixtures.list_deformable_scenarios():
            shape = fixtures.deformable_scenario(name).shape
            out, wall = timed(torch, lambda: pb.plan_batch_staged(
                shape, x10_t, prob10, cfg, pb.default_stages(iters), 8))
            med = float(out.cost.median())
            if not (math.isfinite(med) and torch.isfinite(out.opt_x).all()):
                raise AssertionError(f"{name}: staged solve median {med}")
            say("deformable_staged", scenario=name, B=32, wall_s=wall,
                median_cost=med)
    deform_bf16_launches = cs.coarse_scan.form_launches["scaled_bfloat16"]
    if deform_bf16_launches <= 0:
        raise AssertionError("the deformable staged solves launched no "
                             "deformable bfloat16 coarse-scan kernel")
    say("deformable_staged_launches", kernel_launches=cs.coarse_scan.launches,
        form_launches=cs.coarse_scan.form_launches)
    deform_staged_log.check(torch, "deformable staged", seed=7500)

    # -- 13. the LMBM back end -----------------------------------------
    cs.reset_launches()
    with ShapeLog(cs) as lmbm_log:
        sc = fixtures.synthetic_scenario("Circle")
        planner = Planner(sc.config, sc.map_points, svs_cfg=svs_rs,
                          solver="lmbm")
        astar_cases.append((f"lmbm {sc.name}", planner, sc))
        rec = recorded[sc.name]
        res, plan_s, goal_err = gated_plan(planner, sc, rec)
    if not res.timings["back_s"] > 0.0:
        raise AssertionError("the LMBM plan ran no back end")
    lmbm_launches = cs.coarse_scan.launches
    if lmbm_launches <= 0:
        raise AssertionError("the LMBM plan launched no coarse-scan kernel")
    say("lmbm_planner", scenario=sc.name, solver="lmbm", plan_s=plan_s,
        timings=stage_s(res), success=res.success, certified=res.certified,
        min_cert_sdf=res.min_cert_sdf, mid_cost=res.mid_cost,
        final_cost=res.final_cost, goal_err_m=goal_err,
        kernel_launches=lmbm_launches, **recorded_row(rec))
    lmbm_log.check(torch, "lmbm planner", seed=8000)

    # -- 14. mesh robots -----------------------------------------------
    # (c) the main path with the sdHeart prism, bfloat16 then float32, on
    # phase 4's problem
    h, tl, obs, x0 = problem(n, m_obs, batch)
    prob, x0_t = convert.problem_from_numpy(h, tl, obs, x0)

    def mesh_main_path(stages_, form, seed, runs):
        """Phase 4's solve with the mesh robot: one warm-up and ``runs``
        timed runs, counted from 0, then the kernel held at every shape
        the path launched. Returns (the path's launches of ``form``, its
        ShapeLog, its summary)."""
        cs.reset_launches()
        with ShapeLog(cs) as log:
            float(pb.plan_batch_staged(heart_mesh, x0_t, prob, cfg, stages_,
                                       n).cost.sum())
            rng = np.random.default_rng(1)
            walls, costs = [], []
            for _ in range(runs):
                xx = x0_t + torch.as_tensor(
                    rng.uniform(-1e-3, 1e-3, x0.shape).astype(np.float32),
                    device="cuda")
                t0 = time.perf_counter()
                out = pb.plan_batch_staged(heart_mesh, xx, prob, cfg,
                                           stages_, n)
                float(out.cost.sum())
                walls.append(time.perf_counter() - t0)
                costs.append(float(out.cost.median()))
        total = cs.coarse_scan.launches
        by_form = dict(cs.coarse_scan.form_launches)
        if by_form[form] <= 0:
            raise AssertionError(f"the mesh main path ({form} scans) "
                                 "launched no coarse-scan kernel of that form")
        if not (torch.isfinite(out.cost).all()
                and torch.isfinite(out.opt_x).all()):
            raise AssertionError("mesh main path output not finite")
        log.check(torch, f"mesh main {form}", seed=seed)
        wall = statistics.median(walls)
        row = dict(scan=form, B=batch, n=n, M=m_obs, iters=iters,
                   wall_s=walls, median_wall_s=wall,
                   plans_per_s=batch / wall,
                   median_final_cost=statistics.median(costs),
                   kernel_launches=total, form_launches=by_form)
        return by_form[form], log, row

    mesh_bf16_launches, mesh_bf16_log, row = mesh_main_path(
        pb.default_stages(iters), "bfloat16", seed=9100, runs=3)
    say("mesh_main_path", robot=heart_mesh.name,
        analytic_sdHeart_median_cost=bf16_cost, **row)
    # the float32 variant with one timed run: the script's time budget
    mesh_launches, mesh_log, row = mesh_main_path(stages, "float32",
                                                  seed=9000, runs=1)
    say("mesh_main_path", robot=heart_mesh.name,
        analytic_sdHeart_median_cost=main_cost, **row)
    with_kernel = pb.plan_batch_staged(heart_mesh, x_s, prob_s, cfg, stages,
                                       n)
    with mock.patch.object(cs, "coarse_scan", cs.coarse_scan_reference):
        with_plain = pb.plan_batch_staged(heart_mesh, x_s, prob_s, cfg,
                                          stages, n)
    mk, mp = float(with_kernel.cost.median()), float(with_plain.cost.median())
    rel = abs(mk - mp) / abs(mp)
    if not rel <= 1e-3:
        raise AssertionError(f"mesh kernel vs plain scan solve: rel {rel}")
    say("mesh_checks", B=small, median_cost_kernel=mk, median_cost_plain=mp,
        rel_diff=rel, exact=mk == mp)

    # (d) Planner.plan with the cylinder on synthetic_Circle's map
    sc = fixtures.synthetic_scenario("Circle")
    cyl_cfg = dataclasses.replace(sc.config, inputdata=mesh_obj["cylinder"])
    cs.reset_launches()
    with ShapeLog(cs) as mesh_plan_log:
        planner, build_s = timed(torch, lambda: Planner(
            cyl_cfg, sc.map_points, svs_cfg=svs_rs))
        if planner.shape.name != mesh["cylinder"].name:
            raise AssertionError(f"the planner's robot is {planner.shape.name}")
        astar_cases.append((f"mesh {sc.name}", planner, sc))
        rec = recorded[sc.name]
        res, plan_s, goal_err = gated_plan(planner, sc, rec)
    mesh_plan_launches = cs.coarse_scan.launches
    if mesh_plan_launches <= 0:
        raise AssertionError("the mesh plan launched no coarse-scan kernel")
    circle = first_plans[sc.name]
    say("mesh_planner", scenario=sc.name, robot=planner.shape.name,
        build_s=build_s, plan_s=plan_s, timings=stage_s(res),
        astar_len=len(res.astar_path), success=res.success,
        certified=res.certified, min_cert_sdf=res.min_cert_sdf,
        mid_cost=res.mid_cost, final_cost=res.final_cost,
        goal_err_m=goal_err, kernel_launches=mesh_plan_launches,
        form_launches=cs.coarse_scan.form_launches,
        analytic_circle=dict(final_cost=circle.final_cost,
                             min_cert_sdf=circle.min_cert_sdf),
        **recorded_row(rec))
    mesh_plan_log.check(torch, "mesh planner", seed=9200)
    # (d) the cylinder's replan on the same map, with the kernel and with
    # the plain scan
    rp_cyl = OnlineReplanner(cyl_cfg, sc.map_points)
    cs.reset_launches()
    with ShapeLog(cs) as mesh_replan_log:
        rk, rk_s = timed(torch, lambda: rp_cyl.replan(sc.start[:2],
                                                       sc.goal[:2]))
    mesh_replan_by_form = dict(cs.coarse_scan.form_launches)
    with mock.patch.object(cs, "coarse_scan", cs.coarse_scan_reference):
        rpl, rpl_s = timed(torch, lambda: rp_cyl.replan(sc.start[:2],
                                                         sc.goal[:2]))
    rel_cost = abs(rk.cost - rpl.cost) / abs(rpl.cost)
    rel_cert = abs(rk.cert_min - rpl.cert_min) / abs(rpl.cert_min)
    if not (rk.success and rpl.success and rk.cert_min > 0
            and cs.coarse_scan.launches > 0
            and max(rel_cost, rel_cert) <= 1e-3):
        raise AssertionError(f"cylinder replan: kernel {rk.cost} / "
                             f"{rk.cert_min}, plain {rpl.cost} / "
                             f"{rpl.cert_min}, launches "
                             f"{cs.coarse_scan.launches}")
    say("mesh_replan", scenario=sc.name, robot=rp_cyl.shape.name,
        build_breakdown=rp_cyl.build_breakdown, replan_s=rk_s,
        plain_replan_s=rpl_s, success=rk.success, cost=rk.cost,
        cert_min=rk.cert_min, plain_cost=rpl.cost,
        plain_cert_min=rpl.cert_min, rel_diff_cost=rel_cost,
        rel_diff_cert=rel_cert, kernel_launches=sum(
            mesh_replan_by_form.values()), form_launches=mesh_replan_by_form)
    mesh_replan_log.check(torch, "mesh replan", seed=9300)

    # (e) the grid query with the sdHeart prism
    cs.reset_launches()
    with ShapeLog(cs) as mesh_grid_log:
        grid_run(shifts, heart_mesh)
        walls = []
        for i in range(3):
            walls.append(timed(torch, lambda: grid_run(
                shifts + 1e-5 * (i + 1), heart_mesh))[1])
    mesh_grid_launches = cs.coarse_scan.launches
    if mesh_grid_launches <= 0:
        raise AssertionError("the mesh grid query launched no coarse-scan "
                             "kernel")
    mesh_grid_log.check(torch, "mesh grid", seed=9300)
    field = svsdf_grid(heart_mesh, gq.traj, gq.xs, gq.ys, svs_grid)
    t0 = time.perf_counter()
    field_h = svsdf_grid(heart_mesh, gh.traj, gh.xs, gh.ys, svs_grid)
    host_s = time.perf_counter() - t0
    grid_err = float((field.double().cpu() - field_h).abs().max())
    if not (field.shape == (1, len(gq.xs), len(gq.ys))
            and bool(torch.isfinite(field).all()) and grid_err <= 1e-3):
        raise AssertionError(f"mesh grid query field: shape "
                             f"{tuple(field.shape)}, max abs err vs host "
                             f"float64 {grid_err}")
    wall = statistics.median(walls)
    say("mesh_grid_query", robot=heart_mesh.name, points=n_grid,
        batches_per_run=grid_batches, wall_s=walls,
        queries_per_s=grid_batches * n_grid / wall,
        analytic_sdHeart_queries_per_s=grid_res["queries_per_s"],
        kernel_launches=mesh_grid_launches,
        max_abs_err_vs_host_f64=grid_err, host_f64_s=host_s)

    # (f) the 3-D swept volume of (d)'s plan (export_swept_3d's settings)
    t0 = time.perf_counter()
    V, F = mesh_sdf.load_obj(mesh_obj["cylinder"])
    g3 = mesh_sdf.grid_sdf_3d(V, F, resolution=SWEPT_3D["resolution"],
                              margin=SWEPT_3D["margin"])
    grid3_s = time.perf_counter() - t0
    traj = res.traj
    total = float(traj.total_duration[0])
    xy = trj.pos(traj, torch.linspace(0.0, total, 64, device="cuda")[None]
                 .to(traj.coeffs.dtype))[0, :, :2].cpu().numpy()
    r = float(np.abs(V[:, :2]).max()) + 0.5
    bounds = (xy[:, 0].min() - r, xy[:, 0].max() + r, xy[:, 1].min() - r,
              xy[:, 1].max() + r, float(V[:, 2].min()) - 0.3,
              float(V[:, 2].max()) + 0.3)
    sweep = lambda tr: sw.swept_field_3d(g3.sdf_xyz, tr, bounds,
                                         SWEPT_3D["eps"], SWEPT_3D["n_t"])
    (xs3, ys3, zs3, field3), card_s = timed(torch, lambda: sweep(traj))
    t0 = time.perf_counter()
    field3_h = sweep(trj.Trajectory(traj.coeffs.cpu(),
                                    traj.durations.cpu()))[3]
    host3_s = time.perf_counter() - t0
    err3 = float(np.abs(field3 - field3_h).max())
    Vs, Fs = sw.marching_tetrahedra(xs3, ys3, zs3, field3)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    obj_path = os.path.join(out_dir, "swept_mesh_cylinder.obj")
    sw.write_trimesh_obj(Vs, Fs, obj_path)
    if not (np.isfinite(field3).all() and err3 <= 1e-5
            and sw.is_watertight(Fs)):
        raise AssertionError(f"3-D swept volume: card vs host {err3}, "
                             f"watertight {sw.is_watertight(Fs)}")
    say("mesh_swept_3d", robot=mesh["cylinder"].name,
        grid3=f"{g3.nx}x{g3.ny}x{g3.nz}", grid3_s=grid3_s,
        field=list(field3.shape), card_s=card_s, host_s=host3_s,
        max_abs_err_vs_host=err3, vertices=len(Vs), triangles=len(Fs),
        watertight=True, obj=os.path.relpath(obj_path, ROOT))
    mesh_dir.cleanup()

    # -- 15. the deployment loop ---------------------------------------
    cs.reset_launches()
    with ShapeLog(cs) as deploy_log:
        circle = fixtures.synthetic_scenario("Circle")
        deploy = deployment_loop(
            torch, deploy_rp, deploy_sc, fleet,
            ("forest_sdHeart", forest_map, forest_traj),
            [("synthetic_Circle", circle.config, circle.map_points, ()),
             ("forest_sdHeart", PlannerConfig(), forest_map, (2, 4))],
            torch.device("cuda"), out_dir)
    deploy_by_form = dict(cs.coarse_scan.form_launches)
    if deploy_by_form["bfloat16"] <= 0 or deploy_by_form["float32"] <= 0:
        raise AssertionError("the deployment loop's replan and live solve "
                             f"launched {deploy_by_form} coarse scans")
    for step, line in deploy.items():
        say(step, **line)
    say("deploy_launches", kernel_launches=cs.coarse_scan.launches,
        form_launches=deploy_by_form)
    deploy_log.check(torch, "deployment", seed=9500)

    # -- 16. the host runtime, multi-process planning ------------------
    runtime_phase(torch, astar_cases, forest_map, forest_ends, grid_field)
    sharded_launches = sharded_phase(torch, e2e)

    def sharded_by_path(form):
        return {path: k for (path, fm), k in sharded_launches.items()
                if fm == form and k > 0}

    def kernel_entry(form, launches_, t, **extra):
        """The kernel table's entry of one form, timed at ``t``."""
        return {"name": "svsdf_coarse_scan" + (
                    "" if form == "float32" else f"_{form}"),
                "route": "cuda",
                "source": "svsdf_tpu_torch/csrc/coarse_scan.cu",
                "replaces": "svsdf_tpu/ops/pallas_svsdf.py:54",
                "launches": launches_,
                "max_abs_err": ShapeLog.worst.get(form, 0.0),
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": None, "timed_at": [t["B"], t["M"], t["K"]],
                **extra}

    # the XLA table scan the JAX package runs where its Pallas kernel
    # refuses (bfloat16, a time-varying shape)
    xla_scan = "svsdf_tpu/ops/svsdf.py:140"
    print(json.dumps({"kernels": [
        kernel_entry(
            "float32", launches, timings[0],
            launches_by_path={"main": launches,
                              "e2e": e2e_by_form["float32"],
                              "e2e_float32": e2e_f32_by_form["float32"],
                              "replan": replan_by_form["float32"],
                              "planner": planner_launches,
                              "staged_bodies": body_launches,
                              "grid": grid_launches,
                              "lmbm_planner": lmbm_launches,
                              "deployment": deploy_by_form["float32"],
                              **sharded_by_path("float32")},
            shapes_ran={"main": main_log.summary("float32"),
                        "e2e": e2e_log.summary("float32"),
                        "e2e_float32": e2e_f32_log.summary("float32"),
                        "replan": replan_log.summary("float32"),
                        "planner": plan_log.summary(),
                        "staged_bodies": body_logs,
                        "grid": grid_log.summary(),
                        "lmbm_planner": lmbm_log.summary(),
                        "deployment": deploy_log.summary("float32")},
            main_path_median_cost=main_cost, bodies=body_times,
            scan_times=timings,
            grid_scan=next(t for t in timings if t["path"] == "grid")),
        kernel_entry(
            "bfloat16", bf16_launches, form_times["bfloat16"][0],
            counterpart_of=xla_scan,
            launches_by_path={"main": bf16_launches,
                              "e2e": e2e_by_form["bfloat16"],
                              "replan": replan_by_form["bfloat16"],
                              "deployment": deploy_by_form["bfloat16"],
                              **sharded_by_path("bfloat16")},
            shapes_ran={"main": bf16_log.summary("bfloat16"),
                        "e2e": e2e_log.summary("bfloat16"),
                        "replan": replan_log.summary("bfloat16"),
                        "deployment": deploy_log.summary("bfloat16")},
            main_path_median_cost=bf16_cost,
            grid_scan=form_times["bfloat16"][1]),
        kernel_entry(
            "scaled_float32", deform_launches,
            form_times["scaled_float32"][0], counterpart_of=xla_scan,
            shapes_ran={"deformable_planner":
                        deform_log.summary("scaled_float32")},
            launches_by_shape=deform_log.by_shape("scaled_float32"),
            timed_shapes=[dict(t, launches_x_ms_over_bound=excess(
                t, deform_log.by_shape("scaled_float32")))
                for t in form_times["scaled_float32"]],
            floor_ms={"x".join(map(str, sh)): v
                      for sh, v in floor_ms.items()},
            div_mismatches=division,
            path_shapes=deform_shape_times),
        kernel_entry(
            "scaled_bfloat16", deform_bf16_launches,
            form_times["scaled_bfloat16"][0], counterpart_of=xla_scan,
            shapes_ran={"deformable_staged":
                        deform_staged_log.summary("scaled_bfloat16")}),
        # the grid body: a mesh robot's scans, counted over phase 14's paths
        kernel_entry(
            "grid_float32", mesh_launches, form_times["grid_float32"][0],
            counterpart_of=xla_scan,
            launches_by_path={"mesh_main": mesh_launches,
                              "mesh_planner": mesh_plan_launches,
                              "mesh_grid": mesh_grid_launches,
                              "mesh_replan": mesh_replan_by_form["float32"]},
            shapes_ran={"mesh_main": mesh_log.summary("float32"),
                        "mesh_planner": mesh_plan_log.summary(),
                        "mesh_grid": mesh_grid_log.summary(),
                        "mesh_replan": mesh_replan_log.summary("float32")},
            launches_by_shape={
                "mesh_main": mesh_log.by_shape("float32"),
                "mesh_planner": mesh_plan_log.by_shape(),
                "mesh_grid": mesh_grid_log.by_shape(),
                "mesh_replan": mesh_replan_log.by_shape("float32")},
            timed_shapes=form_times["grid_float32"],
            grid_scan=form_times["grid_float32"][-1]),
        kernel_entry(
            "grid_bfloat16", mesh_bf16_launches,
            form_times["grid_bfloat16"][0], counterpart_of=xla_scan,
            launches_by_path={"mesh_main": mesh_bf16_launches,
                              "mesh_replan": mesh_replan_by_form["bfloat16"]},
            shapes_ran={"mesh_main": mesh_bf16_log.summary("bfloat16"),
                        "mesh_replan": mesh_replan_log.summary("bfloat16")},
            launches_by_shape={
                "mesh_main": mesh_bf16_log.by_shape("bfloat16"),
                "mesh_replan": mesh_replan_log.by_shape("bfloat16")},
            timed_shapes=form_times["grid_bfloat16"],
            grid_scan=form_times["grid_bfloat16"][-1]),
    ]}), flush=True)
    print(json.dumps({"minco_cr": {
        "source": "svsdf_tpu_torch/csrc/minco_cr.cu",
        "replaces": None, "counterpart_of": "svsdf_tpu/ops/block_cr.py",
        "timed": minco_times, "launches_by_path": ShapeLog.minco_by_path,
        "library": "torch.linalg.solve of the dense system (each timed "
                   "row's library_ms)"}}), flush=True)
    memo_root.cleanup()
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
