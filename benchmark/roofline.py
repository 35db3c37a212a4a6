"""The coarse-scan kernel's least time: the yardstick of the
``scan_roofline.*`` metrics.

Operations are counted from the function the kernel computes, per SDF
evaluation of one pose and one point (PERF.md section 6, counted from
csrc/coarse_scan.cu): the pose transform 11, the running-min compare 1
and the body's own. sqrt, abs, min, max, compare and select count one
each. The grid body (a mesh robot) counts the function as
models/mesh_sdf.py GridSDF2D.sdf_xy states it; in its bfloat16 form
OPS_GRID_BF16 of them are bfloat16 operations and the rest float32 or
integer.

Peaks: the published H100 SXM rates, 67e12 float32 operations/s outside
the tensor cores and twice that for packed bfloat16 (both count a fused
multiply-add as two operations, so a function counted one operation at a
time stays under them however an implementation fuses it), and 3.35e12
HBM bytes/s. Bytes: each input read once (points, the pose table, a mesh
robot's grid) and each output written once (min, argmin as int64, the two
neighbours).
"""

from __future__ import annotations

PEAK_F32_OPS = 67e12
PEAK_BF16_OPS = 2 * PEAK_F32_OPS
PEAK_BYTES = 3.35e12

#: operations per evaluation, pose transform and compare included
OPS_PER_EVAL = {"sdHeart": 43, "grid": 81}
#: of the grid body's operations, those in bfloat16 in its bfloat16 form
OPS_GRID_BF16 = 48


def least_seconds(launch: dict) -> float:
    """The least time of one launch ``launch`` (trace.scan_launches'
    record): the larger of its operations over their peaks and its bytes
    over the HBM rate."""
    b, m, k = launch["b"], launch["m"], launch["k"]
    n = OPS_PER_EVAL[launch["body"]]
    if not launch["bf16"]:
        n16, n32 = 0, n
    elif launch["body"] == "grid":
        n16, n32 = OPS_GRID_BF16, n - OPS_GRID_BF16
    else:
        n16, n32 = n, 0
    ops_s = b * m * k * (n16 / PEAK_BF16_OPS + n32 / PEAK_F32_OPS)
    nbytes = b * m * 2 * 4 + b * k * 4 * 4 + b * m * (3 * 4 + 8) \
        + launch["grid_bytes"]
    return max(ops_s, nbytes / PEAK_BYTES)
