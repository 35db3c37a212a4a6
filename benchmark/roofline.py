"""The coarse-scan kernel's least time: the yardstick of the
``scan_roofline.*`` metrics.

Operations are counted from the function the kernel computes, per SDF
evaluation of one pose and one point (PERF.md section 6, counted from
csrc/coarse_scan.cu): the pose transform 11, the running-min compare 1
and the body's own. sqrt, abs, min, max, compare and select count one
each. An analytic body's count is its file's (``bodies/<name>.py``:
``OPS``, and ``OPS_F32_IN_BF16`` of them float32 in its bfloat16 form).
The grid body (a mesh robot) counts the function as models/mesh_sdf.py
GridSDF2D.sdf_xy states it; in its bfloat16 form OPS_GRID_BF16 of them
are bfloat16 operations and the rest float32 or integer. A deformable
robot's launch (``scaled``) adds OPS_SCALED in the scan's type.

Peaks: the published H100 SXM rates, 67e12 float32 operations/s outside
the tensor cores and twice that for packed bfloat16 (both count a fused
multiply-add as two operations, so a function counted one operation at a
time stays under them however an implementation fuses it), and 3.35e12
HBM bytes/s. Bytes: each input read once (points, the pose table, a
deformable robot's (B, K) float32 scale table, a mesh robot's grid) and
each output written once (min, argmin as int64, the two neighbours).
"""

from __future__ import annotations

from benchmark import reference as ref

PEAK_F32_OPS = 67e12
PEAK_BF16_OPS = 2 * PEAK_F32_OPS
PEAK_BYTES = 3.35e12

#: the grid body's operations per evaluation, pose transform and compare
#: included, and those of them in bfloat16 in its bfloat16 form
OPS_GRID = 81
OPS_GRID_BF16 = 48
#: a deformable robot's operations per evaluation past the body's: the
#: two divisions q / s and the product s * f
OPS_SCALED = 3


def ops_by_type(launch: dict) -> tuple[int, int]:
    """(bfloat16, float32) operations per evaluation of one launch."""
    if launch["body"] == "grid":
        n, n32_in_bf16 = OPS_GRID, OPS_GRID - OPS_GRID_BF16
    else:
        body = ref.body_file(launch["body"])
        n, n32_in_bf16 = body.OPS, body.OPS_F32_IN_BF16
    n += OPS_SCALED * launch["scaled"]
    if not launch["bf16"]:
        return 0, n
    return n - n32_in_bf16, n32_in_bf16


def least_seconds(launch: dict) -> float:
    """The least time of one launch ``launch`` (trace.scan_launches'
    record): the larger of its operations over their peaks and its bytes
    over the HBM rate."""
    b, m, k = launch["b"], launch["m"], launch["k"]
    n16, n32 = ops_by_type(launch)
    ops_s = b * m * k * (n16 / PEAK_BF16_OPS + n32 / PEAK_F32_OPS)
    nbytes = b * m * 2 * 4 + b * k * 4 * 4 + b * m * (3 * 4 + 8) \
        + launch["grid_bytes"] + launch["scaled"] * b * k * 4
    return max(ops_s, nbytes / PEAK_BYTES)
