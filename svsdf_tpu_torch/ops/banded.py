"""Band-storage constants of the MINCO continuity system
(svsdf_tpu/ops/banded.py).

Band storage: bands[..., i, d] = M[i, i + d - LBW] for d in [0, 13),
so d = 6 is the main diagonal. The sequential banded-LU solver of the
JAX package is not ported yet; the hot path uses ops/block_cr.py.
"""

LBW = 6          # lower bandwidth
UBW = 6          # upper bandwidth
NDIAG = LBW + UBW + 1
