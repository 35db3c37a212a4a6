"""MINCO's block cyclic-reduction solve as one CUDA kernel a direction.

``ops/block_cr.py::_BandedSolveCR`` runs this module on a CUDA tensor:
``forward`` is its forward solve (``_cr_core(bands, rhs, REFINE,
False)``) and ``backward`` its backward pass (the transposed solve and
the band gradient), each one launch of the hand-written kernel in
``csrc/minco_cr.cu`` (built with nvcc for sm_90a at first use into
build/kernels/ and loaded with ctypes, as ``ops/cuda_svsdf.py`` builds
the coarse scan). A tensor the kernel does not take raises; there is no
fallback. CPU tensors never come here: they take block_cr's plain
version.

``launches`` counts the launches by direction (plain integers;
``reset_launches`` zeroes them). ``geometry`` is the launch shape the
wrapper picks from N, D and the dtype. ``host_solve`` runs the kernel's
source compiled for the host with g++ (one lane a plan): the CPU tests
hold that arithmetic against the plain version.

The kernel source note says what bounds it and how it is laid out.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from svsdf_tpu_torch.ops import cuda_svsdf
from svsdf_tpu_torch.ops.banded import NDIAG

SOURCE = cuda_svsdf._PKG / "csrc" / "minco_cr.cu"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
#: the host build of the same source (host_solve)
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-x", "c++")

#: right-hand-side columns the kernel takes
MAX_COLS = 4
DTYPES = (torch.float32, torch.float64)


def build():
    """Compile csrc/minco_cr.cu into build/kernels/ (once per source
    content). Returns (library path, compiler log; empty if cached)."""
    return cuda_svsdf.compile_library(SOURCE, [cuda_svsdf._nvcc()],
                                      NVCC_FLAGS, "libsvsdf_minco_cr")


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(build()[0]))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.svsdf_minco_cr_geometry.argtypes = [ci, ci, ci, ci, vp]
    lib.svsdf_minco_cr.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                   ci, ci, ci, vp]
    for fn in (lib.svsdf_minco_cr_geometry, lib.svsdf_minco_cr):
        fn.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def geometry(device_index: int, n: int, d: int, dtype: torch.dtype,
             backward: bool) -> tuple[int, int]:
    """(values a plan's working set takes in shared memory, plans a
    block) of a launch at N pieces and D columns on the card
    ``device_index``; 0 plans a block where one plan's working set passes
    a block's shared memory."""
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(device_index):
        rc = _library().svsdf_minco_cr_geometry(
            n, d, int(dtype == torch.float64), int(backward), out)
    if rc != 0:
        raise RuntimeError(f"MINCO CR kernel geometry failed: cudaError {rc}"
                           f" (N={n}, D={d}, {dtype})")
    return out[0], out[1]


def _check(bands, *vecs):
    """(B, N, D) of checked inputs: bands (B, 6N, 13) and each of vecs
    (B, 6N, D), contiguous float32 or float64 CUDA tensors of one dtype
    on one device, N >= 1, 1 <= D <= 4. The plan's working set must fit
    a block's shared memory: ``_launch`` refuses a larger one."""
    tensors = (bands, *vecs)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("MINCO CR kernel takes CUDA tensors")
    if any(t.device != bands.device for t in tensors):
        raise ValueError("MINCO CR kernel inputs lie on different devices")
    if bands.dtype not in DTYPES or any(t.dtype != bands.dtype
                                        for t in tensors):
        raise TypeError("MINCO CR kernel takes float32 or float64 tensors of"
                        " one dtype")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("MINCO CR kernel takes contiguous tensors")
    if bands.dim() != 3 or bands.shape[2] != NDIAG or bands.shape[1] < 6 \
            or bands.shape[1] % 6:
        raise ValueError("MINCO CR bands: (B, 6N, 13) with N >= 1, got "
                         f"{tuple(bands.shape)}")
    b, n6 = bands.shape[:2]
    d = vecs[0].shape[-1] if vecs[0].dim() == 3 else 0
    if not 1 <= d <= MAX_COLS or any(tuple(v.shape) != (b, n6, d)
                                     for v in vecs):
        raise ValueError(f"MINCO CR right-hand sides: (B, 6N, D) with 1 <= D"
                         f" <= {MAX_COLS} beside bands {tuple(bands.shape)},"
                         f" got {[tuple(v.shape) for v in vecs]}")
    return b, n6 // 6, d


def _launch(bands, rhs, xf, refine: int, transpose: bool):
    b, n, d = _check(bands, rhs) if xf is None else _check(bands, rhs, xf)
    out = torch.empty_like(rhs)
    bbar = None if xf is None else torch.empty_like(bands)
    if b == 0:
        return out, bbar
    dev = bands.device
    ws, warps = geometry(dev.index, n, d, bands.dtype, xf is not None)
    if warps == 0:
        raise ValueError(f"MINCO CR kernel: a plan at N={n}, D={d} in "
                         f"{bands.dtype} takes {ws * bands.element_size()} "
                         "bytes, past a block's shared memory")
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _library().svsdf_minco_cr(
            ptr(bands), ptr(rhs), ptr(xf), ptr(out), ptr(bbar), b, n, d,
            refine, int(transpose), int(bands.dtype == torch.float64), ws,
            warps, stream)
    if rc != 0:
        raise RuntimeError(f"MINCO CR kernel launch failed: cudaError {rc} "
                           f"(B={b}, N={n}, D={d}, {bands.dtype}, {warps} "
                           "plans a block)")
    launches["backward" if xf is not None else "forward"] += 1
    return out, bbar


def forward(bands, rhs, refine: int):
    """x solving M x = rhs, M (B, 6N, 13) in band storage: one launch of
    the kernel's forward solve with ``refine`` refinement rounds."""
    return _launch(bands, rhs, None, refine, False)[0]


def backward(bands, x, x_bar, refine: int):
    """(bands_bar, rhs_bar) of the solve x = M^-1 rhs: rhs_bar solves
    M^T rhs_bar = x_bar, bands_bar[i, d] = -rhs_bar[i] . x[i + d - 6] on
    the 13 bands (0 outside the matrix). One launch."""
    rhs_bar, bands_bar = _launch(bands, x_bar, x, refine, True)
    return bands_bar, rhs_bar


def work(n: int, d: int, refine: int, backward: bool,
         itemsize: int = 4) -> tuple[int, int]:
    """(floating-point operations, bytes) of one plan's launch in one
    direction at N pieces and D columns: the operations the kernel's
    algorithm performs (an FMA counts two; a division, an abs, a max and a
    clamp one each), and its bytes read and written once (bands and
    right-hand side in, x out; backward: bands, x and x_bar in, rhs_bar
    and the band gradient out)."""
    n6 = 6 * n
    # the band entries inside the matrix (the others are 0 in the blocks)
    inside = sum(min(i + 7, n6) - max(i - 6, 0) for i in range(n6))
    ops = n6 * 27 + 2 * inside + 2 * inside       # r, c, scaled blocks
    sweep = 0
    n_l = n
    while n_l > 1:
        n_odd, n_next = n_l // 2, (n_l + 1) // 2
        ops += n_odd * 87 * 12                    # Gauss-Jordan columns
        for k in range(n_next):
            left, right = k >= 1, 2 * k + 1 < n_l
            ops += 36 * 12 * (2 * left + right + (right and k < n_next - 1))
            sweep += 6 * d * 12 * (left + right)  # d' of the even block
        sweep += n_odd * d * 72                   # the odd blocks' Sd
        sweep += sum(6 * d * 12 * (1 + (k + 1 < n_next))
                     for k in range(n_odd))       # back-substitution
        n_l = n_next
    ops += 15 * 12 + d * 72                       # the last level
    sweep += 2 * n6 * d                           # pre and post scaling
    ops += (1 + refine) * sweep + refine * d * (2 * inside + n6)
    nbytes = itemsize * (n6 * NDIAG + 2 * n6 * d)
    if backward:
        ops += inside * 2 * d                     # the band gradient
        nbytes += itemsize * (n6 * NDIAG + n6 * d)
    return ops, nbytes


def reset_launches() -> None:
    """Zero the launch counts of both directions."""
    launches.update(forward=0, backward=0)


#: kernel launches since the last reset_launches, by direction
launches = {"forward": 0, "backward": 0}


@functools.lru_cache(maxsize=None)
def _host_library():
    lib = ctypes.CDLL(str(cuda_svsdf.compile_library(
        SOURCE, ["g++"], GXX_FLAGS, "libsvsdf_minco_cr_host")[0]))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.svsdf_minco_cr_host.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci,
                                        ci, ci]
    lib.svsdf_minco_cr_host.restype = ci
    return lib


def host_solve(bands, rhs, refine: int, transpose: bool = False, x=None):
    """The kernel's arithmetic on the host: csrc/minco_cr.cu compiled with
    g++, one lane a plan. Contiguous CPU tensors in the kernel's shapes and
    dtypes. Returns the solution of M y = rhs (M^T if ``transpose``) and,
    given the forward solution ``x``, the band gradient beside it."""
    tensors = [t for t in (bands, rhs, x) if t is not None]
    if any(t.is_cuda or not t.is_contiguous() or t.dtype != bands.dtype
           for t in tensors) or bands.dtype not in DTYPES:
        raise ValueError("host_solve takes contiguous CPU tensors of one "
                         "float dtype")
    b, n6 = bands.shape[:2]
    d = rhs.shape[-1]
    out = torch.empty_like(rhs)
    bbar = None if x is None else torch.empty_like(bands)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = _host_library().svsdf_minco_cr_host(
        ptr(bands), ptr(rhs), ptr(x), ptr(out), ptr(bbar), b, n6 // 6, d,
        refine, int(transpose), int(bands.dtype == torch.float64))
    if rc != 0:
        raise ValueError(f"host_solve refused B={b}, 6N={n6}, D={d}")
    return out if x is None else (out, bbar)
