"""ctypes bindings of the native C++ host runtime (csrc/runtime.cpp), the
counterpart of svsdf_tpu/native/__init__.py.

The library is built with g++ at first use into the port's build
directory (``build/kernels/``, beside the coarse-scan kernel's library),
named by a digest of the source and the flags, so a library of other
source is never loaded. Every entry point has a pure-Python counterpart
in the package (the A* loop, the numpy voxelizer, the marching-squares
loop, ``ops/esdf.py``); ``available()`` gates the native route as in the
JAX package, and ``build_log()`` keeps the compiler's output when the
build failed. This is host code: it builds no tensor and runs nowhere
but the host.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from svsdf_tpu_torch.ops.cuda_svsdf import BUILD_DIR

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "runtime.cpp"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_failed = False
_log = ""


def library_path() -> Path:
    """Where the library of the current source lives (built or not)."""
    tag = hashlib.sha1(SOURCE.read_bytes()
                       + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libsvsdfrt_{tag}.so"


def build() -> tuple[Path, str]:
    """Compile csrc/runtime.cpp with g++ (once per source content).
    Returns (library path, compiler log; empty if cached). Raises with
    the compiler's log when g++ fails or is missing."""
    lib = library_path()
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise RuntimeError(f"g++ did not run: {exc!r}") from exc
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


def _bind(lib):
    c_i32, c_i64, c_dbl = ctypes.c_int32, ctypes.c_int64, ctypes.c_double
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.svsdf_astar.restype = c_i64
    lib.svsdf_astar.argtypes = [
        u8p, ctypes.c_void_p, u8p, c_i32, c_i32, c_i32, c_i32,
        c_i32, c_i32, c_i32, c_i32, c_i32, i32p, c_dbl, c_i64,
        i32p, c_i64, i64p]
    lib.svsdf_voxelize.restype = c_i64
    lib.svsdf_voxelize.argtypes = [
        f64p, c_i64, f64p, c_dbl, c_i32, c_i32, c_i32, c_i32, u8p]
    lib.svsdf_marching_squares.restype = c_i64
    lib.svsdf_marching_squares.argtypes = [
        f32p, c_i32, c_i32, c_dbl, c_dbl, c_dbl, ctypes.c_float,
        f64p, c_i64]
    lib.svsdf_esdf2d.restype = None
    lib.svsdf_esdf2d.argtypes = [u8p, c_i32, c_i32, c_dbl, f32p]
    return lib


def _load():
    global _lib, _failed, _log
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            path, _log = build()
            _lib = _bind(ctypes.CDLL(str(path)))
        except (RuntimeError, OSError) as exc:
            _log = str(exc)
            _failed = True
    return _lib


def available() -> bool:
    """Whether the runtime is built and loaded (False when the build
    failed: the Python loops then run, as in the JAX package)."""
    return _load() is not None


def build_log() -> str:
    """The compiler's output of this process's build (empty when the
    library was already built), or why the build or load failed."""
    _load()
    return _log


def _need():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native runtime unavailable:\n{_log}")
    return lib


def _bytes(a) -> np.ndarray:
    """``a`` as C-contiguous uint8: a bool array is viewed, not copied
    (the transition maps of a fine-yaw planner are tens of MB)."""
    a = np.ascontiguousarray(a)
    return a.view(np.uint8) if a.dtype == np.bool_ else \
        np.ascontiguousarray(a, np.uint8)


def astar(feas, trans_feas, occ2d, start_ij, goal_ij, start_bin,
          yaw_deltas, yaw_change_weight=0.1, max_expansions=2_000_000):
    """Native A* (runtime.cpp svsdf_astar). Returns (cells (L, 3) int32
    rows [i, j, yaw_bin], expansions) or (None, expansions) if no path.
    The maps are read as bytes, nonzero meaning feasible."""
    lib = _need()
    feas = _bytes(feas)
    occ2d = _bytes(occ2d)
    K, X, Y = feas.shape
    if trans_feas is not None:
        trans_feas = _bytes(trans_feas)
        D = trans_feas.shape[1]
        tf_ptr = trans_feas.ctypes.data_as(ctypes.c_void_p)
    else:
        D = len(yaw_deltas)
        tf_ptr = None
    deltas = np.ascontiguousarray(yaw_deltas, np.int32)
    out = np.zeros((X * Y, 3), np.int32)
    exp = np.zeros(1, np.int64)
    n = lib.svsdf_astar(feas, tf_ptr, occ2d, K, D, X, Y,
                        int(start_ij[0]), int(start_ij[1]),
                        int(goal_ij[0]), int(goal_ij[1]), int(start_bin),
                        deltas, float(yaw_change_weight),
                        int(max_expansions), out, X * Y, exp)
    if n <= 0:
        return None, int(exp[0])
    return out[:n].copy(), int(exp[0])


def voxelize(points, xyz_min, resolution, shape, threshold):
    """Native point counting + threshold -> occupancy (nx, ny, nz) bool."""
    lib = _need()
    pts = np.ascontiguousarray(points, np.float64)
    occ = np.zeros(int(np.prod(shape)), np.uint8)
    lib.svsdf_voxelize(pts, len(pts),
                       np.ascontiguousarray(xyz_min, np.float64),
                       float(resolution), int(shape[0]), int(shape[1]),
                       int(shape[2]), int(threshold), occ)
    return occ.reshape(shape).astype(bool)


def marching_squares(field, x0, y0, step, level=0.0):
    """Native zero-level-set segments of ``field`` (nx, ny) sampled at
    x0 + i * step, y0 + j * step -> (S, 2, 2) float64."""
    lib = _need()
    f = np.ascontiguousarray(field, np.float32)
    nx, ny = f.shape
    max_segs = 2 * nx * ny + 16
    out = np.zeros((max_segs, 4), np.float64)
    n = lib.svsdf_marching_squares(f, nx, ny, float(x0), float(y0),
                                   float(step), float(level), out,
                                   max_segs)
    return out[:n].reshape(-1, 2, 2).copy()


def esdf2d(occ, resolution):
    """Native signed ESDF of a 2-D occupancy slice -> float32 (nx, ny)."""
    lib = _need()
    o = _bytes(occ)
    nx, ny = o.shape
    out = np.zeros((nx, ny), np.float32)
    lib.svsdf_esdf2d(o, nx, ny, float(resolution), out)
    return out
