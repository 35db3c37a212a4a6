"""Cross-run disk memo of one-shot precomputes (svsdf_tpu/utils/cache.py).

``memoize_npz(key, fn)`` keeps host arrays of one-shot device
precomputes (yaw-kernel stencils, transition stencils) on disk. The
fine-yaw retry ladder re-rasterizes K*D*8 swept stencils per yaw
factor; those depend only on the shape and the geometry knobs, never on
the map, so every process after the first reads them back.

The memo has its own root, $SVSDF_TORCH_CACHE_DIR, else
~/.cache/svsdf_tpu_torch. It never reads the JAX package's directory or
its committed seed entries, whose keys name what the JAX precompute
depends on, not what the port's does. ``memo_prefix`` adds that to the
shape's identity: a grid shape's geometry and a digest of the code that
computes the arrays (``planner/pipeline.py`` adds the dtype and the
device type), so an entry written by other code is never read. The JAX
package's persistent compilation cache has no counterpart: the port
compiles nothing ahead of a call.
"""

from __future__ import annotations

import functools
import hashlib
import os
import zipfile

import numpy as np


def cache_dir() -> str:
    d = os.environ.get("SVSDF_TORCH_CACHE_DIR") or os.path.join(
        os.path.expanduser("~"), ".cache", "svsdf_tpu_torch")
    os.makedirs(d, exist_ok=True)
    return d


def shape_cache_key(shape) -> str | None:
    """Stable cross-process identity of a Shape2D for disk memoization:
    the JAX package's string, and for a Polygon its vertices' digest
    too (two polygons of different vertices would share the JAX key).

    Returns None when the shape has no stable identity (time-varying
    scale functions are arbitrary Python callables) — callers then skip
    the disk layer and memoize in-process only.
    """
    if getattr(shape, "time_varying", False):
        return None
    key = f"{shape.name}:{shape.tx}:{shape.ty}:{shape.yaw0}"
    body = getattr(shape, "body_sdf", None)
    grid = getattr(body, "__self__", None)
    vals = getattr(grid, "values", None)
    if vals is not None:  # mesh-SDF grid shape: key on the actual field
        h = hashlib.md5(np.asarray(vals, np.float32).tobytes())
        key += ":" + h.hexdigest()[:16]
    verts = getattr(shape, "vertices", None)
    if verts is not None:
        h = hashlib.md5(np.asarray(verts, np.float32).tobytes())
        key += ":v" + h.hexdigest()[:16]
    return key


#: the modules whose code computes a memoized array: the stencils
#: (ops/kernels.py, with ops/svsdf.py's sample times) and the bodies'
#: SDFs (models/)
PRECOMPUTE_MODULES = ("ops/kernels.py", "ops/svsdf.py", "models/shapes.py",
                      "models/mesh_sdf.py")


@functools.lru_cache(maxsize=None)
def code_digest() -> str:
    """Digest of PRECOMPUTE_MODULES' source: part of every key, so an
    edit to the code that computes an entry makes the entry a miss."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    h = hashlib.md5()
    for rel in PRECOMPUTE_MODULES:
        with open(os.path.join(pkg, rel), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def memo_prefix(shape) -> str | None:
    """The shape's part of a precompute's key: ``shape_cache_key`` (the
    JAX package's identity), a grid shape's origin, step and size (the
    JAX key digests the field's values only) and ``code_digest()``. None
    when the shape has no stable identity."""
    key = shape_cache_key(shape)
    if key is None:
        return None
    grid = getattr(getattr(shape, "body_sdf", None), "__self__", None)
    if getattr(grid, "values", None) is not None:
        key += f":{grid.x0}:{grid.y0}:{grid.step}:{grid.nx}x{grid.ny}"
    return f"{key}|{code_digest()}"


def memoize_npz(key: str, fn) -> np.ndarray:
    """Return fn() as a host numpy array, memoized on disk under `key`.

    The key is hashed into a filename; corrupt/partial files fall back
    to recompute (atomic rename on write, so concurrent writers of one
    key leave one whole file)."""
    path = os.path.join(cache_dir(),
                        hashlib.md5(key.encode()).hexdigest() + ".npz")
    if os.path.exists(path):
        try:
            with np.load(path) as z:
                return z["arr"]
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile):     # a corrupt or partial entry
            pass
    arr = np.asarray(fn())
    # savez appends ".npz" to names without it — keep the suffix so the
    # temp filename is exactly what gets written
    tmp = path[:-4] + f".tmp{os.getpid()}.npz"
    np.savez_compressed(tmp, arr=arr)
    os.replace(tmp, path)
    return arr
