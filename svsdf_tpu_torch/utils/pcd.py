"""Minimal PCD point-cloud reader (ascii + binary), numpy only (own copy
of svsdf_tpu/utils/pcd.py).

Replaces the reference's PCL dependency for loading the shipped
`map_<shape>.pcd` fixtures (`src/plan_manager/pcds/`). Supports the
subset of the PCD v0.7 spec those files use: FIELDS x y z, SIZE 4,
TYPE F, DATA ascii|binary.
"""

from __future__ import annotations

import numpy as np


def read_pcd(path: str) -> np.ndarray:
    """Return (N, 3) float32 xyz points."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if line.startswith("#") or not line:
                continue
            key, _, rest = line.partition(" ")
            header[key.upper()] = rest
            if key.upper() == "DATA":
                break
        fields = header.get("FIELDS", "x y z").split()
        sizes = [int(s) for s in header.get(
            "SIZE", "4 " * len(fields)).split()]
        types = header.get("TYPE", "F " * len(fields)).split()
        counts = [int(c) for c in header.get(
            "COUNT", "1 " * len(fields)).split()]
        n = int(header.get("POINTS", header.get("WIDTH", "0")))
        mode = header["DATA"].split()[0].lower()

        np_types = []
        for fld, sz, ty, ct in zip(fields, sizes, types, counts):
            base = {"F": "f", "I": "i", "U": "u"}[ty.upper()]
            if ct == 1:
                np_types.append((fld, f"{base}{sz}"))
            else:
                np_types.append((fld, f"{base}{sz}", (ct,)))
        dtype = np.dtype(np_types)

        if mode == "ascii":
            data = np.loadtxt(f, dtype=np.float64, max_rows=n)
            data = data.reshape(n, -1)
            idx = {fld: i for i, fld in enumerate(fields)}
            xyz = np.stack([data[:, idx["x"]], data[:, idx["y"]],
                            data[:, idx["z"]]], axis=-1)
        elif mode == "binary":
            raw = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype,
                                count=n)
            xyz = np.stack([raw["x"], raw["y"], raw["z"]], axis=-1)
        else:
            raise ValueError(f"unsupported PCD DATA mode: {mode}")
    return np.ascontiguousarray(xyz, dtype=np.float32)
