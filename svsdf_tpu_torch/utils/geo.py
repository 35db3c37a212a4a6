"""Small computational-geometry utilities (svsdf_tpu/utils/geo.py, host
numpy, copied) — parity with the vendored
GCOPTER stack the reference carries (`src/utils/include/utils/
geo_utils.hpp`, `quickhull.hpp`, `sdlp.hpp`; SURVEY.md §2.3: available
utilities, no live call site in the planner hot path).

Host-side numpy: these are setup/visualization helpers (hull of a
footprint, polytope vertex enumeration), not device kernels.
"""

from __future__ import annotations

import numpy as np


def convex_hull_2d(points: np.ndarray) -> np.ndarray:
    """Convex hull of 2-D points (Andrew's monotone chain), returned as
    CCW-ordered hull vertices (H, 2) — quickhull.hpp's role for the
    planar footprints this framework plans with."""
    pts = np.unique(np.asarray(points, float)[:, :2], axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def half(seq):
        out = []
        for p in seq:
            while len(out) >= 2 and np.cross(out[-1] - out[-2],
                                             p - out[-2]) <= 0:
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return np.asarray(lower[:-1] + upper[:-1])


def convex_hull_3d(points: np.ndarray,
                   eps: float = 1e-9) -> tuple[np.ndarray, np.ndarray]:
    """3-D convex hull by quickhull (`quickhull.hpp`'s role — the
    reference vendors Antti Kuukka's QuickHull for geo_utils'
    polytope handling). Host-side numpy; O(n log n) expected.

    Returns (V, F): hull vertices (H, 3) and CCW triangle faces
    (T, 3) indexing V, outward-oriented (normals point away from the
    hull interior). Raises ValueError on degenerate (planar/collinear)
    input, which the planar pipeline handles with convex_hull_2d."""
    pts = np.unique(np.asarray(points, float).reshape(-1, 3), axis=0)
    if len(pts) < 4:
        raise ValueError("convex_hull_3d needs >= 4 non-coplanar points")

    # --- initial simplex: extreme pair, then farthest-from-line,
    # then farthest-from-plane
    lo, hi = np.argmin(pts, axis=0), np.argmax(pts, axis=0)
    cand = np.unique(np.concatenate([lo, hi]))
    best, pair = -1.0, (0, 1)
    for i in cand:
        d = np.linalg.norm(pts[cand] - pts[i], axis=1)
        j = cand[int(np.argmax(d))]
        if d.max() > best:
            best, pair = d.max(), (i, j)
    a, b = pair
    if best < eps:
        raise ValueError("degenerate input (all points coincide)")
    ab = pts[b] - pts[a]
    d_line = np.linalg.norm(np.cross(pts - pts[a], ab), axis=1)
    c = int(np.argmax(d_line))
    if d_line[c] < eps:
        raise ValueError("degenerate input (collinear)")
    n0 = np.cross(ab, pts[c] - pts[a])
    n0 /= np.linalg.norm(n0)
    d_plane = (pts - pts[a]) @ n0
    dd = int(np.argmax(np.abs(d_plane)))
    if abs(d_plane[dd]) < eps:
        raise ValueError("degenerate input (coplanar)")
    if d_plane[dd] > 0:          # keep faces outward-consistent
        a, b = b, a

    faces = [(a, b, c), (a, c, dd), (c, b, dd), (b, a, dd)]

    def plane(f):
        p0, p1, p2 = pts[f[0]], pts[f[1]], pts[f[2]]
        n = np.cross(p1 - p0, p2 - p0)
        nn = np.linalg.norm(n)
        n = n / max(nn, 1e-300)
        return n, n @ p0

    # outside sets: each point assigned to one face it lies outside of
    planes = [plane(f) for f in faces]
    alive = np.ones(len(pts), bool)
    alive[[a, b, c, dd]] = False
    outside: list[list[int]] = [[] for _ in faces]
    for i in np.nonzero(alive)[0]:
        for fi, (n, off) in enumerate(planes):
            if pts[i] @ n - off > eps:
                outside[fi].append(int(i))
                break

    face_alive = [True] * len(faces)
    stack = [fi for fi in range(len(faces)) if outside[fi]]
    while stack:
        fi = stack.pop()
        if not face_alive[fi] or not outside[fi]:
            continue
        n, off = planes[fi]
        pts_out = outside[fi]
        far = pts_out[int(np.argmax(np.asarray(
            [pts[i] @ n - off for i in pts_out])))]
        # find all faces visible from `far`
        visible = [gi for gi in range(len(faces))
                   if face_alive[gi]
                   and pts[far] @ planes[gi][0] - planes[gi][1] > eps]
        # horizon = edges of visible faces bordering a hidden face
        edge_count: dict[tuple[int, int], tuple[int, int]] = {}
        for gi in visible:
            f = faces[gi]
            for k in range(3):
                e = (f[k], f[(k + 1) % 3])
                edge_count[e] = e
        horizon = [e for e in edge_count
                   if (e[1], e[0]) not in edge_count]
        orphans = []
        for gi in visible:
            face_alive[gi] = False
            orphans.extend(outside[gi])
            outside[gi] = []
        # new fan of faces from `far` over the horizon
        for (u, v) in horizon:
            faces.append((u, v, far))
            planes.append(plane(faces[-1]))
            face_alive.append(True)
            outside.append([])
            stack.append(len(faces) - 1)
        new_ids = range(len(faces) - len(horizon), len(faces))
        for i in orphans:
            if i == far:
                continue
            for gi in new_ids:
                nn, oo = planes[gi]
                if pts[i] @ nn - oo > eps:
                    outside[gi].append(i)
                    break

    tri = [faces[i] for i in range(len(faces)) if face_alive[i]]
    used = sorted({v for f in tri for v in f})
    remap = {v: k for k, v in enumerate(used)}
    V = pts[used]
    F = np.asarray([[remap[v] for v in f] for f in tri], np.int64)
    return V, F


def polytope_volume_3d(V: np.ndarray, F: np.ndarray) -> float:
    """Volume of a closed outward-oriented triangle mesh (divergence
    theorem over signed tetrahedra)."""
    v = np.asarray(V, float)
    f = np.asarray(F, np.int64)
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    return float(np.einsum("ij,ij->i", a, np.cross(b, c)).sum() / 6.0)


def polygon_area(verts: np.ndarray) -> float:
    """Signed area of a 2-D polygon (CCW positive)."""
    v = np.asarray(verts, float)
    x, y = v[:, 0], v[:, 1]
    return 0.5 * float(np.dot(x, np.roll(y, -1)) -
                       np.dot(y, np.roll(x, -1)))


def point_in_convex_2d(hull: np.ndarray, p) -> bool:
    """Point-in-CCW-convex-polygon test."""
    h = np.asarray(hull, float)
    p = np.asarray(p, float)
    e = np.roll(h, -1, axis=0) - h
    w = p[None, :] - h
    return bool(np.all(e[:, 0] * w[:, 1] - e[:, 1] * w[:, 0] >= -1e-12))


def seidel_lp(c: np.ndarray, A: np.ndarray, b: np.ndarray,
              bound: float = 1e7, seed: int = 0) -> np.ndarray:
    """Linear program  min c.x  s.t.  A x <= b  in d <= 3 dims —
    Seidel's randomized incremental algorithm (sdlp.hpp:24-40's job).
    Expected O(n) for fixed d. Returns the optimal x; raises
    ValueError if infeasible. A box |x_i| <= bound keeps the LP
    bounded like sdlp's implicit bound."""
    c = np.asarray(c, float)
    A = np.asarray(A, float)
    b = np.asarray(b, float)
    d = c.shape[0]
    if d < 1 or d > 3:
        raise ValueError("seidel_lp supports 1 <= dim <= 3")
    rng = np.random.default_rng(seed)

    def solve(c, A, b, bound):
        """Seidel's incremental LP with an implicit |x_i| <= bound box.
        Invariant: x is OPTIMAL for the box + all constraints seen so
        far (a merely feasible x breaks the recursion's correctness)."""
        d = c.shape[0]
        if d == 1:
            lo, hi = -bound, bound
            for ai, bi in zip(A[:, 0], b):
                if ai > 1e-30:
                    hi = min(hi, bi / ai)
                elif ai < -1e-30:
                    lo = max(lo, bi / ai)
                elif bi < -1e-9:
                    raise ValueError("infeasible")
            if lo > hi + 1e-9:
                raise ValueError("infeasible")
            return np.array([hi if c[0] < 0 else lo])
        # box optimum: minimize c over the cube
        x = -bound * np.sign(c)
        order = rng.permutation(len(A))
        for pos, idx in enumerate(order):
            ai, bi = A[idx], b[idx]
            if ai @ x <= bi + 1e-9:
                continue
            # optimum moved: it lies ON this constraint's hyperplane.
            # Eliminate x_k and recurse over the previously seen
            # constraints (+ box faces) in d-1 dims.
            k = int(np.argmax(np.abs(ai)))
            if abs(ai[k]) < 1e-30:
                raise ValueError("infeasible")
            keep = [j for j in range(d) if j != k]
            prev = list(order[:pos])
            sub_A, sub_b = [], []
            for jdx in prev:
                aj, bj = A[jdx], b[jdx]
                sub_A.append(aj[keep] - aj[k] / ai[k] * ai[keep])
                sub_b.append(bj - aj[k] / ai[k] * bi)
            # the eliminated variable's box faces become constraints:
            # |x_k| <= bound with x_k = (bi - ai[keep].xs) / ai[k]
            sub_A.append(-ai[keep] / ai[k])
            sub_b.append(bound - bi / ai[k])
            sub_A.append(ai[keep] / ai[k])
            sub_b.append(bound + bi / ai[k])
            cc = c[keep] - c[k] / ai[k] * ai[keep]
            xs = solve(cc, np.asarray(sub_A), np.asarray(sub_b), bound)
            x = np.zeros(d)
            x[keep] = xs
            x[k] = (bi - ai[keep] @ xs) / ai[k]
        return x

    return solve(c, A, b, bound)


def halfspace_polytope_vertices_2d(A: np.ndarray,
                                   b: np.ndarray) -> np.ndarray:
    """Vertex enumeration of {x : A x <= b} in 2-D (geo_utils
    enumerateVs role, used by visPolytope). Returns CCW vertices."""
    A = np.asarray(A, float)
    b = np.asarray(b, float)
    n = len(A)
    verts = []
    for i in range(n):
        for j in range(i + 1, n):
            M = np.stack([A[i], A[j]])
            if abs(np.linalg.det(M)) < 1e-12:
                continue
            v = np.linalg.solve(M, np.array([b[i], b[j]]))
            if np.all(A @ v <= b + 1e-8):
                verts.append(v)
    if not verts:
        return np.zeros((0, 2))
    return convex_hull_2d(np.asarray(verts))
