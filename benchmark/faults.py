"""Faults planted in the program's timed path, each of which the check
has to find: the harness's tests run them at small sizes on the host,
and ``calibrate.py --faults <names>`` at a cell's own size on the card,
where their readings set the upper ends of the limits.

``plant(name)`` patches the program for the length of a ``with`` block.
The benchmark's own runs plant nothing.
"""

from __future__ import annotations

import contextlib

import torch


def _solve():
    from svsdf_tpu_torch.parallel import batch as pb
    return pb._staged_solve


def _unchanged(solve):
    def broken(shape, cfg, stages, *args):
        """A solve that returns its start: no stage iterates."""
        return solve(shape, cfg, tuple((s[0], 0) + tuple(s[2:])
                                       for s in stages), *args)
    return broken


def _iters_halved(solve):
    def broken(shape, cfg, stages, *args):
        """Every stage cut to half its iterations."""
        return solve(shape, cfg, tuple((s[0], s[1] // 2) + tuple(s[2:])
                                       for s in stages), *args)
    return broken


def _half(solve):
    unchanged = _unchanged(solve)

    def broken(shape, cfg, stages, n, ls, x0, head, tail, obs):
        """Half of the batch solved, the other half left at its start."""
        h = max(1, x0.shape[0] // 2)
        a = solve(shape, cfg, stages, n, ls, x0[:h], head[:h], tail[:h],
                  obs[:h])
        b = unchanged(shape, cfg, stages, n, ls, x0[h:], head[h:], tail[h:],
                      obs[h:])
        cat = lambda u, v: type(u)(*(torch.cat([p, q]) for p, q in zip(u, v)))
        return torch.cat([a[0], b[0]]), cat(a[1], b[1]), cat(a[2], b[2])
    return broken


def _cost_altered(solve):
    def broken(*args):
        x, res, traj = solve(*args)
        return x, res._replace(f=res.f * 1.01), traj
    return broken


def _traj_altered(solve):
    def broken(*args):
        x, res, traj = solve(*args)
        c = traj.coeffs.clone()
        c[:, :, 1] += 0.1
        return x, res, traj._replace(coeffs=c)
    return broken


#: faults of the staged solve: name -> wrapper of ``_staged_solve``
SOLVE_FAULTS = {"unchanged": _unchanged, "half": _half,
                "iters_halved": _iters_halved, "cost_altered": _cost_altered,
                "trajectory_altered": _traj_altered}


@contextlib.contextmanager
def _patched(module, attr, value):
    old = getattr(module, attr)
    setattr(module, attr, value)
    try:
        yield
    finally:
        setattr(module, attr, old)


@contextlib.contextmanager
def plant(name: str):
    """Run the block with the fault ``name`` in the program: one of
    ``SOLVE_FAULTS``; ``steepest_descent`` (the L-BFGS direction replaced
    by the gradient); ``sdf_shifted`` (the back end's oracle reads every
    swept-volume SDF 0.05 m high); ``certificate_altered`` (every
    certificate 0.01 m high); ``route_altered`` (every front-end verdict
    flipped)."""
    from svsdf_tpu_torch.parallel import batch as pb
    from svsdf_tpu_torch.planner import back_end
    from svsdf_tpu_torch.utils import lbfgs
    if name in SOLVE_FAULTS:
        ctx = _patched(pb, "_staged_solve", SOLVE_FAULTS[name](_solve()))
    elif name == "steepest_descent":
        ctx = _patched(lbfgs, "compact_apply", lambda g, *a: g)
    elif name in ("sdf_shifted", "certificate_altered"):
        mod = back_end if name == "sdf_shifted" else pb
        query = mod.svsdf_query
        up = 0.05 if name == "sdf_shifted" else 0.01

        def shifted(*a, **k):
            r = query(*a, **k)
            return r._replace(sdf=r.sdf + up)
        ctx = _patched(mod, "svsdf_query", shifted)
    elif name == "route_altered":
        front = pb.front_end

        def flipped(*a, **k):
            ok, head, tail, obs, x0 = front(*a, **k)
            return ~ok, head, tail, obs, x0
        ctx = _patched(pb, "front_end", flipped)
    else:
        raise ValueError(f"no fault {name!r}")
    with ctx:
        yield
