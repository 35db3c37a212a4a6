"""A job of several ranks on this host: ``run`` starts one process a rank,
joins them into a ``torch.distributed`` process group
(``multihost.initialize`` at ``tcp://127.0.0.1:<a free port>``), calls
the same function in each and returns what each rank's call returned.

    results = local_world.run(2, "package.module:function", {"n": 4},
                              backend="gloo", device="cpu", timeout=300)

The function is named "module:function" (a module importable from the
checkout's root) or "path/to/file.py:function" (a file, relative to the
checkout's root or absolute) and called with the keyword arguments; its
return value must pickle. Each rank's output goes to a log file, so a rank that prints a
lot never blocks the others. The whole job has one time limit: at it,
every rank still running is killed and ``run`` raises, so a rank that
waits forever in a collective fails the job instead of hanging it.

The job's ranks share this host's devices: ``device="cuda"`` puts every
rank on the current card, where only ``gloo`` serves several ranks (NCCL
refuses two ranks on one card).
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent.parent


def free_port() -> int:
    """A TCP port on 127.0.0.1 that the OS reports free."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(n_ranks: int, target: str, kwargs: dict | None = None,
        backend: str = "gloo", device: str = "cpu",
        timeout: float = 600.0) -> list:
    """Run ``target(**kwargs)`` in each of ``n_ranks`` processes joined
    into one process group; returns the ranks' results in rank order.
    Raises RuntimeError with the ranks' logs when a rank fails, and
    TimeoutError (after killing every rank) at ``timeout`` seconds."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(_ROOT), os.environ.get("PYTHONPATH")) if p))
    with tempfile.TemporaryDirectory() as out:
        with open(os.path.join(out, "kwargs.pkl"), "wb") as fh:
            pickle.dump(kwargs or {}, fh)
        procs, logs = [], []
        try:
            for rank in range(n_ranks):
                log = open(os.path.join(out, f"rank{rank}.log"), "w")
                logs.append(log)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", __name__, target, str(rank),
                     str(n_ranks), str(port), backend, device, out],
                    env=env, cwd=str(_ROOT), stdout=log,
                    stderr=subprocess.STDOUT))
            deadline = time.monotonic() + timeout
            for p in procs:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            raise TimeoutError(f"{target} on {n_ranks} ranks passed "
                               f"{timeout} s:\n{_read_logs(out, n_ranks)}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()
        codes = [p.returncode for p in procs]
        if any(codes):
            raise RuntimeError(f"{target} on {n_ranks} ranks exited "
                               f"{codes}:\n{_read_logs(out, n_ranks)}")
        results = []
        for rank in range(n_ranks):
            with open(os.path.join(out, f"rank{rank}.pkl"), "rb") as fh:
                results.append(pickle.load(fh))
    return results


def _read_logs(out: str, n_ranks: int) -> str:
    parts = []
    for rank in range(n_ranks):
        path = os.path.join(out, f"rank{rank}.log")
        text = Path(path).read_text() if os.path.exists(path) else ""
        parts.append(f"--- rank {rank} ---\n{text[-6000:]}")
    return "\n".join(parts)


def _resolve(target: str):
    """The function a target names: "module:function" or
    "file.py:function"."""
    where, name = target.rsplit(":", 1)
    if where.endswith(".py"):
        path = Path(where) if os.path.isabs(where) else _ROOT / where
        spec = importlib.util.spec_from_file_location(
            f"_local_world_{path.stem}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(where)
    return getattr(module, name)


def _rank_main(argv) -> None:
    target, rank, world, port, backend, device, out = argv
    import torch
    import torch.distributed as dist

    from svsdf_tpu_torch.parallel import multihost

    # one host thread a rank: the ranks share the host's cores
    torch.set_num_threads(1)
    multihost.initialize(f"127.0.0.1:{port}", int(world), int(rank),
                         backend=backend, device=device)
    with open(os.path.join(out, "kwargs.pkl"), "rb") as fh:
        kwargs = pickle.load(fh)
    result = _resolve(target)(**kwargs)
    tmp = os.path.join(out, f"rank{rank}.pkl.tmp")
    with open(tmp, "wb") as fh:
        pickle.dump(result, fh)
    os.replace(tmp, os.path.join(out, f"rank{rank}.pkl"))
    multihost.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
