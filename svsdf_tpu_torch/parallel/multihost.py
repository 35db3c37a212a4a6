"""Multi-process runtime hooks over ``torch.distributed``
(svsdf_tpu/parallel/multihost.py).

The reference is a single-process program (SURVEY.md §2.6). The JAX
package joins a multi-host job with ``jax.distributed`` and lays a
(scn, obs) device mesh over it; here every process is one rank with one
device, ``initialize`` joins the process group, ``pod_mesh`` lays the
(scn, obs) mesh over the ranks with the obs axis innermost (the
per-iteration gradient all-reduce of parallel/batch.py's sharded solves
runs among adjacent ranks) and holds the process group of each mesh row
and column, and the array helpers cut each rank's block out of a host
batch and gather the blocks back.

A sharded array is represented by each rank's own block: a tensor on the
rank's device. ``global_batch_array`` cuts it from the host array that
every rank holds; ``fetch_global`` all-gathers the blocks to numpy on
every rank. In a single process (no process group) every helper passes
through unchanged, so the same driver runs in one process or many.

Backends: ``nccl`` for CUDA ranks on their own cards, ``gloo`` on the
host. gloo all-reduces CUDA tensors but does not all-gather them, so
``fetch_global`` gathers host copies under gloo. NCCL refuses two ranks
on one card; several ranks sharing one card run gloo.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from svsdf_tpu_torch import resolve_device


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def _world() -> int:
    """Ranks in the job (1 without a process group)."""
    return dist.get_world_size() if _active() else 1


def _rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if _active() else 0


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None, device=None) -> bool:
    """Join (or skip joining) a multi-process job.

      * explicit arguments win (``coordinator_address`` is "host:port");
      * else torchrun's environment is read: MASTER_ADDR, MASTER_PORT,
        WORLD_SIZE, RANK and LOCAL_RANK;
      * with neither, this is a single-process session and the call is a
        no-op that returns False.

    ``backend`` defaults to ``nccl`` when ``device`` (``None``: CUDA,
    which raises without a card) is CUDA and to ``gloo`` on the CPU. An
    NCCL rank takes the card LOCAL_RANK (else its rank) modulo the cards
    present. Returns True iff the job has more than one rank. Safe to
    call twice: a joined process group is left alone."""
    if _active():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env \
            and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return False  # single-process session
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("a multi-process job needs the coordinator's "
                         "address, the number of processes and this "
                         "process's rank")
    if backend is None:
        backend = ("nccl" if resolve_device(device).type == "cuda"
                   else "gloo")
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    return dist.get_world_size() > 1


class RankMesh:
    """A (scn, obs) mesh of the job's ranks: rank r sits at
    (r // n_obs, r % n_obs), obs innermost as in the JAX package's
    ``pod_mesh``. It holds the process group of every row (the ranks
    sharing a scenario slice: the obs all-reduce) and every column, each
    created on every rank in the same order, and this rank's device.

    ``shape`` maps axis names to sizes, as a JAX mesh's does."""

    def __init__(self, n_scn: int, n_obs: int,
                 axis_names: Sequence[str] = ("scn", "obs"), device=None):
        world = _world()
        if n_scn * n_obs != world:
            raise ValueError(f"a {n_scn} x {n_obs} mesh needs "
                             f"{n_scn * n_obs} ranks, the job has {world}")
        self.axis_names = tuple(axis_names)
        self.shape = {self.axis_names[0]: n_scn, self.axis_names[1]: n_obs}
        self.ranks = np.arange(world).reshape(n_scn, n_obs)
        rank = _rank()
        self.coords = (rank // n_obs, rank % n_obs)
        self.device = resolve_device(device)
        self.row_groups, self.col_groups = [], []
        if _active():
            self.row_groups = [dist.new_group(ranks=self.ranks[s].tolist())
                               for s in range(n_scn)]
            self.col_groups = [dist.new_group(ranks=self.ranks[:, o].tolist())
                               for o in range(n_obs)]

    @property
    def obs_group(self):
        """The process group of this rank's row (None in one process)."""
        return self.row_groups[self.coords[0]] if self.row_groups else None

    @property
    def scn_group(self):
        """The process group of this rank's column."""
        return self.col_groups[self.coords[1]] if self.col_groups else None


def pod_mesh(n_obs_shards: int = 1,
             axis_names: Sequence[str] = ("scn", "obs"),
             device=None) -> RankMesh:
    """A (scn, obs) mesh over every rank of the job, the obs axis
    innermost: adjacent ranks (on one host, NVLink-adjacent cards) share a
    scenario slice and all-reduce its gradients. ``device=None`` is the
    rank's CUDA device (raises without a card)."""
    n = _world()
    if n % n_obs_shards != 0:
        raise ValueError(f"{n} ranks not divisible by "
                         f"n_obs_shards={n_obs_shards}")
    return RankMesh(n // n_obs_shards, n_obs_shards, axis_names, device)


def process_slice(global_batch_size: int,
                  process_index: int | None = None,
                  process_count: int | None = None) -> slice:
    """This process's contiguous slice of a batch sharded over the
    processes (scenario order = rank order)."""
    pc = _world() if process_count is None else process_count
    pi = _rank() if process_index is None else process_index
    if global_batch_size % pc != 0:
        raise ValueError(f"global batch {global_batch_size} not "
                         f"divisible by process count {pc}")
    per = global_batch_size // pc
    return slice(pi * per, (pi + 1) * per)


def _block_slices(shape, mesh: RankMesh, spec, coords):
    """The slices of the block at mesh ``coords`` of an array of global
    ``shape`` laid out as ``spec`` (an axis name or None a leading dim)."""
    out = []
    for dim, axis in enumerate(spec):
        if axis is None:
            out.append(slice(None))
            continue
        k = mesh.shape[axis]
        if shape[dim] % k != 0:
            raise ValueError(f"dimension {dim} of size {shape[dim]} does not "
                             f"divide by the {axis!r} axis ({k})")
        per = shape[dim] // k
        i = coords[mesh.axis_names.index(axis)]
        out.append(slice(i * per, (i + 1) * per))
    return tuple(out)


def global_batch_array(host_array, mesh: RankMesh, spec: Sequence):
    """This rank's (scn, obs) block of an array every rank holds whole,
    as a tensor on the mesh's device. ``spec`` names the mesh axis each
    leading dimension is sharded over (None: replicated), e.g.
    ("scn",) or ("scn", "obs"); a dimension that does not divide by its
    axis raises. One process: the whole array on the device."""
    a = torch.as_tensor(host_array)
    return a[_block_slices(a.shape, mesh, tuple(spec), mesh.coords)].to(
        mesh.device)


def fetch_global(arr, mesh: RankMesh | None = None,
                 spec: Sequence = ("scn",)) -> np.ndarray:
    """Every rank's block of a sharded array (laid out as ``spec``)
    all-gathered to numpy on every rank: the output path of the sharded
    solves. One process: a plain copy to the host."""
    t = torch.as_tensor(arr).detach()
    if _world() == 1:
        return t.cpu().numpy()
    if mesh is None:
        raise ValueError("fetch_global needs the mesh the blocks lie on")
    is_bool = t.dtype == torch.bool
    if is_bool:
        t = t.to(torch.uint8)
    # gloo gathers host tensors only; NCCL gathers device tensors only
    buf = (t if dist.get_backend() == "nccl" else t.cpu()).contiguous()
    parts = [torch.empty_like(buf) for _ in range(_world())]
    dist.all_gather(parts, buf)
    spec = tuple(spec)
    gshape = list(t.shape)
    for dim, axis in enumerate(spec):
        if axis is not None:
            gshape[dim] *= mesh.shape[axis]
    out = np.empty(gshape, dtype=parts[0].cpu().numpy().dtype)
    for r, part in enumerate(parts):
        coords = divmod(r, mesh.shape[mesh.axis_names[1]])
        out[_block_slices(gshape, mesh, spec, coords)] = part.cpu().numpy()
    return out.astype(bool) if is_bool else out


def barrier(name: str = "svsdf_tpu_torch") -> None:
    """Cross-process sync point. No-op in a single-process session."""
    del name
    if _world() > 1:
        dist.barrier()
