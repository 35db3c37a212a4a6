"""PyTorch / CUDA port of the svsdf_tpu SVSDF planner for NVIDIA Hopper.

The package mirrors ``svsdf_tpu``'s layout module by module; a reader
finds the counterpart of ``svsdf_tpu/ops/minco.py`` at
``svsdf_tpu_torch/ops/minco.py``. It imports torch, numpy and the
standard library only, never JAX and nothing of ``svsdf_tpu``.

Batching: the JAX package vmaps single-plan functions; this package has
no vmap. Every function of the planner path takes an explicit leading
plan axis B (coefficients (B, N, 6, 3), points (B, M, 2), ...). A
vmapped ``while_loop`` becomes a Python loop that runs while any lane
is active and merges each step with ``torch.where(active, new, old)``.

Float32 matrix products run in full float32: the JAX package pins
``precision="float32"`` at every contraction whose rounding matters
(MINCO assembly, trajectory evaluation, the CR adjoint), so TF32 is
switched off here for the whole process.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means CUDA.

    Raises when CUDA is missing and the caller did not ask for the CPU
    explicitly, so that a run meant for the card never falls back to
    the host silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the host")
    return dev
