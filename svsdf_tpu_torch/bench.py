"""The main path's problem set (own copy of bench.py::_problem).

``problem`` builds B independent back-end problems from numpy seeds,
exactly as the repo's ``bench.py`` does: goals in [6, 10] x [-2, 2],
waypoints on the head-tail segment plus N(0, 0.2) noise, M obstacle
points uniform in [-1, 11] x [-5, 5], pieces of 1.5 s. It returns numpy
arrays (float32), which ``convert.problem_from_numpy`` turns into the
port's tensors and which the JAX package takes as they are.
"""

from __future__ import annotations

import numpy as np
import torch

from svsdf_tpu_torch.utils.transforms import backward_t

#: L-BFGS memory of the batched solves (bench.py's _BENCH_MEM_SIZE)
BENCH_MEM_SIZE = 8


def problem(n_pieces: int, n_obs: int, batch: int, seed: int = 0):
    """(head (B,3,3), tail (B,3,3), obstacles (B,M,2), x0 (B,4N-3)),
    all float32 numpy."""
    rng = np.random.default_rng(seed)
    head = np.zeros((batch, 3, 3), np.float32)
    tail = np.zeros((batch, 3, 3), np.float32)
    goals = rng.uniform([6, -2], [10, 2], size=(batch, 2))
    tail[:, 0, :2] = goals
    tail[:, 0, 2] = rng.uniform(-1, 1, batch)
    frac = np.linspace(0, 1, n_pieces + 1)[1:-1]
    wps = (head[:, 0][:, None, :] * (1 - frac)[None, :, None]
           + tail[:, 0][:, None, :] * frac[None, :, None])
    wps = wps + rng.normal(0, 0.2, wps.shape)
    obs = rng.uniform([-1, -5], [11, 5], size=(batch, n_obs, 2))
    tau = np.tile(backward_t(torch.full((n_pieces,), 1.5,
                                        dtype=torch.float32)).numpy(),
                  (batch, 1))
    x0 = np.concatenate([tau, wps.reshape(batch, -1)], axis=1)
    return (head, tail, obs.astype(np.float32), x0.astype(np.float32))
