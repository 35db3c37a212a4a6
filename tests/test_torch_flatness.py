"""Port parity: the quadrotor flatness map (ops/flatness.py), float64.

``forward`` at random (vel, acc, jerk, psi, dpsi) states against the JAX
package's, every output at rtol 1e-12, and the gradient of a scalar of
all three outputs through autograd against ``jax.grad`` at rtol 1e-10.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from svsdf_tpu.ops import flatness as jflatness
from svsdf_tpu_torch.ops import flatness

torch.set_num_threads(1)


def _states(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 3, (n, 3)), rng.normal(0, 2, (n, 3)),
            rng.normal(0, 4, (n, 3)), rng.uniform(-3, 3, n),
            rng.normal(0, 1, n))


def _params():
    return (flatness.FlatnessParams(mass=0.9, dh=0.2, cp=0.03),
            jflatness.FlatnessParams(mass=0.9, dh=0.2, cp=0.03))


def test_forward_matches_jax():
    p, jp = _params()
    args = _states()
    out = flatness.forward(*(torch.as_tensor(a) for a in args), p)
    jout = jflatness.forward(*(jnp.asarray(a) for a in args), jp)
    for a, b in zip(out, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-12)
    # hover: thrust m*g, identity attitude, zero rates
    z = torch.zeros(3, dtype=torch.float64)
    thr, quat, omg = flatness.forward(z, z, z, z[0], z[0],
                                      flatness.FlatnessParams())
    np.testing.assert_allclose(float(thr), 0.61 * 9.8, rtol=1e-2)
    np.testing.assert_allclose(quat.numpy(), [1, 0, 0, 0], atol=1e-12)
    np.testing.assert_allclose(omg.numpy(), np.zeros(3), atol=1e-12)


def test_gradient_matches_jax_grad():
    p, jp = _params()
    args = _states(n=16, seed=1)

    def scalar(out, lib):
        thr, quat, omg = out
        return lib.sum(thr) + lib.sum(quat ** 2 * 0.3) + lib.sum(omg ** 2)

    def jf(*a):
        return scalar(jflatness.forward(*a, jp), jnp)

    jg = jax.grad(jf, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a)
                                                  for a in args))
    ts = [torch.as_tensor(a).requires_grad_(True) for a in args]
    g = torch.autograd.grad(scalar(flatness.forward(*ts, p), torch), ts)
    for a, b in zip(g, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-12)
