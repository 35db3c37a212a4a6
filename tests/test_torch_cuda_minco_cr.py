"""The MINCO CR kernels (svsdf_tpu_torch/csrc/minco_cr.cu through
ops/cuda_minco.py) against block_cr's plain version and the float64
dense solve.

Tests marked ``cuda`` need an NVIDIA card and skip without one: the
kernels have no CPU mode. This file imports neither JAX nor the JAX
package, so on a card whose installation has no JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_minco_cr.py

Tolerances, relative to the reference's largest magnitude. float64: 1e-12
(both routes land within 1.5e-14 of the dense solve on these systems,
the two within 8e-15 of each other). float32: 2e-5, the refined CR's
accuracy class (JAX's ops/block_cr.py: ~1e-6..1e-5 relative after one
refinement round; both routes within 3e-6 of the dense solve and of each
other over every shape here, 16384 plans included).

The unmarked tests run on the host: the kernel's own source compiled
with g++ and run with one lane a plan (``cuda_minco.host_solve``) holds
the kernel's arithmetic against the plain version, and CPU tensors take
the plain route without launching anything. There the kernel's x and
rhs_bar equal the plain version's to the bit (the same operations in the
same order, each rounded once). Its band gradient sums each band entry's
D products in order while the plain version takes them from a BLAS outer
product, so they may differ in the last bit: within HOST_GRAD_TOL, four
units in the last place relative to the largest entry (readings up to
1.07e-7 in float32 and 2.0e-16 in float64 over the shapes here).
"""

import numpy as np
import pytest
import torch

from svsdf_tpu_torch.ops import block_cr, cuda_minco, minco

torch.set_num_threads(1)

TOL = {torch.float32: 2e-5, torch.float64: 1e-12}
HOST_GRAD_TOL = {dt: 4 * torch.finfo(dt).eps
                 for dt in (torch.float32, torch.float64)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")


def _problem(b, n, d, seed, device):
    """Random MINCO problems (tests/test_torch_minco.py's draws), float64."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    head = np.zeros((b, 3, d))
    head[:, 0] = rng.uniform(-1, 1, (b, d))
    head[:, 1] = rng.uniform(-0.5, 0.5, (b, d))
    tail = np.zeros((b, 3, d))
    tail[:, 0] = rng.uniform(5, 9, (b, d))
    return (t(rng.uniform(0.6, 2.0, (b, n))), t(head), t(tail),
            t(rng.uniform(0, 8, (b, n - 1, d))))


def _system(b, n, d, seed, device):
    """The normalized-time bands (B, 6N, 13) and rhs (B, 6N, D), float64."""
    return minco.build_bands_norm(*_problem(b, n, d, seed, device))


def _dense(bands):
    """(B, 6N, 6N) of band storage: row i, column i + d - 6."""
    b, n6, _ = bands.shape
    m = torch.zeros((b, n6, n6 + 12), dtype=bands.dtype, device=bands.device)
    idx = torch.arange(n6, device=bands.device)
    for dd in range(13):
        m[:, idx, idx + dd] = bands[:, :, dd]
    return m[:, :, 6:n6 + 6]


def _rel(a, ref):
    return float((a.double() - ref.double()).abs().max()
                 / ref.double().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 16])
@pytest.mark.parametrize("b", [1, 5, 16384])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_kernels_match_plain_and_dense(dtype, b, n, d):
    _card()
    bands64, rhs64 = _system(b, n, d, 1000 * n + 10 * d + b, "cuda")
    m = _dense(bands64)
    bands, rhs = bands64.to(dtype), rhs64.to(dtype)
    x = cuda_minco.forward(bands, rhs, block_cr.REFINE)
    x_plain = block_cr._cr_core(bands, rhs, block_cr.REFINE, False)
    x_bar64 = torch.as_tensor(np.random.default_rng(n).normal(
        size=rhs.shape), device="cuda")
    x_bar = x_bar64.to(dtype)
    g, r = cuda_minco.backward(bands, x_plain.contiguous(), x_bar,
                               block_cr.REFINE)
    g_plain, r_plain = block_cr.plain_backward(bands, x_plain, x_bar)
    tol = TOL[dtype]
    assert x.dtype == dtype and x.shape == rhs.shape
    assert _rel(x, torch.linalg.solve(m, rhs64)) <= tol
    assert _rel(x, x_plain) <= tol
    assert _rel(r, torch.linalg.solve(m.transpose(-1, -2), x_bar64)) <= tol
    assert _rel(r, r_plain) <= tol
    assert _rel(g, g_plain) <= tol
    # the band gradient is 0 outside the matrix, as the plain version's
    assert torch.equal(g == 0, g_plain == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_minco_solve_and_solve_raw_at_n8(dtype):
    """The port's two CR callers on the card, each one forward launch,
    against the float64 dense solve of the raw-time system."""
    _card()
    args64 = _problem(7, 8, 3, 3, "cuda")
    args = [a.to(dtype) for a in args64]
    dense = minco.solve_dense(*args64).coeffs
    for fn in (minco.solve, minco.solve_raw):
        cuda_minco.reset_launches()
        got = fn(*args).coeffs
        assert cuda_minco.launches == {"forward": 1, "backward": 0}
        assert _rel(got, dense) <= TOL[dtype], fn.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(1, 1), (3, 2), (4, 3)])
def test_gradcheck_float64(n, d):
    _card()
    bands, rhs = _system(2, n, d, 40 + n, "cuda")
    # entries of the rows' bands outside the matrix too: the gradient is 0
    # there, and the solution ignores them
    bands = bands + 0.01 * torch.rand(bands.shape, dtype=bands.dtype,
                                      device="cuda")
    assert torch.autograd.gradcheck(
        block_cr.banded_solve_cr,
        (bands.requires_grad_(True), rhs.requires_grad_(True)))


@pytest.mark.cuda
def test_one_launch_a_direction():
    _card()
    bands, rhs = _system(64, 8, 3, 5, "cuda")
    bands.requires_grad_(True)
    rhs.requires_grad_(True)
    cuda_minco.reset_launches()
    x = block_cr.banded_solve_cr(bands, rhs)
    assert cuda_minco.launches == {"forward": 1, "backward": 0}
    x.backward(torch.ones_like(x))
    torch.cuda.synchronize()
    assert cuda_minco.launches == {"forward": 1, "backward": 1}
    assert bands.grad.shape == bands.shape and rhs.grad.shape == rhs.shape


@pytest.mark.cuda
def test_kernel_refuses_a_plan_past_shared_memory():
    """float64 at N = 80 passes a block's shared memory: no block holds
    the plan, and the wrapper raises before launching."""
    _card()
    bands, rhs = _system(3, 80, 3, 9, "cuda")
    assert cuda_minco.geometry(torch.cuda.current_device(), 80, 3,
                               torch.float64, True)[1] == 0
    cuda_minco.reset_launches()
    with pytest.raises(ValueError, match="shared memory"):
        cuda_minco.forward(bands, rhs, block_cr.REFINE)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_minco.backward(bands, rhs, rhs, block_cr.REFINE)
    assert cuda_minco.launches == {"forward": 0, "backward": 0}


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take():
    _card()
    bands, rhs = _system(2, 3, 3, 1, "cuda")
    cuda_minco.reset_launches()
    with pytest.raises(TypeError):
        block_cr.banded_solve_cr(bands.half(), rhs.half())
    with pytest.raises(TypeError):
        cuda_minco.forward(bands, rhs.float(), 1)
    with pytest.raises(ValueError):
        cuda_minco.forward(bands, torch.cat([rhs, rhs[..., :2]], -1), 1)
    with pytest.raises(ValueError):
        cuda_minco.forward(bands[..., :12].contiguous(), rhs, 1)
    with pytest.raises(ValueError):
        cuda_minco.forward(bands[:, :17].contiguous(), rhs[:, :17].contiguous(),
                           1)
    with pytest.raises(ValueError):
        cuda_minco.forward(bands, rhs.transpose(0, 1).contiguous()
                           .transpose(0, 1), 1)
    with pytest.raises(ValueError):
        cuda_minco.forward(bands, rhs.cpu(), 1)
    assert cuda_minco.launches == {"forward": 0, "backward": 0}


@pytest.mark.parametrize("d", [1, 3, 4])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 16, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_kernel_source_on_host_matches_plain(dtype, n, d):
    """The kernel's arithmetic (its source built with g++, one lane a
    plan) against the plain version in both directions."""
    bands, rhs = (t.to(dtype) for t in _system(5, n, d, 7 * n + d, "cpu"))
    x_bar = torch.as_tensor(np.random.default_rng(d).normal(
        size=rhs.shape), dtype=dtype)
    x = cuda_minco.host_solve(bands, rhs, block_cr.REFINE)
    x_plain = block_cr._cr_core(bands, rhs, block_cr.REFINE, False)
    r, g = cuda_minco.host_solve(bands, x_bar, block_cr.REFINE, True,
                                 x_plain.contiguous())
    g_plain, r_plain = block_cr.plain_backward(bands, x_plain, x_bar)
    assert torch.equal(x, x_plain)
    assert torch.equal(r, r_plain)
    assert _rel(g, g_plain) <= HOST_GRAD_TOL[dtype]
    assert torch.equal(g == 0, g_plain == 0)


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_kernel_source_on_host_solves_the_raw_system(dtype, n):
    """minco.solve_raw's raw-time bands (entries from T^0 to T^5)."""
    bands, rhs = (t.to(dtype).contiguous() for t in minco.build_bands(
        *_problem(3, n, 3, 20 + n, "cpu")))
    x = cuda_minco.host_solve(bands, rhs, block_cr.REFINE)
    x_plain = block_cr._cr_core(bands, rhs, block_cr.REFINE, False)
    assert torch.equal(x, x_plain)


@pytest.mark.parametrize("refine", [0, 1, 2])
def test_kernel_source_on_host_refines_as_asked(refine):
    bands, rhs = _system(4, 6, 3, 11, "cpu")
    bands, rhs = bands.float(), rhs.float()
    x = cuda_minco.host_solve(bands, rhs, refine)
    x_plain = block_cr._cr_core(bands, rhs, refine, False)
    assert torch.equal(x, x_plain)
    # each round moves the result: a dropped round would not pass
    if refine:
        assert not torch.equal(x, cuda_minco.host_solve(bands, rhs,
                                                        refine - 1))


def test_cpu_tensors_take_the_plain_route():
    bands, rhs = _system(3, 5, 3, 2, "cpu")
    bands.requires_grad_(True)
    rhs.requires_grad_(True)
    x_bar = torch.as_tensor(np.random.default_rng(0).normal(size=rhs.shape))
    cuda_minco.reset_launches()
    x = block_cr.banded_solve_cr(bands, rhs)
    gb, gr = torch.autograd.grad(x, (bands, rhs), x_bar)
    assert cuda_minco.launches == {"forward": 0, "backward": 0}
    x_plain = block_cr._cr_core(bands.detach(), rhs.detach(),
                                block_cr.REFINE, False)
    g_plain, r_plain = block_cr.plain_backward(bands.detach(), x_plain,
                                               x_bar)
    assert torch.equal(x.detach(), x_plain)
    assert torch.equal(gb, g_plain) and torch.equal(gr, r_plain)


def test_kernel_wrapper_refuses_cpu_tensors():
    bands, rhs = _system(1, 2, 1, 0, "cpu")
    with pytest.raises(ValueError):
        cuda_minco.forward(bands, rhs, block_cr.REFINE)
    with pytest.raises(ValueError):
        cuda_minco.backward(bands, rhs, rhs, block_cr.REFINE)


def test_work_counts_bytes_once():
    """The kernels' byte counts: inputs read and outputs written once."""
    ops_f, bytes_f = cuda_minco.work(8, 3, 1, False)
    ops_b, bytes_b = cuda_minco.work(8, 3, 1, True)
    assert bytes_f == 4 * 48 * (13 + 3 + 3)
    assert bytes_b == 4 * 48 * (13 + 3 + 3 + 3 + 13)
    assert 0 < ops_f < ops_b
    assert cuda_minco.work(8, 3, 1, False, itemsize=8)[1] == 2 * bytes_f
