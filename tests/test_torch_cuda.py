"""The port's CUDA TC kernels on the card (marker ``cuda``).

These need a CUDA device and ``nvcc``; without one they skip. The file
imports no jax, so on the machine with the card, which has none, run it
without the repository's conftest (which imports jax):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance rtol 1e-4 / atol 1e-5, TF32 off, against the plain version
evaluated in float64 on the same float32 inputs: the kernels compute in
float64 inside; the float32 plain version carries ~4e-5 of rounding on
small gradient entries where the variance is floored (csrc/tc_kernels.cu).
"""

import numpy as np
import pytest
import torch

from intro_tc_vae_tpu_torch.ops import tc_cuda

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the TC kernels have no CPU build")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _inputs(b, zdim, seed=0):
    rng = np.random.RandomState(seed)
    z = rng.randn(b, zdim).astype(np.float32)
    mu = rng.randn(b, zdim).astype(np.float32)
    logvar = (rng.randn(b, zdim) * 0.7 * 4.0).astype(np.float32)
    logvar[::3, ::2] = -12.0  # variance floor (and with it the -50 clamp) active
    return z, mu, logvar


@pytest.mark.parametrize("b,zdim", [(64, 128), (512, 128), (40, 72)])
def test_kernels_match_plain(dev, b, zdim):
    """Values and all three gradients; (40, 72) has a ragged last tile and
    lanes past Z."""
    arrays = _inputs(b, zdim)
    before = dict(tc_cuda.LAUNCHES)
    outs = []
    for fn, dtype in ((tc_cuda.tc_logsumexp_cuda, torch.float32),
                      (tc_cuda.tc_logsumexp_reference, torch.float64)):
        args = [torch.tensor(a, device=dev, dtype=dtype, requires_grad=True)
                for a in arrays]
        pm, qz = fn(*args, 1280)
        ((qz - pm).mean() + 0.5e-3 * pm.sum()).backward()
        outs.append([pm.detach(), qz.detach()] + [a.grad for a in args])
    torch.cuda.synchronize()
    for got, want in zip(*outs):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    assert {k: tc_cuda.LAUNCHES[k] - before[k] for k in tc_cuda.KERNELS} == \
        dict.fromkeys(tc_cuda.KERNELS, 1)


def test_wrapper_rejects_what_the_kernels_do_not_take(dev):
    z, mu, logvar = (torch.tensor(a, device=dev) for a in _inputs(8, 16))
    with pytest.raises(TypeError):
        tc_cuda.tc_logsumexp_cuda(z.double(), mu, logvar, 64)
    with pytest.raises(ValueError):
        tc_cuda.tc_logsumexp_cuda(z.t().contiguous().t(), mu, logvar, 64)
    with pytest.raises(ValueError):
        tc_cuda.tc_logsumexp_cuda(z, mu.cpu(), logvar, 64)
    with pytest.raises(ValueError):
        tc_cuda.tc_logsumexp_cuda(z, mu[:4], logvar, 64)
    with pytest.raises(ValueError):
        tc_cuda.tc_logsumexp_cuda(z, mu, logvar, 4)
