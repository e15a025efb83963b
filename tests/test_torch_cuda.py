"""The port's CUDA kernels on the card (marker ``cuda``): the TC kernels
and the 3x3 conv kernels.

These need a CUDA device and ``nvcc``; without one they skip. The file
imports no jax, so on the machine with the card, which has none, run it
without the repository's conftest (which imports jax):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

TC: rtol 1e-4 / atol 1e-5, TF32 off, against the plain version
evaluated in float64 on the same float32 inputs: the kernels compute in
float64 inside; the float32 plain version carries ~4e-5 of rounding on
small gradient entries where the variance is floored (csrc/tc_kernels.cu).

Conv, against the plain version in float64 on the same (bf16-rounded)
inputs, with S the same conv of |operands| (the sum of |terms| of each
output entry):
* fp32: |d| <= 1e-4 |ref| + 1e-5 for y and dx (576 terms per entry);
  |d| <= 2e-5 S for dW (2,304 sequential fp32 additions at most per entry
  at the flagship shape: 8 tiles x 256 pixels in a block, then 256
  partials; the random-walk estimate sqrt(2304) * 2^-24 = 2.9e-6 S, with a
  7x margin, under the worst-case 2304 * 2^-24 = 1.4e-4 S).
* bf16: one rounding of the fp32 sum, |d| <= 2^-8 |ref| + 1e-5 S.
"""

import numpy as np
import pytest
import torch

import torch.nn.functional as F

from intro_tc_vae_tpu_torch.data import Synthetic
from intro_tc_vae_tpu_torch.models import Decoder, Encoder
from intro_tc_vae_tpu_torch.ops import conv, conv_cuda, tc_cuda
from intro_tc_vae_tpu_torch.solvers import make_optimizer, make_solver

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


def conv_bound(name, dtype, ref, s):
    if dtype == torch.bfloat16:
        return 2.0 ** -8 * ref.abs() + 1e-5 * s
    if name == "dw":
        return 2e-5 * s
    return 1e-4 * ref.abs() + 1e-5


@pytest.mark.parametrize("shape", [(2, 64, 32, 8), (3, 64, 20, 36), (128, 64, 64, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_conv_kernels_match_plain(dev, shape, dtype):
    """y, dx and dW; (3, 64, 20, 36) has ragged tiles in both H and W."""
    g = torch.Generator(device=dev).manual_seed(0)
    x = (torch.randn(shape, device=dev, generator=g) * 0.5).to(dtype)
    w = (torch.randn((64, 64, 3, 3), device=dev, generator=g) * 0.05).to(dtype)
    gy = torch.randn(shape, device=dev, generator=g).to(dtype)
    before = dict(conv_cuda.LAUNCHES)
    got = {"y": conv_cuda.conv3x3_fwd(x, w),
           "dx": conv_cuda.conv3x3_fwd(gy, conv.rot_t(w).contiguous()),
           "dw": conv_cuda.conv3x3_dw(x, gy)}
    torch.cuda.synchronize()
    assert {k: conv_cuda.LAUNCHES[k] - before[k] for k in conv_cuda.KERNELS} == \
        {"conv3x3_fwd": 2, "conv3x3_dw": 1, "conv3x3_dw_reduce": 1}
    xd, wd, gd = x.double(), w.double(), gy.double()
    want = {"y": (conv.conv3x3_reference(xd, wd), conv.conv3x3_reference(xd.abs(), wd.abs())),
            "dx": (conv.conv3x3_dx_reference(gd, wd),
                   conv.conv3x3_dx_reference(gd.abs(), wd.abs())),
            "dw": (conv.conv3x3_dw_reference(xd, gd),
                   conv.conv3x3_dw_reference(xd.abs(), gd.abs()))}
    for name, (ref, s) in want.items():
        assert got[name].dtype == dtype and got[name].shape == ref.shape
        d = (got[name].double() - ref).abs()
        assert bool((d <= conv_bound(name, dtype, ref, s)).all()), \
            f"{name}: max |d| {float(d.max()):.3g}"


@pytest.mark.parametrize("impl", ["pallas", "hybrid"])
def test_conv_autograd_matches_plain(dev, impl):
    """The autograd Function's y, dx and dW (fp32, at the flagship's
    32x32 block) against F.conv2d's autograd in float64 on the same
    inputs, with the kernel bounds above. (Against cuDNN's fp32 autograd
    the dW sums of 16,384 products differ by up to 3e-3 relative on small
    entries: both are fp32 sums in different orders.)"""
    g = torch.Generator(device=dev).manual_seed(1)
    x0 = torch.randn((16, 64, 32, 32), device=dev, generator=g) * 0.5
    w0 = torch.randn((64, 64, 3, 3), device=dev, generator=g) * 0.05
    cot = torch.randn((16, 64, 32, 32), device=dev, generator=g)
    fn = conv_cuda.conv3x3_pallas if impl == "pallas" else conv_cuda.conv3x3_hybrid
    results = []
    for f, dtype in ((fn, torch.float32),
                     (lambda a, b: F.conv2d(a, b, padding=1), torch.float64)):
        x = x0.to(dtype).clone().requires_grad_(True)
        w = w0.to(dtype).clone().requires_grad_(True)
        y = f(x, w)
        (y * cot.to(dtype)).sum().backward()
        results.append({"y": y.detach(), "dx": x.grad, "dw": w.grad})
    xa, wa, ca = x0.double().abs(), w0.double().abs(), cot.double().abs()
    sums = {"y": conv.conv3x3_reference(xa, wa), "dx": conv.conv3x3_dx_reference(ca, wa),
            "dw": conv.conv3x3_dw_reference(xa, ca)}
    got, want = results
    for name, s in sums.items():
        assert got[name].dtype == torch.float32
        d = (got[name].double() - want[name]).abs()
        assert bool((d <= conv_bound(name, torch.float32, want[name], s)).all()), \
            f"{name}: max |d| {float(d.max()):.3g}"


def test_intro_step_launches_no_weight_gradient_in_phase_e(dev):
    """channels (64,) at 32 px, paired intro_tc step; counts derived in
    tests/test_torch_conv.py::test_intro_step_computes_no_weight_gradient_
    of_the_other_network: phase E 24 conv3x3_fwd (forward and dx) and 4
    conv3x3_dw (the encoder's own convs only), phase D 20 and 8."""
    small = dict(arch="conv", cdim=3, zdim=8, channels=(64,), image_size=32,
                 conv_impl="pallas")
    torch.manual_seed(0)
    enc, dec = Encoder(**small).to(dev), Decoder(**small).to(dev)
    solver = make_solver("intro_tc", dataset=Synthetic(image_size=32, cdim=3,
                                                       sizes=(2, 2, 4, 4)),
                         encoder=enc, decoder=dec, batch_size=4,
                         optimizer_e=make_optimizer("adam", 2e-4),
                         optimizer_d=make_optimizer("adam", 2e-4), tc_impl="pallas")
    batch = torch.from_numpy(solver.dataset.get_batch(np.arange(4)).transpose(0, 3, 1, 2)
                             .copy()).to(dev)
    state = solver.init_state(0)
    conv_cuda.reset_launch_counts()
    at_opt_e = []
    state.opt_e.register_step_pre_hook(lambda *a: at_opt_e.append(dict(conv_cuda.LAUNCHES)))
    solver.train_step(state, batch)
    torch.cuda.synchronize()
    assert at_opt_e == [{"conv3x3_fwd": 24, "conv3x3_dw": 4, "conv3x3_dw_reduce": 4}]
    assert conv_cuda.LAUNCHES == {"conv3x3_fwd": 44, "conv3x3_dw": 12,
                                  "conv3x3_dw_reduce": 12}


def test_conv_wrapper_rejects_what_the_kernels_do_not_take(dev):
    x = torch.randn((2, 64, 16, 8), device=dev)
    w = torch.randn((64, 64, 3, 3), device=dev)
    with pytest.raises(TypeError):
        conv_cuda.conv3x3_fwd(x.double(), w.double())
    with pytest.raises(TypeError):
        conv_cuda.conv3x3_fwd(x, w.bfloat16())
    with pytest.raises(ValueError):
        conv_cuda.conv3x3_fwd(x.transpose(2, 3), w)
    with pytest.raises(ValueError):
        conv_cuda.conv3x3_fwd(x[:, :32].contiguous(), w)
    with pytest.raises(ValueError):
        conv_cuda.conv3x3_fwd(x, w.cpu())
    with pytest.raises(ValueError):
        conv_cuda.conv3x3_dw(x, x[:1])
