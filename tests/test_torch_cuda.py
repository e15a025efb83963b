"""The port's CUDA kernels on the card (marker ``cuda``): the TC kernels
and the 3x3 conv kernels; and the loader's device side (the uint8 table,
the cache's gather and flip, the prefetch stream).

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
* fp32 (csrc/conv_fp32.cu): |d| <= 1e-4 |ref| + 1e-5 for y and dx (576
  terms per entry); |d| <= 2e-5 S for dW (4,228 sequential fp32 additions
  per entry at [128, 64, 64, 64]: 8 units x 512 pixels in a block, then
  132 partials; the random-walk estimate sqrt(4228) * 2^-24 = 3.9e-6 S,
  with a 5x margin, under the worst case 4228 * 2^-24 = 2.5e-4 S).
* bf16: one rounding of the fp32 sum, |d| <= 2^-8 |ref| + 1e-5 S. bf16
  runs the wgmma kernels (csrc/conv_wgmma.cu), W in {32, 64, 128} through
  the wgmma entry points and every other even W through the ragged ones,
  whose dW chain is short (one addition per 16 pixels of a block's rows,
  then at most 132 partials): the same bound holds them.
"""

import numpy as np
import pytest
import torch

import torch.nn.functional as F

from intro_tc_vae_tpu_torch.data import DeviceLoader, Synthetic
from intro_tc_vae_tpu_torch.data.datasets import _ArrayDataset
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


@pytest.mark.parametrize("world,rank", [(2, 1), (8, 5)])
def test_gathered_kernels_match_plain(dev, world, rank):
    """The data-parallel form: rank r's rows of z and logvar (global batch
    128, Z 128, N 1280) against the whole mu bank, row_off = r * 128 / R;
    values and the gradients of z, logvar and the whole bank, against the
    plain gathered version in float64."""
    gb = 128
    z, mu, logvar = _inputs(gb, 128)
    b = gb // world
    rows = slice(rank * b, (rank + 1) * b)
    before, calls = dict(tc_cuda.LAUNCHES), dict(tc_cuda.CALLS)
    outs = []
    for fn, dtype in ((tc_cuda.tc_logsumexp_cuda_gathered, torch.float32),
                      (tc_cuda.tc_logsumexp_reference_gathered, torch.float64)):
        args = [torch.tensor(a, device=dev, dtype=dtype, requires_grad=True)
                for a in (z[rows], mu, logvar[rows])]
        pm, qz = fn(*args, rank * b, 1280, gb)
        ((qz - pm).sum() / gb + 0.5e-3 * pm.sum()).backward()
        outs.append([pm.detach(), qz.detach()] + [a.grad for a in args])
    torch.cuda.synchronize()
    assert outs[0][3].shape == (gb, 128)  # dmu of the whole bank
    for got, want in zip(*outs):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    assert {k: tc_cuda.LAUNCHES[k] - before[k] for k in tc_cuda.KERNELS} == \
        dict.fromkeys(tc_cuda.KERNELS, 1)
    assert {k: tc_cuda.CALLS[k] - calls[k] for k in tc_cuda.CALLS} == \
        {"tc_logsumexp": 0, "tc_logsumexp_gathered": 1}


def _tc_grads(fn, dtype, arrays, rows, dev, *extra):
    """pm, qz and the gradients of z, the whole bank and logvar for the
    rows' share of the loss, as float64 numpy."""
    gb = arrays[1].shape[0]
    args = [torch.tensor(a, device=dev, dtype=dtype, requires_grad=True)
            for a in (arrays[0][rows], arrays[1], arrays[2][rows])]
    pm, qz = fn(*args, *extra)
    ((qz - pm).sum() / gb + 0.5e-3 * pm.sum()).backward()
    torch.cuda.synchronize()
    return {k: v.detach().double().cpu().numpy() for k, v in
            dict(pm=pm, qz=qz, dz=args[0].grad, dmu=args[1].grad, dlogvar=args[2].grad).items()}


# (rows, row_off, bank, Z): Z no multiple of 32; rows and a bank that differ
# and are no multiple of a slice (8) or a chunk (32); a single short slice;
# 16 slices of 16 with two rows a thread
TC_SHAPES = [(40, 0, 40, 72), (37, 5, 90, 72), (3, 0, 3, 5), (64, 64, 128, 128),
             (256, 0, 256, 128), (200, 0, 200, 33)]


@pytest.mark.parametrize("b,off,gb,zdim", TC_SHAPES)
def test_backward_kernels_match_plain_and_repeat_bit_for_bit(dev, b, off, gb, zdim):
    """tc_bwd_dz and tc_bwd_dmu (and tc_fwd, whose terms and psum they read)
    against the float64 plain version; a second run gives the same bits
    (ordered partial sums, no atomics)."""
    arrays = _inputs(gb, zdim, seed=gb)
    rows, extra = slice(off, off + b), (off, 20 * gb, gb)
    got = _tc_grads(tc_cuda.tc_logsumexp_cuda_gathered, torch.float32, arrays, rows, dev, *extra)
    again = _tc_grads(tc_cuda.tc_logsumexp_cuda_gathered, torch.float32, arrays, rows, dev,
                      *extra)
    want = _tc_grads(tc_cuda.tc_logsumexp_reference_gathered, torch.float64, arrays, rows, dev,
                     *extra)
    assert got["dmu"].shape == (gb, zdim)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
        np.testing.assert_array_equal(got[key], again[key], err_msg=key)


@pytest.mark.parametrize("b,off,gb,zdim", TC_SHAPES + [(48, 0, 48, 1024), (16, 40, 64, 1024)])
def test_forward_kernel_matches_its_split_reference_and_repeats_bit_for_bit(dev, b, off, gb,
                                                                           zdim):
    """tc_fwd's psum, terms (z, 1/v, c, c - lm) and lj against
    ``tc_forward_split_reference`` in float64 on the same float32 inputs,
    which sums in the kernel's order, at rtol 1e-10 / atol 1e-10 (the
    kernel's exp, a degree-11 polynomial, is within 6e-15 of the result);
    pm and qz, written in float32, at rtol 1e-4 / atol 1e-5. Z = 1024 takes
    32 latents a lane. A second run gives the same bits."""
    z, mu, logvar = (torch.tensor(a, device=dev) for a in _inputs(gb, zdim, seed=gb))
    z, logvar = z[off:off + b].contiguous(), logvar[off:off + b].contiguous()
    n = 20 * gb
    runs = []
    for _ in range(2):
        terms, psum, lj = tc_cuda.forward_buffers(b, gb, zdim, dev)
        pm, qz = torch.empty(b, device=dev), torch.empty(b, device=dev)
        tc_cuda.launch("tc_fwd", (z, mu, logvar, terms, psum, lj, pm, qz), b, gb, zdim, n,
                       dev, off)
        torch.cuda.synchronize()
        runs.append(dict(terms=terms, psum=psum, lj=lj, pm=pm, qz=qz))
    z64, mu64, lv64 = z.double(), mu.double(), logvar.double()
    ref = tc_cuda.tc_forward_split_reference(z64, mu64, lv64, off, n)
    v = torch.clamp(torch.exp(lv64), min=1e-4)
    c = -0.5 * (torch.log(v) + np.log(2 * np.pi))
    want = dict(terms=torch.stack([z64, 1.0 / v, c, c - ref.lm], dim=-1), psum=ref.psum,
                lj=ref.lj, pm=ref.pm, qz=ref.qz)
    for key, w in want.items():
        got = runs[0][key]
        assert got.shape == w.shape, key
        tol = TOL if got.dtype == torch.float32 else dict(rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(got.double().cpu().numpy(), w.cpu().numpy(), err_msg=key,
                                   **tol)
        assert torch.equal(got, runs[1][key]), key


def test_forward_launcher_refuses_a_plan_that_is_not_forward_plans(dev):
    """tc_fwd_launch recomputes ``forward_plan``'s cut of the bank and
    launches nothing on any other; on that cut it launches."""
    b = zdim = 64
    z, mu, logvar = (torch.tensor(a, device=dev) for a in _inputs(b, zdim))
    terms, psum, lj = tc_cuda.forward_buffers(b, b, zdim, dev)
    pm, qz = torch.empty(b, device=dev), torch.empty(b, device=dev)
    good = tc_cuda.forward_plan(b, zdim)
    assert good == (8, 8, 2)
    before = dict(tc_cuda.LAUNCHES)
    for bad in (good._replace(slice_len=16, n_slices=4), good._replace(n_slices=7),
                good._replace(slice_len=16), tc_cuda.ForwardPlan(64, 1, 2)):
        with pytest.raises(RuntimeError, match="tc_fwd"):
            tc_cuda.launch("tc_fwd", (z, mu, logvar, terms, psum, lj, pm, qz), b, b, zdim,
                           1280, dev, plan=bad)
    assert tc_cuda.LAUNCHES == before
    tc_cuda.launch("tc_fwd", (z, mu, logvar, terms, psum, lj, pm, qz), b, b, zdim, 1280, dev,
                   plan=good)
    torch.cuda.synchronize()
    assert tc_cuda.LAUNCHES["tc_fwd"] == before["tc_fwd"] + 1


@pytest.mark.parametrize("world", [2, 8])
def test_gathered_rows_equal_the_single_device_rows_bit_for_bit(dev, world):
    """The ranks' pm, qz, dz and dlogvar rows (global batch 128, Z 128),
    concatenated, are the single-device kernels' bit for bit: their sums run
    over the bank, whose cut into slices follows from its length alone. dmu
    sums over a rank's rows; the ranks' banks add up to the single-device
    dmu within the tolerance."""
    gb = 128
    arrays = _inputs(gb, 128)
    whole = _tc_grads(tc_cuda.tc_logsumexp_cuda, torch.float32, arrays, slice(None), dev, 1280)
    b = gb // world
    parts = [_tc_grads(tc_cuda.tc_logsumexp_cuda_gathered, torch.float32, arrays,
                       slice(r * b, (r + 1) * b), dev, r * b, 1280, gb) for r in range(world)]
    for key in ("pm", "qz", "dz", "dlogvar"):
        np.testing.assert_array_equal(np.concatenate([p[key] for p in parts]), whole[key],
                                      err_msg=key)
    np.testing.assert_allclose(sum(p["dmu"] for p in parts), whole["dmu"], **TOL)


@pytest.mark.parametrize("b,gb", [(64, 64), (64, 128), (256, 256)])
def test_rows_a_thread_change_no_bit(dev, b, gb):
    """``backward_plan`` picks how many output rows a thread takes from the
    size of the launch; any other choice the kernels are built for gives the
    same bits, since the slices (``reduce_slices``) are the same."""
    zdim, n = 128, 20 * gb
    z, mu, logvar = (torch.tensor(a, device=dev) for a in _inputs(gb, zdim))
    z, logvar = z[:b].contiguous(), logvar[:b].contiguous()
    terms, psum, lj = tc_cuda.forward_buffers(b, gb, zdim, dev)
    pm, qz = torch.empty(b, device=dev), torch.empty(b, device=dev)
    g_m = torch.linspace(0.5, 1.5, b, device=dev) * (-1.0 / gb + 5e-4)
    g_j = torch.linspace(0.5, 1.5, b, device=dev) / gb
    tc_cuda.launch("tc_fwd", (z, mu, logvar, terms, psum, lj, pm, qz), b, gb, zdim, n, dev)
    results = {}
    for name, rows in (("tc_bwd_dz", (1, 2)), ("tc_bwd_dmu", (1, 2, 4))):
        base = tc_cuda.backward_plan(name, b, gb, zdim)
        for r in rows:
            dz, dlv, dmu = torch.zeros_like(z), torch.zeros_like(z), torch.zeros_like(mu)
            tensors = ((terms, mu, logvar, psum, lj, g_m, g_j, dz, dlv) if name == "tc_bwd_dz"
                       else (terms, mu, psum, lj, g_m, g_j, dmu))
            tc_cuda.launch(name, tensors, b, gb, zdim, n, dev, plan=base._replace(rows=r))
            torch.cuda.synchronize()
            results[name, r] = (dz, dlv) if name == "tc_bwd_dz" else (dmu,)
        for r in rows[1:]:
            for a, c in zip(results[name, rows[0]], results[name, r]):
                assert a.abs().sum() > 0 and torch.equal(a, c), (name, r)


def test_backward_launchers_refuse_a_plan_that_is_not_the_cut(dev):
    """The launchers check the plan they are given: rows they are not built
    for, slices that do not cover the reduced axis exactly once, more than
    16 slices. And the forward's scratch that the card cannot hold is
    refused with the size it would take; nothing else computes the op."""
    b = zdim = 64
    z, mu, logvar = (torch.tensor(a, device=dev) for a in _inputs(b, zdim))
    terms, psum, lj = tc_cuda.forward_buffers(b, b, zdim, dev)
    g = torch.ones(b, device=dev)
    dz, dlv, dmu = torch.empty_like(z), torch.empty_like(z), torch.empty_like(mu)
    dz_args = (terms, mu, logvar, psum, lj, g, g, dz, dlv)
    good = tc_cuda.backward_plan("tc_bwd_dz", b, b, zdim)
    assert good == (1, 8, 8)
    before = dict(tc_cuda.LAUNCHES)
    for bad in ((3, 8, 8), (4, 8, 8), (1, 8, 7), (1, 8, 9), (1, 0, 8), (1, 2, 32)):
        with pytest.raises(RuntimeError, match="tc_bwd_dz"):
            tc_cuda.launch("tc_bwd_dz", dz_args, b, b, zdim, 1280, dev,
                           plan=tc_cuda.BackwardPlan(*bad))
    with pytest.raises(RuntimeError, match="tc_bwd_dmu"):
        tc_cuda.launch("tc_bwd_dmu", (terms, mu, psum, lj, g, g, dmu), b, b, zdim, 1280, dev,
                       plan=tc_cuda.BackwardPlan(3, 8, 8))
    assert tc_cuda.LAUNCHES == before  # a refused launch is not counted
    with pytest.raises(RuntimeError, match=r"scratch.*cannot allocate"):
        tc_cuda.forward_buffers(400_000, 400_000, 128, dev)  # psum alone: 1.28 TB


def test_gathered_wrapper_rejects_what_the_kernels_do_not_take(dev):
    z, mu, logvar = (torch.tensor(a, device=dev) for a in _inputs(16, 8))
    zl, lvl = z[8:].contiguous(), logvar[8:].contiguous()
    gathered = tc_cuda.tc_logsumexp_cuda_gathered
    with pytest.raises(ValueError):  # rows past the global batch
        gathered(zl, mu, lvl, 9, 64, 16)
    with pytest.raises(ValueError):  # a bank that is not the global batch
        gathered(zl, mu[:12], lvl, 4, 64, 16)
    with pytest.raises(ValueError):  # N below the global batch
        gathered(zl, mu, lvl, 8, 12, 16)
    with pytest.raises(ValueError):
        gathered(zl, mu.cpu(), lvl, 8, 64, 16)


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


def conv_counts(fwd, dw, body):
    """conv_cuda.LAUNCHES after `fwd` conv3x3_fwd and `dw` conv3x3_dw calls,
    all by one body (``conv.kernel_body``): every forward packs its weights
    first; the fp32 bodies count under the wrappers' own names."""
    zero = dict.fromkeys(conv_cuda.KERNELS, 0)
    suffix = "" if body == "fp32" else f"_{body}"
    return {**zero, f"conv3x3_fwd{suffix}": fwd, "conv3x3_pack_w": fwd,
            f"conv3x3_dw{suffix}": dw, "conv3x3_dw_reduce": dw}


def conv_bound(name, dtype, ref, s):
    if dtype == torch.bfloat16:
        return 2.0 ** -8 * ref.abs() + 1e-5 * s
    if name == "dw":
        return 2e-5 * s
    return 1e-4 * ref.abs() + 1e-5


@pytest.mark.parametrize("shape", [(2, 64, 32, 8), (3, 64, 20, 36), (128, 64, 64, 64),
                                   (1, 64, 16, 4), (2, 64, 16, 6), (1, 64, 128, 128)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_conv_kernels_match_plain(dev, shape, dtype):
    """y, dx and dW; (3, 64, 20, 36) has ragged tiles in both H and W, W = 4
    and 6 rows that are no multiple of 16 bytes, W = 128 two column chunks."""
    g = torch.Generator(device=dev).manual_seed(0)
    x = (torch.randn(shape, device=dev, generator=g) * 0.5).to(dtype)
    w = (torch.randn((64, 64, 3, 3), device=dev, generator=g) * 0.05).to(dtype)
    gy = torch.randn(shape, device=dev, generator=g).to(dtype)
    before = dict(conv_cuda.LAUNCHES)
    got = {"y": conv_cuda.conv3x3_fwd(x, w),
           "dx": conv_cuda.conv3x3_fwd(gy, w, rot=True),
           "dw": conv_cuda.conv3x3_dw(x, gy)}
    torch.cuda.synchronize()
    assert {k: conv_cuda.LAUNCHES[k] - before[k] for k in conv_cuda.KERNELS} == \
        conv_counts(2, 1, conv.kernel_body(shape, dtype))
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
    # fp32: the fp32 bodies, one pack per forward or dx
    assert at_opt_e == [conv_counts(24, 4, "fp32")]
    assert conv_cuda.LAUNCHES == conv_counts(44, 12, "fp32")


def test_fp32_cli_step_computes_cudnn_convs_in_true_fp32(dev, tmp_path):
    """``precision: "fp32"`` through the CLI with ``conv_impl: "xla"``
    (cuDNN computes every conv): configs/vae_synthetic.json at the
    synthetic_small size, one step of batch 64. Entered with both TF32
    switches on, as PyTorch leaves cuDNN's by default, the run equals the
    same run entered with both off: parameters within 2 * lr (Adam's first
    update is lr * sign(g)), the step's losses within rtol 1e-5, where TF32's
    10-bit products would move them by ~1e-3. The switches come back as
    they were. The runs' checkpoints go under ``tmp_path``."""
    import json
    import os

    from intro_tc_vae_tpu_torch import main

    config = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "configs", "vae_synthetic.json")
    update = json.dumps({"dataset": "synthetic_small", "conv_impl": "xla", "num_epochs": 1,
                         "batch_size": 64, "z_dim": 8, "use_tensorboard": False,
                         "checkpoint_dir": str(tmp_path)})
    runs = {}
    for tf32 in (True, False):
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        state = main.cli(["-f", config, "-u", update])
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == \
            (tf32, tf32)
        assert state.step == 1
        runs[tf32] = state
    lr = runs[True].opt_e.param_groups[0]["lr"]
    for k in ("loss_enc", "loss_rec", "loss_kl"):
        np.testing.assert_allclose(runs[True].history[0][k], runs[False].history[0][k],
                                   rtol=1e-5, err_msg=k)
    want = runs[False].model.state_dict()
    for k, v in runs[True].model.state_dict().items():
        assert float((v - want[k]).abs().max()) <= 2 * lr, k


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
    with pytest.raises(TypeError):
        conv_cuda.conv3x3_dw(x, x.bfloat16())
    with pytest.raises(TypeError):
        conv_cuda.conv3x3_pack_w(w.double())
    with pytest.raises(ValueError):
        conv_cuda.conv3x3_pack_w(w[:, :32].contiguous())
    # the fp32 launcher itself refuses more blocks than units
    part = torch.empty((3, 576, 64), device=dev)
    with pytest.raises(RuntimeError):
        conv_cuda.launch("conv3x3_dw_fp32", x, x, part, 2, 16, 8, 3, device=dev)
    # bf16: an odd W raises in the wrapper; the ragged launcher refuses one,
    # and the wgmma launcher any W outside {32, 64, 128}
    xb = torch.randn((1, 64, 16, 7), device=dev).bfloat16()
    with pytest.raises(ValueError):
        conv_cuda.conv3x3_fwd(xb, w.bfloat16())
    with pytest.raises(RuntimeError):
        conv_cuda.launch("conv3x3_dw_ragged", xb, xb, part, 1, 16, 7, 16, 1, device=dev)
    xb = torch.randn((1, 64, 16, 48), device=dev).bfloat16()
    with pytest.raises(RuntimeError):
        conv_cuda.launch("conv3x3_dw_wgmma", xb, xb, part, 1, 16, 48, 16, 1, device=dev)


WGMMA_SHAPES = [(4, 64, 16, 32), (3, 64, 24, 64), (2, 64, 16, 128), (128, 64, 32, 32)]
# the ragged entry points: one part-filled box (TMA), rows TMA cannot land
# (W % 8 = 4), a full and a part-filled box, 16 boxes a row, the narrow end,
# 16- and 32-pixel boxes landed by TMA, a free H
RAGGED_SHAPES = [(8, 64, 48, 48), (4, 64, 32, 36), (2, 64, 16, 96), (1, 64, 16, 1016),
                 (2, 64, 16, 6), (3, 64, 16, 8), (2, 64, 32, 24), (3, 64, 20, 36)]


@pytest.mark.parametrize("shape", WGMMA_SHAPES + RAGGED_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_wgmma_conv_kernels_match_plain(dev, shape):
    """bf16: the wgmma entry points at W in {32, 64, 128} and the ragged
    ones elsewhere, against the float64 plain version; the packed weights
    equal the plain pack bit for bit; two dW runs are bit-equal (ordered
    partial sums, no atomics)."""
    dtype = torch.bfloat16
    body = conv.kernel_body(shape, dtype)
    assert body == ("wgmma" if shape in WGMMA_SHAPES else "ragged")
    g = torch.Generator(device=dev).manual_seed(2)
    x = (torch.randn(shape, device=dev, generator=g) * 0.5).to(dtype)
    w = (torch.randn((64, 64, 3, 3), device=dev, generator=g) * 0.05).to(dtype)
    gy = torch.randn(shape, device=dev, generator=g).to(dtype)
    for rot in (False, True):
        assert torch.equal(conv_cuda.conv3x3_pack_w(w, rot), conv.pack_weights(w, rot))
    conv_cuda.reset_launch_counts()
    got = {"y": conv_cuda.conv3x3_fwd(x, w),
           "dx": conv_cuda.conv3x3_fwd(gy, w, rot=True),
           "dw": conv_cuda.conv3x3_dw(x, gy)}
    again = conv_cuda.conv3x3_dw(x, gy)
    torch.cuda.synchronize()
    assert conv_cuda.LAUNCHES == conv_counts(2, 2, body)
    assert torch.equal(got["dw"], again)
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


@pytest.mark.parametrize("shape", [(6, 64, 16, 64), (3, 64, 20, 36), (4, 64, 16, 48),
                                   (2, 64, 16, 6), (1, 64, 16, 1016)],
                         ids=lambda s: "x".join(map(str, s)))
def test_wgmma_dw_equals_its_partials_reference(dev, shape):
    """The kernel's per-block fp32 partials against the plain split sum by
    the same schedule (ops/conv.py::conv3x3_dw_partials_reference, the last
    box of a row cut at W): each partial within 1e-5 S of it (the order
    inside a block differs), and the rounded dW within the bf16 bound."""
    dtype = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(3)
    x = (torch.randn(shape, device=dev, generator=g) * 0.5).to(dtype)
    gy = torch.randn(shape, device=dev, generator=g).to(dtype)
    want_dw, want_parts = conv.conv3x3_dw_partials_reference(x, gy, conv_cuda.sm_count(dev))
    body, n_parts, rc = conv_cuda.dw_parts(shape, dtype, dev)
    assert body == ("wgmma" if shape[3] == 64 else "ragged")
    assert n_parts == want_parts.shape[0]
    part = torch.empty((n_parts, 576, 64), device=dev)
    conv_cuda.launch(f"conv3x3_dw_{body}", x, gy, part, *(shape[0], *shape[2:]), rc, n_parts,
                     device=dev)
    torch.cuda.synchronize()
    # part[p][tap * 64 + ci][co] -> [p][co][ci][ky][kx]
    got_parts = part.view(n_parts, 3, 3, 64, 64).permute(0, 4, 3, 1, 2)
    s = conv.conv3x3_dw_reference(x.double().abs(), gy.double().abs())
    assert bool(((got_parts.double() - want_parts.double()).abs() <= 1e-5 * s).all())
    d = (conv_cuda.conv3x3_dw(x, gy).double() - want_dw.double()).abs()
    assert bool((d <= 2.0 ** -7 * want_dw.double().abs() + 1e-5 * s).all())  # two roundings


@pytest.mark.parametrize("shape", [(6, 64, 16, 64), (3, 64, 20, 36), (2, 64, 16, 6),
                                   (40, 64, 32, 32)], ids=lambda s: "x".join(map(str, s)))
def test_fp32_dw_equals_its_partials_reference(dev, shape):
    """The fp32 kernel's per-block partials against the plain split sum by
    the same schedule (conv3x3_dw_partials_reference with
    fp32_tile_schedule), partial by partial in block order: each within
    1e-5 S (the order inside a block differs); dW is their ordered sum, so
    it equals the kernel's partials added in that order bit for bit, and
    two runs are bit-equal."""
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(shape, device=dev, generator=g) * 0.5
    gy = torch.randn(shape, device=dev, generator=g)
    want_dw, want_parts = conv.conv3x3_dw_partials_reference(
        x, gy, conv_cuda.sm_count(dev), conv.fp32_tile_schedule)
    body, n_parts, _ = conv_cuda.dw_parts(shape, torch.float32, dev)
    assert body == "fp32" and n_parts == want_parts.shape[0]
    part = torch.empty((n_parts, 576, 64), device=dev)
    conv_cuda.launch("conv3x3_dw_fp32", x, gy, part, *(shape[0], *shape[2:]), n_parts,
                     device=dev)
    dw = conv_cuda.conv3x3_dw(x, gy)
    torch.cuda.synchronize()
    # part[p][tap * 64 + ci][co] -> [p][co][ci][ky][kx]
    got_parts = part.view(n_parts, 3, 3, 64, 64).permute(0, 4, 3, 1, 2)
    s = conv.conv3x3_dw_reference(x.double().abs(), gy.double().abs())
    assert bool(((got_parts.double() - want_parts.double()).abs() <= 1e-5 * s).all())
    total = torch.zeros_like(dw)
    for p in got_parts:
        total += p
    assert torch.equal(dw, total)
    assert torch.equal(dw, conv_cuda.conv3x3_dw(x, gy))
    assert bool(((dw.double() - want_dw.double()).abs() <= 2e-5 * s).all())


@pytest.mark.parametrize("impl", ["pallas", "hybrid"])
def test_wgmma_conv_autograd_matches_plain(dev, impl):
    """Autograd through both routings in bf16 at the flagship's 32x32 block
    (the wgmma bodies, by LAUNCHES) against F.conv2d's autograd in
    float64 on the same bf16-rounded inputs; dW comes back in w's dtype
    after one bf16 rounding."""
    dtype = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(4)
    x0 = (torch.randn((16, 64, 32, 32), device=dev, generator=g) * 0.5).to(dtype)
    w0 = (torch.randn((64, 64, 3, 3), device=dev, generator=g) * 0.05).to(dtype)
    cot = torch.randn((16, 64, 32, 32), device=dev, generator=g).to(dtype)
    fn = conv_cuda.conv3x3_pallas if impl == "pallas" else conv_cuda.conv3x3_hybrid
    conv_cuda.reset_launch_counts()
    results = []
    for f, dt in ((fn, dtype), (lambda a, b: F.conv2d(a, b, padding=1), torch.float64)):
        x = x0.to(dt).clone().requires_grad_(True)
        w = w0.to(dt).clone().requires_grad_(True)
        y = f(x, w)
        torch.autograd.backward(y, cot.to(dt))
        results.append({"y": y.detach(), "dx": x.grad, "dw": w.grad})
    fwd = 2 if impl == "pallas" else 1
    assert conv_cuda.LAUNCHES == conv_counts(fwd, 1, "wgmma")
    xa, wa, ca = x0.double().abs(), w0.double().abs(), cot.double().abs()
    sums = {"y": conv.conv3x3_reference(xa, wa), "dx": conv.conv3x3_dx_reference(ca, wa),
            "dw": conv.conv3x3_dw_reference(xa, ca)}
    got, want = results
    for name, s in sums.items():
        if name == "y" and impl == "hybrid":
            continue  # the stock forward
        assert got[name].dtype == dtype
        d = (got[name].double() - want[name]).abs()
        assert bool((d <= conv_bound(name, dtype, want[name], s)).all()), \
            f"{name}: max |d| {float(d.max()):.3g}"


# ---------------------------------------------------------------------------
# the loader's device side
# ---------------------------------------------------------------------------

def test_uint8_table_on_the_card_equals_the_host_divide(dev):
    """All 256 values through ``u8_to_unit_f32`` on the card bit-equal
    numpy's ``/ 255``; whether a plain divide on the card is too is printed
    (the table stays unless it is)."""
    from intro_tc_vae_tpu_torch.solvers.base import u8_to_unit_f32

    u8 = torch.arange(256, dtype=torch.uint8, device=dev).reshape(1, 1, 16, 16)
    want = np.arange(256, dtype=np.float32) / 255.0
    np.testing.assert_array_equal(u8_to_unit_f32(u8).cpu().numpy().ravel(), want)
    plain = (u8.float() / 255).cpu().numpy().ravel()
    print(f"u8.float() / 255 on the card: {int((plain != want).sum())} of 256 values "
          "differ from the host's divide")


class _Flips(_ArrayDataset):
    """uint8 images with flips drawn per batch from a seeded RNG."""

    def __init__(self, imgs, seed):
        super().__init__(imgs, np.zeros((len(imgs), 1)), resize=imgs.shape[1])
        self._flip_rng = np.random.RandomState(seed)

    def flip_flags(self, n):
        return (self._flip_rng.rand(n) < 0.5).astype(np.uint8)

    def get_batch_raw(self, indices):
        arr = super().get_batch_raw(indices).copy()
        flags = self.flip_flags(len(arr)).astype(bool)
        arr[flags] = arr[flags, :, ::-1, :]
        return arr


def test_cached_gather_and_flip_equal_the_host_path(dev):
    """The cache on the card (gather and flip there) gives the uint8
    batches the host path gathers and flips, with the same flag stream;
    each step copies only the index and flag vectors."""
    imgs = np.random.RandomState(0).randint(0, 256, (96, 64, 64, 3), dtype=np.uint8)
    cached = DeviceLoader(_Flips(imgs, 3), 32, dev, seed=1, device_cache="force")
    host = DeviceLoader(_Flips(imgs, 3), 32, torch.device("cpu"), seed=1,
                        transfer_dtype="uint8")
    got, want = list(cached), list(host)
    assert cached.cache is not None and cached.cache.is_cuda
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == torch.uint8
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
    assert cached.stats.h2d_bytes == 3 * 32 * (8 + 1)


@pytest.mark.parametrize("transfer", ["float32", "uint8"])
def test_prefetch_stream_batches_equal_the_cpu_loader(dev, transfer):
    """Batches copied on the producer's stream, three ahead, equal the
    CPU loader's (no stream, no thread's copy) after the consumer's stream
    has waited on them and run a kernel on each."""
    imgs = np.random.RandomState(1).randint(0, 256, (256, 64, 64, 3), dtype=np.uint8)
    ds = _ArrayDataset(imgs, np.zeros((256, 1)), resize=64)
    card = DeviceLoader(ds, 64, dev, seed=2, prefetch=3, transfer_dtype=transfer)
    cpu = DeviceLoader(ds, 64, torch.device("cpu"), seed=2, transfer_dtype=transfer)
    for epoch in range(2):
        got = [(x * 1).cpu() for x in card]  # a kernel on the consumer's stream
        want = list(cpu)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    per = 64 * 3 * 64 * 64 * (4 if transfer == "float32" else 1)
    assert card.stats.batches == 8 and card.stats.h2d_bytes == 8 * per
