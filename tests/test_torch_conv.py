"""PyTorch port vs JAX package: the 3x3 conv kernels' function, gate and
routing, on the CPU.

* The port's conv (``conv3x3_pallas`` / ``conv3x3_hybrid``, which on CPU
  tensors take the kernels' plain versions through the same
  ``torch.autograd.Function``) against the JAX Pallas kernel run in
  interpret mode (``pltpu.force_tpu_interpret_mode``, as
  tests/test_conv_pallas.py runs it), forward and both gradients, NHWC <->
  NCHW, fp32. Tolerances as in the JAX package's own test: 1e-5 for the
  forward, 1e-4 for the gradients.
* ``supported`` gives the answers of the JAX gate.
* The flagship models route exactly the convs the JAX gate accepts.
* The intro step differentiates only the network a phase updates: the
  weight gradient of the other network is never computed (call counts).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from intro_tc_vae_tpu.ops.conv_pallas import conv3x3_hybrid as jconv3x3_hybrid
from intro_tc_vae_tpu.ops.conv_pallas import conv3x3_pallas as jconv3x3_pallas
from intro_tc_vae_tpu.ops.conv_pallas import supported as jsupported
from intro_tc_vae_tpu_torch.data import Synthetic
from intro_tc_vae_tpu_torch.models import Decoder, Encoder, PallasConv3x3, SoftIntroVAE
from intro_tc_vae_tpu_torch.models import blocks
from intro_tc_vae_tpu_torch.ops import conv, conv_cuda
from intro_tc_vae_tpu_torch.solvers import make_optimizer, make_solver

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _port_grads(fn, x, w, cot):
    xt = _nchw(x).requires_grad_(True)
    wt = _oihw(w).requires_grad_(True)
    y = fn(xt, wt)
    (y * _nchw(cot)).sum().backward()
    return (y.detach().numpy().transpose(0, 2, 3, 1), xt.grad.numpy().transpose(0, 2, 3, 1),
            wt.grad.numpy().transpose(2, 3, 1, 0))


def _jax_grads(fn, x, w, cot):
    x, w, cot = jnp.asarray(x), jnp.asarray(w), jnp.asarray(cot)
    with pltpu.force_tpu_interpret_mode():
        y = fn(x, w)
        dx, dw = jax.grad(lambda a, b: jnp.vdot(fn(a, b), cot), argnums=(0, 1))(x, w)
    return np.asarray(y), np.asarray(dx), np.asarray(dw)


def _check(port_fn, jax_fn, shape, seed):
    x = _rand(shape, seed, 0.5)
    w = _rand((3, 3, 64, 64), seed + 1, 0.1)
    cot = _rand(shape, seed + 2)
    (y, dx, dw), (y_ref, dx_ref, dw_ref) = (_port_grads(port_fn, x, w, cot),
                                             _jax_grads(jax_fn, x, w, cot))
    np.testing.assert_allclose(y, y_ref, err_msg="y", **FWD_TOL)
    np.testing.assert_allclose(dx, dx_ref, err_msg="dx", **GRAD_TOL)
    np.testing.assert_allclose(dw, dw_ref, err_msg="dw", **GRAD_TOL)


# the shapes of tests/test_conv_pallas.py:55-60, and the flagship's 32x32 block
@pytest.mark.parametrize("shape,tile_h", [
    ((1, 16, 8, 64), 16),
    ((2, 32, 8, 64), 16),
    ((1, 48, 8, 64), 16),
    ((2, 32, 16, 64), None),
    ((2, 32, 32, 64), None),
])
def test_conv3x3_pallas_matches_jax_kernel(shape, tile_h):
    _check(conv_cuda.conv3x3_pallas, lambda x, w: jconv3x3_pallas(x, w, tile_h), shape, 3)


@pytest.mark.parametrize("shape,tile_h", [((2, 32, 8, 64), 16), ((2, 32, 32, 64), None)])
def test_conv3x3_hybrid_matches_jax_kernel(shape, tile_h):
    _check(conv_cuda.conv3x3_hybrid, lambda x, w: jconv3x3_hybrid(x, w, tile_h, True),
           shape, 11)


def test_bf16_weight_gradient_is_rounded_to_the_compute_dtype():
    """dW is summed in fp32 and rounded once to w's dtype (JAX
    ``dw.astype(w.dtype)``, conv_pallas.py:372), then cast back to the fp32
    parameter by autograd."""
    x = _nchw(_rand((2, 16, 8, 64), 5, 0.5)).bfloat16()
    w32 = _oihw(_rand((3, 3, 64, 64), 6, 0.1)).requires_grad_(True)
    gy = _nchw(_rand((2, 16, 8, 64), 7)).bfloat16()
    y = conv_cuda.conv3x3_pallas(x, w32.bfloat16())
    assert y.dtype == torch.bfloat16
    y.backward(gy)
    assert w32.grad.dtype == torch.float32
    want = conv.conv3x3_dw_reference(x, gy).float()
    assert torch.equal(w32.grad, want)
    assert torch.equal(w32.grad, w32.grad.bfloat16().float())


# tests/test_conv_pallas.py::test_supported_gating, NHWC shapes and HWIO weights
GATE = [
    ((4, 64, 64, 64), (3, 3, 64, 64), True),
    ((4, 32, 32, 64), (3, 3, 64, 64), True),
    ((4, 128, 128, 64), (3, 3, 64, 64), True),
    ((4, 64, 64, 128), (3, 3, 128, 64), False),
    ((4, 64, 64, 64), (5, 5, 64, 64), False),
    ((4, 60, 64, 64), (3, 3, 64, 64), False),
    ((4, 16, 7, 64), (3, 3, 64, 64), False),
    ((4, 256, 256, 64), (3, 3, 64, 64), False),
]


@pytest.mark.parametrize("x_shape,w_shape,want", GATE)
def test_supported_matches_jax_gate(x_shape, w_shape, want):
    n, h, w, c = x_shape
    kh, kw, i, o = w_shape
    assert jsupported(x_shape, w_shape) is want
    assert conv.supported((n, c, h, w), (o, i, kh, kw)) is want


FLAGSHIP = dict(cdim=3, zdim=128, channels=(64, 128, 256, 512), image_size=64)
FLAGSHIP_ROUTED = {"decoder.main.res_in_32.conv2", "decoder.main.res_in_64.conv1",
                   "decoder.main.res_in_64.conv2"}
# the same recipe at 48 px (48 // 2^4 = 3): res_in_48's two convs route at
# [2B, 64, 48, 48], the ragged entry points' shape; res_in_24 does not (24 is
# no multiple of 16)
FLAGSHIP_ROUTED_48 = {"decoder.main.res_in_48.conv1", "decoder.main.res_in_48.conv2"}


@pytest.mark.parametrize("arch", ["conv", "res"])
def test_flagship_routes_the_convs_the_jax_gate_accepts(arch, monkeypatch):
    """One batch-1 forward of the full-width flagship models with
    conv_impl 'pallas': exactly three decoder convs go to the kernels, and
    every PallasConv3x3 routes iff the JAX gate accepts its NHWC input; at
    48 px the two convs of res_in_48, by the same rule, on the ragged
    entry points."""
    for size, want in ((64, FLAGSHIP_ROUTED), (48, FLAGSHIP_ROUTED_48)):
        shapes = _routed_convs(arch, size, want, monkeypatch)
        bodies = {conv.kernel_body((2, c, h, w), torch.bfloat16)
                  for name, ((_, h, w, c), _) in shapes.items() if name in want}
        assert bodies == ({"wgmma"} if size == 64 else {"ragged"})


def _routed_convs(arch, size, want, monkeypatch):
    """The routed convs of a batch-1 forward at ``size`` are ``want``, and
    each PallasConv3x3 routes iff the JAX gate accepts it; returns every
    PallasConv3x3's (NHWC input, HWIO weight) shapes."""
    torch.manual_seed(0)
    kw = {**FLAGSHIP, "image_size": size}
    model = SoftIntroVAE(Encoder(arch=arch, conv_impl="pallas", **kw),
                         Decoder(arch=arch, conv_impl="pallas", **kw)).eval()
    current, routed, shapes = [], [], {}
    spy_target = blocks.conv3x3_pallas

    def spy(x, w):
        routed.append(current[-1])
        return spy_target(x, w)

    monkeypatch.setattr(blocks, "conv3x3_pallas", spy)
    for name, mod in model.named_modules():
        if isinstance(mod, PallasConv3x3):
            def pre(m, args, name=name):
                current.append(name)
                n, c, h, w = args[0].shape
                o, i, kh, kw = m.weight.shape
                shapes[name] = ((n, h, w, c), (kh, kw, i, o))
            mod.register_forward_pre_hook(pre)
    with torch.no_grad():
        mu, _ = model.encoder(torch.rand(1, 3, size, size))
        model.decoder(mu)
    assert set(routed) == want and len(routed) == len(want)
    assert len(shapes) == 18  # both 3x3 convs of the 9 blocks ran
    for name, (x_shape, w_shape) in shapes.items():
        assert jsupported(x_shape, w_shape) == (name in want), name
    monkeypatch.undo()
    return shapes


SMALL64 = dict(arch="conv", cdim=3, zdim=8, channels=(64,), image_size=32)


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts the calls of the two kernel entry points the autograd
    Function makes (on CPU they run the plain versions)."""
    calls = {"fwd": 0, "dw": 0}
    fwd, dw = conv_cuda.conv3x3_fwd, conv_cuda.conv3x3_dw

    def count_fwd(x, w, rot=False):
        calls["fwd"] += 1
        return fwd(x, w, rot)

    def count_dw(x, gy):
        calls["dw"] += 1
        return dw(x, gy)

    monkeypatch.setattr(conv_cuda, "conv3x3_fwd", count_fwd)
    monkeypatch.setattr(conv_cuda, "conv3x3_dw", count_dw)
    return calls


def _small_solver(name):
    torch.manual_seed(0)
    enc, dec = Encoder(conv_impl="pallas", **SMALL64), Decoder(conv_impl="pallas", **SMALL64)
    solver = make_solver(name, dataset=Synthetic(image_size=32, cdim=3, sizes=(2, 2, 4, 4)),
                         encoder=enc, decoder=dec, batch_size=4,
                         optimizer_e=make_optimizer("adam", 2e-4),
                         optimizer_d=make_optimizer("adam", 2e-4), tc_impl="pallas")
    batch = torch.from_numpy(solver.dataset.get_batch(np.arange(4)).transpose(0, 3, 1, 2).copy())
    return solver, batch


def test_intro_step_computes_no_weight_gradient_of_the_other_network(kernel_calls):
    """channels (64,), image 32: the encoder routes 2 convs (res_in_16), the
    decoder 4 (res_in_16, res_in_32). Paired step, derived per pass:
    a pass computes fwd for each routed conv, dx for each whose input
    depends on something being differentiated, dW only for the network
    its phase updates.
      phase E (decoder frozen): enc(x) 2 fwd + 2 dx + 2 dW; dec(prior, z)
        4 fwd + 4 dx; enc(rec, fake)' 2 + 2 + 2 dW; dec(z_rec, z_fake)
        4 + 4  ->  24 fwd-kernel calls, 4 dW
      phase D (encoder frozen): dec(prior, z') 4 + 4 + 4 dW; enc(rec,
        fake) 2 + 2; dec(z_rec, z_fake)' 4 + 4 + 4 dW  ->  20, 8
    """
    solver, batch = _small_solver("intro_tc")
    state = solver.init_state(0)
    at_opt_e = []
    state.opt_e.register_step_pre_hook(lambda *a: at_opt_e.append(dict(kernel_calls)))
    solver.train_step(state, batch)
    assert at_opt_e == [{"fwd": 24, "dw": 4}]
    assert kernel_calls == {"fwd": 44, "dw": 12}
    assert all(p.requires_grad for p in state.model.parameters())


def test_flagship_48px_step_kernel_calls(kernel_calls):
    """The flagship's widths (64-128-256-512, z 128) at 48 px, conv_impl
    'pallas', one paired intro_tc step at batch 2: the decoder routes
    res_in_48's two convs, the encoder none. Each phase makes 2 decoder
    calls, each call a forward and a dx per routed conv: 2 x 2 x 2 = 8
    fwd-kernel calls a phase; dW only in phase D (the decoder is frozen in
    phase E), once per routed conv and call: 4. On the card each fwd call
    is one conv3x3_fwd_ragged and one conv3x3_pack_w launch, each dW call
    one conv3x3_dw_ragged and one conv3x3_dw_reduce: 16, 16, 4 and 4 a step
    (chip_smoke.py phase 12 checks the launches against the same count)."""
    torch.manual_seed(0)
    kw = {**FLAGSHIP, "arch": "conv", "image_size": 48}
    enc, dec = Encoder(conv_impl="pallas", **kw), Decoder(conv_impl="pallas", **kw)
    solver = make_solver("intro_tc", dataset=Synthetic(image_size=48, cdim=3, sizes=(2, 2, 4, 4)),
                         encoder=enc, decoder=dec, batch_size=2,
                         optimizer_e=make_optimizer("adam", 2e-4),
                         optimizer_d=make_optimizer("adam", 2e-4), tc_impl="pallas")
    batch = torch.from_numpy(solver.dataset.get_batch(np.arange(2)).transpose(0, 3, 1, 2).copy())
    state = solver.init_state(0)
    at_opt_e = []
    state.opt_e.register_step_pre_hook(lambda *a: at_opt_e.append(dict(kernel_calls)))
    solver.train_step(state, batch)
    assert at_opt_e == [{"fwd": 8, "dw": 0}]
    assert kernel_calls == {"fwd": 16, "dw": 4}
    assert conv.kernel_body((4, 64, 48, 48), torch.bfloat16) == "ragged"


def test_vae_step_kernel_calls(kernel_calls):
    """One forward: enc(x) 2 fwd + 2 dx + 2 dW, dec(z) 4 + 4 + 4 dW."""
    solver, batch = _small_solver("vae")
    solver.train_step(solver.init_state(0), batch)
    assert kernel_calls == {"fwd": 12, "dw": 6}


def test_wrappers_take_the_plain_version_only_on_cpu():
    x = torch.randn(1, 64, 16, 8)
    w = torch.randn(64, 64, 3, 3)
    before = dict(conv_cuda.LAUNCHES)
    assert torch.equal(conv_cuda.conv3x3_fwd(x, w), conv.conv3x3_reference(x, w))
    assert torch.equal(conv_cuda.conv3x3_dw(x, x), conv.conv3x3_dw_reference(x, x))
    assert conv_cuda.LAUNCHES == before  # the plain version is not a launch
