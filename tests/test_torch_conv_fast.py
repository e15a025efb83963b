"""Host side of the bf16 conv kernels (csrc/conv_wgmma.cu), on the CPU.

The kernels themselves run only on the card (tests/test_torch_cuda.py);
what surrounds them is plain Python and PyTorch in ``ops/conv.py`` and is
held here:

* ``pack_weights(w, rot)``, the layout the forward kernel reads, against
  ``rot_t`` and against the JAX ``_rot_t`` (conv_pallas.py:143) through a
  conv: fp32, atol 1e-6.
* ``tile_schedule``: every pixel of [N, 64, H, W] lies in exactly one unit
  of exactly one persistent block, at the fast widths and at the widths
  the ragged entry points take (the last box of a row cut at W);
  ``launch_plan`` agrees with it.
* ``conv3x3_dw_partials_reference`` (per-block fp32 partials by that
  schedule, summed in block order) equals ``conv3x3_dw_reference`` (fp32,
  rtol 1e-5 with an atol of 1e-5 of the largest entry); the plain forward
  and that split dW equal the JAX Pallas kernel's in interpret mode (rtol
  1e-4 / atol 1e-4, as tests/test_torch_conv.py holds them).
* ``fast_path`` admits only shapes the wrappers accept, admits the
  flagship's routed shapes, and nothing in fp32 (whose bodies' host side
  is held in tests/test_torch_conv_fp32.py); ``kernel_body`` sends every
  other bf16 shape the gate admits to the ragged entry points.
* On the CPU the wrappers take the plain versions, whichever body the shape
  would run on the card, and count no launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from intro_tc_vae_tpu.ops.conv_pallas import _rot_t as j_rot_t
from intro_tc_vae_tpu.ops.conv_pallas import conv3x3_pallas as jconv3x3_pallas
from intro_tc_vae_tpu_torch.ops import conv, conv_cuda

SMS = 132  # persistent blocks on an H100


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("rot", [False, True], ids=["plain", "rot"])
def test_pack_weights_is_the_tap_major_layout(rot):
    """out[ky*3+kx, co, ci] = w'[co, ci, ky, kx], w' = rot_t(w) with rot;
    also by the index formula of the card's conv3x3_pack_w."""
    w = _oihw(_rand((3, 3, 64, 64), 0, 0.1))
    wp = conv.pack_weights(w, rot)
    assert wp.shape == (9, 64, 64) and wp.is_contiguous()
    ref = conv.rot_t(w) if rot else w
    assert torch.equal(conv.unpack_weights(wp), ref)
    for tap, co, ci in ((0, 0, 0), (5, 7, 11), (8, 63, 1), (2, 30, 62)):
        flat = w[ci, co].reshape(9)[8 - tap] if rot else w[co, ci].reshape(9)[tap]
        assert wp[tap, co, ci] == flat


def test_packed_rot_conv_matches_jax_rot_t():
    """conv(gy, unpack(pack_weights(w, rot=True))) against the JAX input
    gradient's weights, _rot_t(w) in HWIO: the weights equal, and through
    XLA's conv atol 1e-6 (outputs of order 0.1, fp32 sums of 576 terms)."""
    gy, w = _rand((2, 16, 8, 64), 1, 0.1), _rand((3, 3, 64, 64), 2, 0.03)
    unpacked = conv.unpack_weights(conv.pack_weights(_oihw(w), rot=True))
    np.testing.assert_array_equal(unpacked.numpy().transpose(2, 3, 1, 0),
                                  np.asarray(j_rot_t(jnp.asarray(w))))
    want = jax.lax.conv_general_dilated(
        jnp.asarray(gy), j_rot_t(jnp.asarray(w)), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), precision=jax.lax.Precision.HIGHEST)
    got = conv.conv3x3_reference(_nchw(gy), conv.unpack_weights(
        conv.pack_weights(_oihw(w), rot=True)))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want),
                               rtol=0, atol=1e-6)
    # and it is the port's own input gradient
    assert torch.equal(got, conv.conv3x3_dx_reference(_nchw(gy), _oihw(w)))


def test_conv3x3_fwd_rot_takes_the_plain_version_on_cpu():
    """conv3x3_fwd(x, w, rot=True) is the conv with rot_t(w), equal to the
    conv with the unpacked pack_weights(w, rot=True); no launch is counted.
    The wrapper packs fp32 weights as the fp32 forward reads them
    ([tap][ci][co])."""
    x, w = _nchw(_rand((1, 16, 32, 64), 3, 0.5)), _oihw(_rand((3, 3, 64, 64), 4, 0.1))
    before = dict(conv_cuda.LAUNCHES)
    for rot in (False, True):
        wp = conv_cuda.conv3x3_pack_w(w, rot)
        assert torch.equal(wp, conv.pack_weights(w, rot, co_inner=True))
        assert torch.equal(conv_cuda.conv3x3_pack_w(w.bfloat16(), rot),
                           conv.pack_weights(w.bfloat16(), rot))
        want = conv.conv3x3_reference(x, conv.rot_t(w) if rot else w)
        assert torch.equal(conv.conv3x3_reference(x, conv.unpack_weights(wp, co_inner=True)),
                           want)
        assert torch.equal(conv_cuda.conv3x3_fwd(x, w, rot=rot), want)
    assert conv_cuda.LAUNCHES == before


# the flagship's two routed shapes, intro_tc_128_dp8's, small and odd ones;
# then the ragged entry points' widths: the gate's narrow end (6), rows
# TMA cannot land (20, 36), one part-filled box (48: 48 px models), a full
# and a part-filled box (96), 16 boxes (1016), a free H (20)
SCHEDULE_CASES = [
    (128, 64, 64, SMS), (128, 32, 32, SMS), (16, 128, 128, SMS), (8, 128, 128, SMS),
    (1, 16, 32, SMS), (3, 24, 64, SMS), (2, 7, 128, SMS), (5, 48, 32, 4), (300, 16, 64, SMS),
    (1, 1, 64, SMS),
    (2, 16, 6, SMS), (3, 20, 36, SMS), (64, 64, 36, SMS), (128, 48, 48, SMS), (8, 64, 96, SMS),
    (1, 16, 1016, SMS), (4, 32, 20, 5), (2, 16, 4, SMS),
]


@pytest.mark.parametrize("n,h,w,blocks", SCHEDULE_CASES)
def test_tile_schedule_covers_every_pixel_once(n, h, w, blocks):
    sched = conv.tile_schedule(n, h, w, blocks)
    rc, p = conv.launch_plan(n, h, w, blocks)
    bw = conv.box_width(w)
    assert bw == (16 if w <= 16 else 32 if w <= 32 else 64)
    assert len(sched) == p <= blocks and all(sched)  # no block without a unit
    seen = np.zeros((n, h, w), dtype=np.int32)
    for units in sched:
        for i, h0, w0, rows, cols in units:
            # a box of bw columns, the last of a row cut at W
            assert rows == rc and w0 % bw == 0 and cols == min(bw, w - w0) > 0
            seen[i, h0:h0 + rows, w0:w0 + cols] += 1
    assert (seen == 1).all()
    # block b walks units b, b + P, ...: the kernels' loop
    flat = sorted((u for units in sched for u in units),
                  key=lambda u: (u[0], u[1], u[2]))
    for b, units in enumerate(sched):
        assert units == flat[b::p]
    # the busiest block's rows are within one unit of an even split
    most = max(len(units) for units in sched)
    assert most == -(-len(flat) // p)


@pytest.mark.parametrize("shape,blocks", [
    ((3, 64, 16, 32), 4), ((2, 64, 24, 64), SMS), ((1, 64, 16, 128), 3), ((5, 64, 8, 64), 2),
    ((2, 64, 16, 6), SMS), ((3, 64, 20, 36), 7), ((1, 64, 16, 20), 2), ((2, 64, 48, 48), SMS),
    ((1, 64, 16, 96), 5), ((1, 64, 16, 1016), SMS),
])
def test_dw_partials_reference_equals_dw_reference(shape, blocks):
    x, gy = torch.from_numpy(_rand(shape, 5, 0.5)), torch.from_numpy(_rand(shape, 6))
    dw, parts = conv.conv3x3_dw_partials_reference(x, gy, blocks)
    want = conv.conv3x3_dw_reference(x, gy)
    assert parts.shape == (conv.launch_plan(shape[0], *shape[2:], blocks)[1], 64, 64, 3, 3)
    assert parts.dtype == torch.float32 and dw.dtype == x.dtype
    np.testing.assert_allclose(dw.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    np.testing.assert_allclose(parts.sum(0).numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("shape,tile_h", [
    ((2, 32, 32, 64), None), ((1, 16, 8, 64), 16),
    # NHWC shapes of the ragged entry points: the narrow end, a row TMA
    # cannot land, one part-filled box, a full and a part-filled box
    ((2, 16, 6, 64), None), ((1, 16, 36, 64), None), ((1, 48, 48, 64), None),
    ((1, 64, 96, 64), None),
])
def test_dw_partials_reference_matches_jax_kernel(shape, tile_h):
    """The plain forward and the split dW sum against the JAX Pallas
    kernel's y and dW in interpret mode (NHWC / HWIO there)."""
    x, w, cot = _rand(shape, 7, 0.5), _rand((3, 3, 64, 64), 8, 0.1), _rand(shape, 9)
    with pltpu.force_tpu_interpret_mode():
        y_ref = jconv3x3_pallas(jnp.asarray(x), jnp.asarray(w), tile_h)
        dw_ref = jax.grad(lambda b: jnp.vdot(jconv3x3_pallas(jnp.asarray(x), b, tile_h),
                                             jnp.asarray(cot)))(jnp.asarray(w))
    y = conv.conv3x3_reference(_nchw(x), _oihw(w))
    np.testing.assert_allclose(y.numpy().transpose(0, 2, 3, 1), np.asarray(y_ref),
                               rtol=1e-4, atol=1e-4)
    dw, _ = conv.conv3x3_dw_partials_reference(_nchw(x), _nchw(cot), SMS)
    np.testing.assert_allclose(dw.numpy().transpose(2, 3, 1, 0), np.asarray(dw_ref),
                               rtol=1e-4, atol=1e-4)


def test_dw_partials_reference_rounds_once_in_bf16():
    shape = (2, 64, 16, 32)
    x = torch.from_numpy(_rand(shape, 10, 0.5)).bfloat16()
    gy = torch.from_numpy(_rand(shape, 11)).bfloat16()
    dw, parts = conv.conv3x3_dw_partials_reference(x, gy, 3)
    assert dw.dtype == torch.bfloat16 and parts.dtype == torch.float32
    assert torch.equal(dw, parts.sum(0).bfloat16())
    want = conv.conv3x3_dw_reference(x.double(), gy.double())
    s = conv.conv3x3_dw_reference(x.double().abs(), gy.double().abs())
    assert bool(((dw.double() - want).abs() <= 2.0 ** -8 * want.abs() + 1e-5 * s).all())


@pytest.mark.parametrize("shape,dtype,want", [
    ((128, 64, 64, 64), torch.bfloat16, True),    # the flagship's res_in_64
    ((128, 64, 32, 32), torch.bfloat16, True),    # the flagship's res_in_32
    ((16, 64, 128, 128), torch.bfloat16, True),   # intro_tc_128_dp8's res_in_128
    ((1, 64, 7, 64), torch.bfloat16, True),       # any H
    ((128, 64, 64, 64), torch.float32, False),    # fp32 has bodies of its own
    ((3, 64, 20, 36), torch.bfloat16, False),     # W not 32, 64 or 128
    ((2, 64, 16, 8), torch.bfloat16, False),
    ((2, 64, 16, 256), torch.bfloat16, False),
    ((2, 32, 16, 64), torch.bfloat16, False),     # not 64 channels
    ((64, 16, 64), torch.bfloat16, False),
    ((2048, 64, 128, 128), torch.bfloat16, False),  # 2^31 elements
])
def test_fast_path_shape_rule(shape, dtype, want):
    assert conv.fast_path(shape, dtype) is want


def test_fast_path_is_inside_what_the_gate_and_the_wrappers_accept():
    """Every gate-accepted shape (the JAX predicate) runs one entry point
    or the other, by the shape rule alone; the fast path needs no more of a
    shape than the wrappers' own checks ([N, 64, H, W], fewer than 2^31
    elements)."""
    taken = {True: 0, False: 0}
    for h in (16, 32, 48, 64, 128):
        for w in (4, 6, 8, 20, 32, 36, 64, 128, 256):
            shape = (2, 64, h, w)
            if not conv.supported(shape, conv.WEIGHT_SHAPE):
                continue
            fast = conv.fast_path(shape, torch.bfloat16)
            assert fast == (w in (32, 64, 128))
            assert not conv.fast_path(shape, torch.float32)
            taken[fast] += 1
    assert taken[True] and taken[False]
    for shape in ((2, 64, 16, 64), (1, 64, 1, 32)):
        assert conv.fast_path(shape, torch.bfloat16)
        n, c, h, w = shape
        assert c == conv.CHANNELS and n * c * h * w < 2**31


@pytest.mark.parametrize("shape", [(1, 64, 16, 32), (2, 64, 16, 20)],
                         ids=["fast-path shape", "ragged shape"])
def test_bf16_autograd_is_the_same_on_cpu_whichever_body_the_card_would_run(shape):
    x = torch.from_numpy(_rand(shape, 12, 0.5)).bfloat16().requires_grad_(True)
    w = _oihw(_rand((3, 3, 64, 64), 13, 0.1)).bfloat16().requires_grad_(True)
    gy = torch.from_numpy(_rand(shape, 14)).bfloat16()
    for fn in (conv_cuda.conv3x3_pallas, conv_cuda.conv3x3_hybrid):
        x.grad = w.grad = None
        y = fn(x, w)
        y.backward(gy)
        assert torch.equal(y, conv.conv3x3_reference(x, w))
        assert torch.equal(x.grad, conv.conv3x3_dx_reference(gy, w.detach()))
        assert torch.equal(w.grad, conv.conv3x3_dw_reference(x.detach(), gy))


# every width the gate admits at some H, and H that only phase 3's ragged
# shape has (20: the gate wants a multiple of 16)
GATE_WIDTHS = tuple(range(4, 1025, 2))


@pytest.mark.parametrize("h", [16, 32, 48, 64, 128, 20])
def test_kernel_body_sends_every_admitted_bf16_shape_to_a_hopper_body(h):
    """bf16: the wgmma entry points at W in {32, 64, 128}, the ragged ones
    at every other width the gate admits (and at H = 20, which the
    wrappers take though the gate does not); never a third body. Each
    such shape has a schedule with at least one unit a block."""
    seen = 0
    for w in GATE_WIDTHS:
        shape = (2, 64, h, w)
        if h % 16 == 0 and not conv.supported(shape, conv.WEIGHT_SHAPE):
            continue
        if h * w > 128 * 128:
            continue
        seen += 1
        body = conv.kernel_body(shape, torch.bfloat16)
        assert body == ("wgmma" if w in conv.FAST_WIDTHS else "ragged"), (shape, body)
        assert conv.kernel_body(shape, torch.float32) == "fp32"
        if w % 64 == 2 or w <= 48 or w in conv.FAST_WIDTHS:  # a sample of the schedules
            assert all(conv.tile_schedule(2, h, w, SMS))
    assert seen >= 60


def test_bf16_wrappers_take_no_odd_width_on_the_card():
    """An odd bf16 W (never routed: the gate wants W even) raises in the
    wrappers before any launch; on the CPU the plain version takes it."""
    with pytest.raises(ValueError, match="even W"):
        conv_cuda.dw_parts((1, 64, 16, 7), torch.bfloat16, torch.device("cpu"))
    x = torch.from_numpy(_rand((1, 64, 16, 7), 15)).bfloat16()
    w = _oihw(_rand((3, 3, 64, 64), 16, 0.1)).bfloat16()
    assert torch.equal(conv_cuda.conv3x3_fwd(x, w), conv.conv3x3_reference(x, w))
