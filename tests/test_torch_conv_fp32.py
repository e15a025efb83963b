"""Host side of the fp32 conv kernels (csrc/conv_fp32.cu), on the CPU.

The kernels run only on the card (tests/test_torch_cuda.py); what
surrounds them is plain Python and PyTorch in ``ops/conv.py``:

* ``fp32_tile_schedule``: every pixel of [N, 64, H, W], ragged or not,
  lies in exactly one unit of exactly one persistent block, by the walk the
  kernels' ``unit_of`` takes; ``fp32_launch_plan`` agrees with it.
* ``conv3x3_dw_partials_reference(..., schedule=fp32_tile_schedule)``
  (per-block fp32 partials by that schedule, summed in block order, the
  order ``conv3x3_dw_reduce`` takes) equals ``conv3x3_dw_reference`` (fp32,
  rtol 1e-5 with an atol of 1e-5 of the largest entry) and the JAX Pallas
  kernel's dW in interpret mode (rtol 1e-4 / atol 1e-4, as
  tests/test_torch_conv.py holds the dW).
* ``pack_weights(w, rot, co_inner=True)``, the [tap][ci][co] layout the
  fp32 forward reads, stands for ``w`` and ``rot_t(w)`` exactly, also by
  the index formula of the card's ``conv3x3_pack_w``.
* ``kernel_body`` sends fp32 to the fp32 bodies for every shape the gate
  accepts (and any other the wrappers take), bf16 to the wgmma or the
  ragged entry points by ``fast_path``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from intro_tc_vae_tpu.ops.conv_pallas import conv3x3_pallas as jconv3x3_pallas
from intro_tc_vae_tpu_torch.ops import conv

SMS = 132  # persistent blocks on an H100


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("w,want", [(4, (16, 32)), (6, (16, 32)), (32, (16, 32)),
                                    (36, (8, 64)), (64, (8, 64)), (128, (8, 64))])
def test_fp32_tile_is_512_pixels(w, want):
    assert conv.fp32_tile(w) == want
    assert want[0] * want[1] == conv.FP32_TILE_PIXELS


# the routed shapes of vae_synthetic / tc_dsprites and the flagship, W = 128,
# ragged and narrow ones, fewer units than blocks, few blocks
FP32_SCHEDULE_CASES = [
    (64, 64, 64, SMS), (128, 64, 64, SMS), (128, 32, 32, SMS), (8, 128, 128, SMS),
    (3, 20, 36, SMS), (2, 16, 6, SMS), (1, 16, 4, SMS), (5, 7, 70, SMS), (1, 1, 1, SMS),
    (5, 48, 32, 4), (300, 16, 64, SMS), (2, 33, 129, 7),
]


@pytest.mark.parametrize("n,h,w,blocks", FP32_SCHEDULE_CASES)
def test_fp32_tile_schedule_covers_every_pixel_once(n, h, w, blocks):
    sched = conv.fp32_tile_schedule(n, h, w, blocks)
    rows, cols = conv.fp32_tile(w)
    p = conv.fp32_launch_plan(n, h, w, blocks)
    assert len(sched) == p <= blocks and all(sched)  # no block without a unit
    seen = np.zeros((n, h, w), dtype=np.int32)
    for units in sched:
        for i, h0, w0, r, c in units:
            assert h0 % rows == 0 and w0 % cols == 0
            assert r == min(rows, h - h0) >= 1 and c == min(cols, w - w0) >= 1
            seen[i, h0:h0 + r, w0:w0 + c] += 1
    assert (seen == 1).all()
    # block b walks units b, b + P, ..., numbered columns fastest, then row
    # chunks, then images: the kernels' loop and unit_of
    flat = sorted((u for units in sched for u in units), key=lambda u: (u[0], u[1], u[2]))
    for b, units in enumerate(sched):
        assert units == flat[b::p]
    assert max(len(units) for units in sched) == -(-len(flat) // p)


@pytest.mark.parametrize("shape,blocks", [
    ((3, 64, 16, 32), 4), ((2, 64, 24, 64), SMS), ((1, 64, 16, 128), 3), ((3, 64, 20, 36), 5),
    ((2, 64, 16, 6), SMS),
])
def test_fp32_dw_partials_reference_equals_dw_reference(shape, blocks):
    x, gy = torch.from_numpy(_rand(shape, 5, 0.5)), torch.from_numpy(_rand(shape, 6))
    dw, parts = conv.conv3x3_dw_partials_reference(x, gy, blocks, conv.fp32_tile_schedule)
    want = conv.conv3x3_dw_reference(x, gy)
    assert parts.shape == (conv.fp32_launch_plan(shape[0], *shape[2:], blocks), 64, 64, 3, 3)
    assert parts.dtype == torch.float32 and dw.dtype == torch.float32
    tol = dict(rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    np.testing.assert_allclose(dw.numpy(), want.numpy(), **tol)
    np.testing.assert_allclose(parts.sum(0).numpy(), want.numpy(), **tol)
    # the partials summed one after the other, in block order: the reduce's sum
    total = torch.zeros_like(parts[0])
    for part in parts:
        total += part
    assert torch.equal(total, dw)


@pytest.mark.parametrize("shape,tile_h,blocks", [((2, 32, 32, 64), None, SMS),
                                                 ((1, 16, 8, 64), 16, 2)])
def test_fp32_dw_partials_reference_matches_jax_kernel(shape, tile_h, blocks):
    """The split sum in the fp32 kernel's partial order against the JAX
    Pallas kernel's dW in interpret mode (NHWC / HWIO there)."""
    x, w, cot = _rand(shape, 7, 0.5), _rand((3, 3, 64, 64), 8, 0.1), _rand(shape, 9)
    with pltpu.force_tpu_interpret_mode():
        dw_ref = jax.grad(lambda b: jnp.vdot(jconv3x3_pallas(jnp.asarray(x), b, tile_h),
                                             jnp.asarray(cot)))(jnp.asarray(w))
    dw, _ = conv.conv3x3_dw_partials_reference(_nchw(x), _nchw(cot), blocks,
                                               conv.fp32_tile_schedule)
    np.testing.assert_allclose(dw.numpy().transpose(2, 3, 1, 0), np.asarray(dw_ref),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("rot", [False, True], ids=["plain", "rot"])
def test_fp32_pack_weights_is_tap_ci_co(rot):
    """out[ky*3+kx, ci, co] = w'[co, ci, ky, kx], w' = rot_t(w) with rot;
    also by the index formula of the card's conv3x3_pack_w."""
    w = _oihw(_rand((3, 3, 64, 64), 0, 0.1))
    wp = conv.pack_weights(w, rot, co_inner=True)
    assert wp.shape == (9, 64, 64) and wp.is_contiguous() and wp.dtype == torch.float32
    ref = conv.rot_t(w) if rot else w
    assert torch.equal(conv.unpack_weights(wp, co_inner=True), ref)
    assert torch.equal(wp, conv.pack_weights(w, rot).transpose(1, 2))
    for tap, ci, co in ((0, 0, 0), (5, 7, 11), (8, 63, 1), (2, 30, 62)):
        flat = w[ci, co].reshape(9)[8 - tap] if rot else w[co, ci].reshape(9)[tap]
        assert wp[tap, ci, co] == flat


@pytest.mark.parametrize("shape,dtype,want", [
    ((64, 64, 64, 64), torch.float32, "fp32"),      # vae_synthetic's res_in_64
    ((64, 64, 32, 32), torch.float32, "fp32"),
    ((3, 64, 20, 36), torch.float32, "fp32"),       # ragged
    ((2, 64, 16, 6), torch.float32, "fp32"),        # rows of 24 bytes
    ((128, 64, 64, 64), torch.bfloat16, "wgmma"),
    ((3, 64, 20, 36), torch.bfloat16, "ragged"),
])
def test_kernel_body_rule(shape, dtype, want):
    assert conv.kernel_body(shape, dtype) == want


def test_kernel_body_sends_all_of_fp32_to_the_fp32_bodies():
    """Every shape the gate accepts (the JAX predicate) runs the fp32
    bodies in fp32, and in bf16 the body ``fast_path`` names."""
    seen = 0
    for h in (16, 32, 48, 64, 128):
        for w in (4, 6, 8, 20, 32, 36, 64, 128, 256):
            shape = (2, 64, h, w)
            if not conv.supported(shape, conv.WEIGHT_SHAPE):
                continue
            seen += 1
            assert conv.kernel_body(shape, torch.float32) == "fp32"
            assert conv.kernel_body(shape, torch.bfloat16) == \
                ("wgmma" if conv.fast_path(shape, torch.bfloat16) else "ragged")
            # and the schedule takes it: at least one unit, no empty block
            assert all(conv.fp32_tile_schedule(2, h, w, SMS))
    assert seen > 20
