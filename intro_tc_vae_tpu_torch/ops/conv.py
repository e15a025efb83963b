"""3x3 stride-1 'SAME' conv, 64 -> 64 channels: eligibility gate and plain versions.

Counterpart of the shape logic of ``intro_tc_vae_tpu/ops/conv_pallas.py``,
translated to the port's layouts (activations NCHW, weights OIHW):

* ``supported`` is the JAX predicate (conv_pallas.py:339) unchanged, so
  both packages route the same convs: a 3x3 kernel, Cin = Cout = 64, no
  bias (the caller's condition), H % 16 == 0, W even and >= 4,
  H * W <= 128^2.
* ``rot_t`` is ``_rot_t`` (conv_pallas.py:143): the weights of a stride-1
  conv's input-gradient pass, rot180 with input and output channels
  swapped.
* ``conv3x3_reference`` and its input and weight gradients are the plain
  PyTorch versions of the CUDA kernels (``ops/conv_cuda.py``). The kernel
  wrappers take them for CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CHANNELS = 64
WEIGHT_SHAPE = (CHANNELS, CHANNELS, 3, 3)


def _pick_tile(h: int) -> int:
    """The JAX kernel's row-strip height (conv_pallas.py:274); part of its
    gate, kept so that both packages accept the same shapes."""
    return h if h <= 64 else 64


def supported(x_shape, w_shape) -> bool:
    """Whether the conv kernels take this conv: x [N, 64, H, W], w
    [64, 64, 3, 3], H a multiple of 16 (and of the JAX strip height), W
    even and >= 4, H * W <= 128^2."""
    if tuple(w_shape) != WEIGHT_SHAPE:
        return False
    _, c, h, w = x_shape
    return (c == CHANNELS and h % 16 == 0 and h % _pick_tile(h) == 0
            and w % 2 == 0 and w >= 4 and h * w <= 128 * 128)


def rot_t(w: torch.Tensor) -> torch.Tensor:
    """OIHW weights of the input-gradient conv: dx = conv3x3(gy, rot_t(w))."""
    return w.transpose(0, 1).flip(2, 3)


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y = conv3x3(x, w), zero padding 1."""
    return F.conv2d(x, w, padding=1)


def conv3x3_dx_reference(gy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dL/dx of y = conv3x3(x, w) for the incoming gy."""
    return F.conv2d(gy, rot_t(w), padding=1)


def conv3x3_dw_reference(x: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """dL/dw [64, 64, 3, 3] of y = conv3x3(x, w) for the incoming gy, in
    x's dtype."""
    return torch.nn.grad.conv2d_weight(x, WEIGHT_SHAPE, gy, padding=1)
