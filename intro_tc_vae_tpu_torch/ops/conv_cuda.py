"""3x3 conv, 64 -> 64 channels: CUDA kernels, autograd, the two routings.

Counterpart of ``intro_tc_vae_tpu/ops/conv_pallas.py::conv3x3_pallas`` and
``conv3x3_hybrid``, NCHW activations and OIHW weights. Three kernels in
``csrc/conv_kernels.cu`` (design notes there):

* ``conv3x3_fwd``       replaces ``_fwd_kernel`` (conv_pallas.py:238): the
  forward, and the input gradient on ``rot_t(w)``, as ``_vjp_bwd`` does;
* ``conv3x3_dw``        replaces ``_dwp_kernel`` (conv_pallas.py:253):
  fp32 partial weight gradients over slices of the pixels;
* ``conv3x3_dw_reduce`` sums those partials in a fixed order.

``conv3x3_pallas(x, w)`` runs all three; ``conv3x3_hybrid(x, w)`` runs the
stock forward (cuDNN, as the JAX version runs XLA's conv) and the kernel
backward. Gradient casts follow the JAX VJP: gy is cast to x's dtype
(conv_pallas.py:368) and dW, accumulated in fp32, is rounded once to w's
dtype (:372), the compute dtype, before autograd casts it back to the
fp32 parameter. A gradient nobody asked for is not computed: autograd's
``needs_input_grad`` is fixed when the forward runs, so a caller that
wants no weight gradient runs the forward with the weight not requiring
grad (the intro step does this for the network a phase does not update).

The wrappers take the plain versions (``ops/conv.py``) only for tensors
on the CPU; for CUDA tensors they launch the kernels or raise.
``LAUNCHES`` counts kernel launches per kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from intro_tc_vae_tpu_torch.ops.conv import (
    CHANNELS,
    WEIGHT_SHAPE,
    conv3x3_dw_reference,
    conv3x3_reference,
    rot_t,
)
from intro_tc_vae_tpu_torch.ops.cuda_build import load_library

KERNELS = ("conv3x3_fwd", "conv3x3_dw", "conv3x3_dw_reduce")
LAUNCHES = dict.fromkeys(KERNELS, 0)
MAX_PARTS = 256          # fp32 partials of dW: 256 x 147 KB of scratch at most
TILE_H, TILE_W = 8, 32   # the kernels' output tile (csrc/conv_kernels.cu)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # x, w, y, N, H, W, dtype, device, stream
    "conv3x3_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, gy, part, N, H, W, n_parts, dtype, device, stream
    "conv3x3_dw": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # part, dw, n_parts, dtype, device, stream
    "conv3x3_dw_reduce": [_P, _P, _I, _I, _I, _P],
}


def reset_launch_counts() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("conv_kernels")
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, *args, device: torch.device) -> None:
    """Enqueue kernel `name` on the current stream; tensors are passed as
    their data pointers, then the device and the stream are appended."""
    fn = getattr(_library(), f"{name}_launch")
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
             device.index, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
    LAUNCHES[name] += 1


def _check(**tensors) -> torch.Tensor:
    """The kernels take contiguous CUDA tensors of one device and one dtype
    (float32 or bfloat16): activations [N, 64, H, W], weights [64, 64, 3, 3]."""
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != first.device:
            raise ValueError(f"{name} is on {t.device}; the kernels take CUDA tensors "
                             f"on one device")
        if t.dtype not in _DTYPE_CODE or t.dtype != first.dtype:
            raise TypeError(f"{name} is {t.dtype}; the kernels take float32 or "
                            f"bfloat16, one dtype for all operands")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous, got strides {t.stride()}")
        if name == "w":
            if tuple(t.shape) != WEIGHT_SHAPE:
                raise ValueError(f"w must be {WEIGHT_SHAPE}, got {tuple(t.shape)}")
        elif t.dim() != 4 or t.shape[1] != CHANNELS or t.numel() >= 2**31:
            raise ValueError(f"{name} must be [N, 64, H, W] with fewer than 2^31 "
                             f"elements, got {tuple(t.shape)}")
    return first


def conv3x3_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y = conv3x3(x, w) in x's dtype (fp32 accumulation): x [N, 64, H, W],
    w [64, 64, 3, 3]. Also the input gradient: conv3x3_fwd(gy, rot_t(w))."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return conv3x3_reference(x, w)
    _check(x=x, w=w)
    n, _, h, wd = x.shape
    y = torch.empty_like(x)
    launch("conv3x3_fwd", x, w, y, n, h, wd, _DTYPE_CODE[x.dtype], device=x.device)
    return y


def conv3x3_dw(x: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """dW [64, 64, 3, 3] of y = conv3x3(x, w) for the incoming gy, summed
    in fp32 and rounded once to x's dtype."""
    if x.device.type == "cpu" and gy.device.type == "cpu":
        return conv3x3_dw_reference(x, gy)
    _check(x=x, gy=gy)
    if gy.shape != x.shape:
        raise ValueError(f"gy {tuple(gy.shape)} must have x's shape {tuple(x.shape)}")
    n, _, h, wd = x.shape
    tiles = n * -(-h // TILE_H) * -(-wd // TILE_W)
    n_parts = min(tiles, MAX_PARTS)
    part = torch.empty((n_parts, 9 * CHANNELS, CHANNELS), device=x.device,
                       dtype=torch.float32)
    code = _DTYPE_CODE[x.dtype]
    launch("conv3x3_dw", x, gy, part, n, h, wd, n_parts, code, device=x.device)
    dw = torch.empty(WEIGHT_SHAPE, device=x.device, dtype=x.dtype)
    launch("conv3x3_dw_reduce", part, dw, n_parts, code, device=x.device)
    return dw


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, kernel_forward: bool):
        ctx.save_for_backward(x, w)
        if kernel_forward:
            return conv3x3_fwd(x, w)
        return F.conv2d(x, w, padding=1)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gy = gy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_fwd(gy, rot_t(w).contiguous())
        if ctx.needs_input_grad[1]:
            dw = conv3x3_dw(x, gy).to(w.dtype)
        return dx, dw, None


def conv3x3_pallas(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 'SAME' conv, kernels forward and backward (the JAX
    package's ``conv_impl: "pallas"``)."""
    return _Conv3x3.apply(x.contiguous(), w.contiguous(), True)


def conv3x3_hybrid(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 'SAME' conv, stock forward and kernel backward (the JAX
    package's ``conv_impl: "hybrid"``)."""
    return _Conv3x3.apply(x.contiguous(), w.contiguous(), False)
