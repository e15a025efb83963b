"""3x3 conv, 64 -> 64 channels: CUDA kernels, autograd, the two routings.

Counterpart of ``intro_tc_vae_tpu/ops/conv_pallas.py::conv3x3_pallas`` and
``conv3x3_hybrid``, NCHW activations and OIHW weights. The kernels
(design notes in the sources):

* ``conv3x3_fwd``       replaces ``_fwd_kernel`` (conv_pallas.py:238): the
  forward, and the input gradient on ``rot_t(w)``, as ``_vjp_bwd`` does;
* ``conv3x3_dw``        replaces ``_dwp_kernel`` (conv_pallas.py:253):
  fp32 partial weight gradients over slices of the pixels;
* ``conv3x3_dw_reduce`` sums those partials in a fixed order;
* ``conv3x3_pack_w``    packs the weights for the wgmma and the fp32 forward.

``conv3x3_fwd`` and ``conv3x3_dw`` each have three bodies, chosen by the
rule ``ops/conv.py::kernel_body`` and by nothing else: all of fp32 runs
the FFMA kernels of ``csrc/conv_fp32.cu`` (rows kept as they lie, cp.async
rings, persistent blocks, any shape); bf16 runs the wgmma kernels of
``csrc/conv_wgmma.cu`` (rings of row slabs, persistent blocks): W in
{32, 64, 128} through the ``_wgmma`` entry points, every other even W
through the ``_ragged`` ones (the last box of a row cut at W; TMA where
the row stride is a multiple of 16 bytes, cp.async elsewhere); an odd bf16
W raises. ``LAUNCHES`` counts ``conv3x3_fwd_wgmma``, ``conv3x3_dw_wgmma``,
``conv3x3_fwd_ragged`` and ``conv3x3_dw_ragged`` under their own names and
the fp32 bodies as ``conv3x3_fwd`` and ``conv3x3_dw``; a wrapper's calls
are the sum of its three counts.

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
    fp32_launch_plan,
    kernel_body,
    launch_plan,
    pack_weights,
    rot_t,
)
from intro_tc_vae_tpu_torch.ops.cuda_build import load_library

KERNELS = ("conv3x3_fwd", "conv3x3_dw", "conv3x3_dw_reduce", "conv3x3_pack_w",
           "conv3x3_fwd_wgmma", "conv3x3_dw_wgmma", "conv3x3_fwd_ragged", "conv3x3_dw_ragged")
LAUNCHES = dict.fromkeys(KERNELS, 0)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
# library -> entry point -> argument types (device and stream last)
_ARGTYPES = {
    "conv_kernels": {
        # part, dw, n_parts, dtype, device, stream
        "conv3x3_dw_reduce": [_P, _P, _I, _I, _I, _P],
    },
    "conv_wgmma": {
        # x, wp, y, N, H, W, rc, n_blocks, device, stream
        "conv3x3_fwd_wgmma": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        # x, gy, part, N, H, W, rc, n_blocks, device, stream
        "conv3x3_dw_wgmma": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        # the same two for every other even W
        "conv3x3_fwd_ragged": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        "conv3x3_dw_ragged": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        # w, out, rot, dtype, device, stream
        "conv3x3_pack_w": [_P, _P, _I, _I, _I, _P],
    },
    "conv_fp32": {
        # x, wp, y, N, H, W, n_blocks, device, stream
        "conv3x3_fwd_fp32": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
        # x, gy, part, N, H, W, n_blocks, device, stream
        "conv3x3_dw_fp32": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
}
LIBRARIES = tuple(_ARGTYPES)
_LIBRARY_OF = {entry: lib for lib, entries in _ARGTYPES.items() for entry in entries}
# the fp32 bodies count under the wrappers' own names
_COUNTED_AS = {"conv3x3_fwd_fp32": "conv3x3_fwd", "conv3x3_dw_fp32": "conv3x3_dw"}


def reset_launch_counts() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _library(name: str = "conv_kernels") -> ctypes.CDLL:
    lib = load_library(name)
    for entry, argtypes in _ARGTYPES[name].items():
        fn = getattr(lib, f"{entry}_launch")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(entry: str, *args, device: torch.device) -> None:
    """Enqueue entry point `entry` on the current stream; tensors are passed
    as their data pointers, then the device and the stream are appended."""
    fn = getattr(_library(_LIBRARY_OF[entry]), f"{entry}_launch")
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
             device.index, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {entry} failed to launch: cudaError {err}")
    LAUNCHES[_COUNTED_AS.get(entry, entry)] += 1


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Persistent blocks of the wgmma and fp32 kernels: one per multiprocessor."""
    return torch.cuda.get_device_properties(device).multi_processor_count


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


def conv3x3_pack_w(w: torch.Tensor, rot: bool = False) -> torch.Tensor:
    """OIHW weights as the [9, 64, 64] the forward body of w's dtype reads
    (``ops/conv.py::pack_weights``): [tap][co][ci] in bf16 (wgmma),
    [tap][ci][co] in fp32; ``rot``: those of the input gradient."""
    if w.device.type == "cpu":
        return pack_weights(w, rot, co_inner=w.dtype == torch.float32)
    _check(w=w)
    return _pack_w(w, rot)


def _pack_w(w: torch.Tensor, rot: bool) -> torch.Tensor:
    out = torch.empty((9, CHANNELS, CHANNELS), device=w.device, dtype=w.dtype)
    launch("conv3x3_pack_w", w, out, int(rot), _DTYPE_CODE[w.dtype], device=w.device)
    return out


def conv3x3_fwd(x: torch.Tensor, w: torch.Tensor, rot: bool = False) -> torch.Tensor:
    """y = conv3x3(x, w) in x's dtype (fp32 accumulation): x [N, 64, H, W],
    w [64, 64, 3, 3]. ``rot``: the conv with rot_t(w) instead, which is the
    input gradient, conv3x3_fwd(gy, w, rot=True); every body packs those
    weights straight from w."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return conv3x3_reference(x, rot_t(w) if rot else w)
    _check(x=x, w=w)
    n, _, h, wd = x.shape
    y = torch.empty_like(x)
    body = _body(x.shape, x.dtype)
    if body == "fp32":
        blocks = fp32_launch_plan(n, h, wd, sm_count(x.device))
        launch("conv3x3_fwd_fp32", x, _pack_w(w, rot), y, n, h, wd, blocks, device=x.device)
    else:
        rc, blocks = launch_plan(n, h, wd, sm_count(x.device))
        launch(f"conv3x3_fwd_{body}", x, _pack_w(w, rot), y, n, h, wd, rc, blocks,
               device=x.device)
    return y


def _body(shape, dtype) -> str:
    body = kernel_body(shape, dtype)
    if body == "ragged" and shape[3] % 2:
        raise ValueError(f"bf16 activations {tuple(shape)}: the bf16 kernels take an even W "
                         f"(rows of 4-byte pixel pairs)")
    return body


def dw_parts(shape, dtype, device) -> tuple:
    """(body, n_parts, rows per unit) of conv3x3_dw on this shape: one
    partial per persistent block; rows per unit is the bf16 launchers'
    argument, 0 for fp32."""
    n, _, h, wd = shape
    body = _body(shape, dtype)
    if body == "fp32":
        return body, fp32_launch_plan(n, h, wd, sm_count(device)), 0
    rc, blocks = launch_plan(n, h, wd, sm_count(device))
    return body, blocks, rc


def conv3x3_dw(x: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """dW [64, 64, 3, 3] of y = conv3x3(x, w) for the incoming gy, summed
    in fp32 and rounded once to x's dtype."""
    if x.device.type == "cpu" and gy.device.type == "cpu":
        return conv3x3_dw_reference(x, gy)
    _check(x=x, gy=gy)
    if gy.shape != x.shape:
        raise ValueError(f"gy {tuple(gy.shape)} must have x's shape {tuple(x.shape)}")
    n, _, h, wd = x.shape
    body, n_parts, rc = dw_parts(x.shape, x.dtype, x.device)
    part = torch.empty((n_parts, 9 * CHANNELS, CHANNELS), device=x.device,
                       dtype=torch.float32)
    if body == "fp32":
        launch("conv3x3_dw_fp32", x, gy, part, n, h, wd, n_parts, device=x.device)
    else:
        launch(f"conv3x3_dw_{body}", x, gy, part, n, h, wd, rc, n_parts, device=x.device)
    dw = torch.empty(WEIGHT_SHAPE, device=x.device, dtype=x.dtype)
    launch("conv3x3_dw_reduce", part, dw, n_parts, _DTYPE_CODE[x.dtype], device=x.device)
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
            dx = conv3x3_fwd(gy, w, rot=True)
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
