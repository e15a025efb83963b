"""A tensor moved between NCHW and channels-last: the layout transposes of
``models/blocks.py::as_layout``, on the card.

PyTorch's own copy into the other layout (``x.contiguous(memory_format=
...)``) reads one side element by element; the kernel ``relayout``
(``csrc/bn_kernels.cu``, so that it costs no nvcc run of its own) moves
32 x 32 tiles through shared memory instead, whole runs of 32 elements on
both sides, as cuDNN's ``nchwToNhwc`` / ``nhwcToNchw`` do. ``relayout(x,
fmt)`` is differentiable: the backward moves the gradient back to x's
layout the same way. The kernel takes CUDA tensors [N, C, H, W] of 2- or
4-byte elements lying contiguous in the other layout; everything else,
and the CPU, takes PyTorch's copy. ``LAUNCHES`` counts the launches,
``relayout`` the forward's and ``relayout_grad`` the backward's,
registered with ``launch_counts`` (kept under graph replay).

``channels_last`` is the port's one test of which layout a tensor lies
in: the conv layout rule's copies (``models/blocks.py``), the BatchNorm
kernels' bodies (``ops/batchnorm_cuda.py::nhwc``) and the residual sum
read it.
"""

from __future__ import annotations

import ctypes

import torch

from intro_tc_vae_tpu_torch.ops import cuda_build, launch_counts

_P, _I = ctypes.c_void_p, ctypes.c_int
# in, out, n, rows, cols, elem_bytes
LIBRARY = cuda_build.Library("bn_kernels", {"relayout": [_P, _P] + [_I] * 4})
LAUNCHES = launch_counts.register({"relayout": 0, "relayout_grad": 0})

_OTHER = {torch.channels_last: torch.contiguous_format,
          torch.contiguous_format: torch.channels_last}


def channels_last(x: torch.Tensor) -> bool:
    """Whether x [N, C, H, W] lies channels-last and not also contiguous
    (as one of C and H W of 1 would make it)."""
    return (x.dim() == 4 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last))


def takes(x: torch.Tensor, fmt: torch.memory_format) -> bool:
    """Whether the kernel moves x [N, C, H, W] to ``fmt``: a CUDA tensor of
    2- or 4-byte elements lying contiguous in the other layout."""
    return (x.device.type == "cuda" and x.dim() == 4 and x.element_size() in (2, 4)
            and 0 < x.numel() < 2**31 and x.shape[0] <= 65535
            and (x.is_contiguous() if fmt == torch.channels_last else channels_last(x)))


def _move(x: torch.Tensor, fmt: torch.memory_format, counted: str) -> torch.Tensor:
    n, c, h, w = x.shape
    out = torch.empty_like(x, memory_format=fmt)
    rows, cols = (c, h * w) if fmt == torch.channels_last else (h * w, c)
    cuda_build.launch(LIBRARY, "relayout", x, out, n, rows, cols, x.element_size(),
                      device=x.device, counts=LAUNCHES, counted=counted)
    return out


class _Relayout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fmt):
        ctx.fmt = fmt
        return _move(x, fmt, "relayout")

    @staticmethod
    def backward(ctx, g):
        back = _OTHER[ctx.fmt]
        g = g.contiguous(memory_format=ctx.fmt)
        if takes(g, back):
            return _move(g, back, "relayout_grad"), None
        return g.contiguous(memory_format=back), None


def relayout(x: torch.Tensor, fmt: torch.memory_format) -> torch.Tensor:
    """x (the same values) lying contiguous in ``fmt``: the kernel where it
    takes x (``takes``), else PyTorch's copy."""
    if takes(x, fmt):
        return _Relayout.apply(x, fmt)
    return x.contiguous(memory_format=fmt)
