"""Conv building blocks, NCHW: the 'conv' arch of the JAX package.

Counterpart of ``intro_tc_vae_tpu/models/blocks.py``. Parameters stay
float32; ``Conv2d`` and ``Linear`` cast their input and parameters to the
module's ``compute_dtype`` (bf16 under ``precision: "bf16"``), as flax's
``promote_dtype`` does. ``GroupedBatchNorm`` computes its statistics in
float32 and returns ``compute_dtype``.

Init: PyTorch's default ``Conv2d``/``Linear`` init (kaiming-uniform with
a=sqrt(5) for weights, fan-in uniform for biases) is U(±1/sqrt(fan_in)),
the same distribution the JAX package draws (models/init.py), so no
custom initializer is needed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from intro_tc_vae_tpu_torch import not_ported

LEAKY_SLOPE = 0.2


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LEAKY_SLOPE)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(2): window 2, stride 2."""
    return F.avg_pool2d(x, 2)


def upsample_nearest2(x: torch.Tensor) -> torch.Tensor:
    """nn.Upsample(scale_factor=2, mode='nearest')."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Conv2d(nn.Conv2d):
    """Stride-1 'SAME' conv computed in ``compute_dtype``."""

    def __init__(self, inc: int, outc: int, kernel: int, bias: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(inc, outc, kernel, padding=kernel // 2, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, padding=self.padding)


class Linear(nn.Linear):
    """Dense layer computed in ``compute_dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class GroupedBatchNorm(nn.Module):
    """BatchNorm with the JAX package's numerics and *grouped* statistics.

    Differs from ``nn.BatchNorm2d`` on purpose: the running variance is
    updated with the biased batch variance max(0, E[x²] - E[x]²) (flax's
    convention, where torch uses the unbiased one). With ``groups=G`` the
    batch is a concatenation of G equal sub-batches: statistics are
    computed and applied per group, and the running averages receive the
    G EMA updates composed in group order — so one batch-G*B pass equals G
    sequential batch-B passes (JAX ``GroupedBatchNorm``, blocks.py:188).
    ``momentum`` is torch's convention (0.1 here == flax 0.9). The running
    buffers are updated in place on every train-mode forward.
    """

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, groups: int = 1) -> torch.Tensor:
        c = x.shape[1]
        bshape = (c,) + (1,) * (x.dim() - 2)  # broadcast over [C, H, W]
        if not self.training:
            scale = torch.rsqrt(self.running_var + self.eps) * self.weight
            y = (x - self.running_mean.reshape(bshape)) * scale.reshape(bshape) \
                + self.bias.reshape(bshape)
            return y.to(self.compute_dtype)

        b = x.shape[0]
        if b % groups:
            raise ValueError(f"batch {b} not divisible by groups {groups}")
        xg = x.reshape(groups, b // groups, *x.shape[1:])
        xf = xg.to(torch.promote_types(xg.dtype, torch.float32))  # stats in >= fp32
        axes = (1,) + tuple(range(3, xg.dim()))
        mean = xf.mean(axes)                                  # [G, C]
        var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
        with torch.no_grad():
            keep = 1.0 - self.momentum
            rm, rv = self.running_mean, self.running_var
            for g in range(groups):  # sequential per-pass EMA composition
                rm = keep * rm + (1.0 - keep) * mean[g]
                rv = keep * rv + (1.0 - keep) * var[g]
            self.running_mean.copy_(rm)
            self.running_var.copy_(rv)
        gshape = (groups, 1) + bshape
        y = (xg - mean.reshape(gshape)) * (
            torch.rsqrt(var.reshape(gshape) + self.eps) * self.weight.reshape(bshape)
        ) + self.bias.reshape(bshape)
        return y.reshape(x.shape).to(self.compute_dtype)


class ConvolutionalBlock(nn.Module):
    """Plain double-conv block (reference models.py:8-54): no skip path.

    conv3x3 -> BN(1e-4) -> LReLU -> conv3x3 -> BN(1e-4) -> LReLU.
    """

    def __init__(self, inc: int, outc: int,
                 compute_dtype: torch.dtype = torch.float32,
                 conv_impl: str = "xla", tile_rows: int = 0):
        super().__init__()
        if conv_impl in ("pallas", "hybrid"):
            raise not_ported(f"conv_impl='{conv_impl}' (the 3x3 conv kernels)",
                             "Queue 2 items 5-7")
        if tile_rows > 0:
            raise not_ported("tile_rows > 0", "Queue 1 item 10")
        dt = compute_dtype
        self.conv1 = Conv2d(inc, outc, 3, compute_dtype=dt)
        self.bn1 = GroupedBatchNorm(outc, eps=1e-4, compute_dtype=dt)
        self.conv2 = Conv2d(outc, outc, 3, compute_dtype=dt)
        self.bn2 = GroupedBatchNorm(outc, eps=1e-4, compute_dtype=dt)

    def forward(self, x: torch.Tensor, groups: int = 1) -> torch.Tensor:
        y = leaky_relu(self.bn1(self.conv1(x), groups))
        return leaky_relu(self.bn2(self.conv2(y), groups))


def get_conv_class(arch: str):
    """Block class for an architecture string (reference models.py:185-193)."""
    if arch == "conv":
        return ConvolutionalBlock
    if arch in ("res", "inception"):
        raise not_ported(f"arch='{arch}'", "Queue 1 item 6")
    raise ValueError(f"unknown arch '{arch}' (expected one of ['conv', 'res', 'inception'])")
