"""Conv building blocks, NCHW: the 'conv', 'res' and 'inception' archs of
the JAX package.

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

import contextlib

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from intro_tc_vae_tpu_torch import not_ported
from intro_tc_vae_tpu_torch.ops.conv import supported
from intro_tc_vae_tpu_torch.ops.conv_cuda import conv3x3_hybrid, conv3x3_pallas
from intro_tc_vae_tpu_torch.parallel.collectives import all_reduce_sum

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


class PallasConv3x3(Conv2d):
    """3x3 stride-1 'SAME' conv without bias, routed through the conv
    kernels (ops/conv_cuda.py) when the shape is eligible (ops/conv.py
    ``supported``), decided per call from the NCHW input as the JAX
    ``PallasConv3x3`` (models/blocks.py:145) decides from NHWC. Other
    shapes run the stock conv, which computes the same function. It keeps
    ``Conv2d``'s ``weight`` [out, in, 3, 3], so ``state_dict`` keys do not
    change. ``impl``: 'pallas' runs the kernels forward and backward,
    'hybrid' the stock forward and the kernel backward."""

    def __init__(self, inc: int, outc: int, compute_dtype: torch.dtype = torch.float32,
                 impl: str = "pallas"):
        super().__init__(inc, outc, 3, compute_dtype=compute_dtype)
        self.impl = impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x, w = x.to(dt), self.weight.to(dt)
        if supported(x.shape, w.shape):
            fn = conv3x3_hybrid if self.impl == "hybrid" else conv3x3_pallas
            return fn(x, w)
        return F.conv2d(x, w, padding=self.padding)


def conv(inc: int, outc: int, kernel: int, compute_dtype: torch.dtype = torch.float32,
         impl: str = "xla") -> Conv2d:
    """A stride-1 'SAME' conv without bias; ``impl`` 'pallas' or 'hybrid'
    routes 3x3 convs through ``PallasConv3x3`` (JAX ``conv()``,
    models/blocks.py:38)."""
    if impl in ("pallas", "hybrid") and kernel == 3:
        return PallasConv3x3(inc, outc, compute_dtype=compute_dtype, impl=impl)
    return Conv2d(inc, outc, kernel, compute_dtype=compute_dtype)


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
    buffers are updated in place on every train-mode forward, except the
    forward that recomputes a ``remat`` region in the backward
    (``update_stats`` False there): they update once per forward the step
    takes, as JAX's ``nn.remat`` threads ``batch_stats`` once.

    Data parallel: with ``data_group`` set (``models.set_data_group``) to
    a group of several ranks, each rank holds its rows of every group, and
    the statistics are the global batch's: the per-group sums of x and x²
    and the element counts are summed over the ranks, one all-reduce per
    call, before mean and var = max(0, E[x²] - E[x]²). Global group g is
    then the concatenation over ranks of local group g, as GSPMD computes
    it for the JAX package, and the running statistics agree on every
    rank. ``nn.SyncBatchNorm`` has no groups.
    """

    data_group = None

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
        self.update_stats = True

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
        if self.data_group is None:
            mean = xf.mean(axes)                              # [G, C]
            var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
        else:
            mean, var = self._global_stats(xf, axes)
        if self.update_stats:
            self._update_running(mean.detach(), var.detach(), groups)
        gshape = (groups, 1) + bshape
        y = (xg - mean.reshape(gshape)) * (
            torch.rsqrt(var.reshape(gshape) + self.eps) * self.weight.reshape(bshape)
        ) + self.bias.reshape(bshape)
        return y.reshape(x.shape).to(self.compute_dtype)

    @torch.no_grad()
    def _update_running(self, mean: torch.Tensor, var: torch.Tensor, groups: int) -> None:
        keep = 1.0 - self.momentum
        rm, rv = self.running_mean, self.running_var
        for g in range(groups):  # sequential per-pass EMA composition
            rm = keep * rm + (1.0 - keep) * mean[g]
            rv = keep * rv + (1.0 - keep) * var[g]
        self.running_mean.copy_(rm)
        self.running_var.copy_(rv)

    def _global_stats(self, xf: torch.Tensor, axes: tuple):
        """[G, C] mean and var over the rows of every rank."""
        groups, c = xf.shape[0], xf.shape[2]
        count = torch.full((groups, 1), xf.numel() // (groups * c), dtype=xf.dtype,
                           device=xf.device)
        sums = torch.cat([xf.sum(axes), (xf * xf).sum(axes), count], dim=1)
        total, sq, n = all_reduce_sum(sums, self.data_group).split([c, c, 1], dim=1)
        mean = total / n
        return mean, torch.clamp(sq / n - mean * mean, min=0.0)


@contextlib.contextmanager
def recomputing(module: nn.Module):
    """The BatchNorms of ``module`` leave their running statistics as they
    are until the block ends (``GroupedBatchNorm.update_stats``)."""
    bns = [m for m in module.modules() if isinstance(m, GroupedBatchNorm)]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.update_stats = True


def remat(module: nn.Module, fn, *args):
    """``fn(*args)``, a region of ``module``, whose activations the
    backward recomputes instead of keeping them (``torch.utils.checkpoint``,
    non-reentrant; JAX ``nn.remat`` / ``jax.checkpoint``). The recompute
    updates no BatchNorm statistics (``recomputing``). Nothing random runs
    in a region (the steps draw their noise first), so no RNG state is
    stashed. The conv kernels' autograd reads ``needs_input_grad`` in the
    recompute as in the forward: the callers differentiate inside the same
    ``frozen`` block as they ran the forward."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(), recomputing(module)))


class ConvolutionalBlock(nn.Module):
    """Plain double-conv block (reference models.py:8-54): no skip path.

    conv3x3 -> BN(1e-4) -> LReLU -> conv3x3 -> BN(1e-4) -> LReLU.
    """

    def __init__(self, inc: int, outc: int,
                 compute_dtype: torch.dtype = torch.float32,
                 conv_impl: str = "xla", tile_rows: int = 0):
        super().__init__()
        if tile_rows > 0:
            raise not_ported("tile_rows > 0", "Queue 1 item 9")
        dt = compute_dtype
        self.conv1 = conv(inc, outc, 3, compute_dtype=dt, impl=conv_impl)
        self.bn1 = GroupedBatchNorm(outc, eps=1e-4, compute_dtype=dt)
        self.conv2 = conv(outc, outc, 3, compute_dtype=dt, impl=conv_impl)
        self.bn2 = GroupedBatchNorm(outc, eps=1e-4, compute_dtype=dt)

    def forward(self, x: torch.Tensor, groups: int = 1) -> torch.Tensor:
        y = leaky_relu(self.bn1(self.conv1(x), groups))
        return leaky_relu(self.bn2(self.conv2(y), groups))


class ResidualBlock(nn.Module):
    """Pre-BN residual block (reference models.py:57-115; JAX
    models/blocks.py:320).

    identity = x, or a 1x1 ``conv_expand`` (no bias) when inc != outc;
    out = LReLU(BN(conv3x3(LReLU(BN(conv3x3(x))))) + identity), BN eps 1e-5
    (torch's default: the reference passes none).
    """

    def __init__(self, inc: int, outc: int,
                 compute_dtype: torch.dtype = torch.float32,
                 conv_impl: str = "xla", tile_rows: int = 0):
        super().__init__()
        if tile_rows > 0:
            raise not_ported("tile_rows > 0", "Queue 1 item 9")
        dt = compute_dtype
        self.conv_expand = Conv2d(inc, outc, 1, compute_dtype=dt) if inc != outc else None
        self.conv1 = conv(inc, outc, 3, compute_dtype=dt, impl=conv_impl)
        self.bn1 = GroupedBatchNorm(outc, eps=1e-5, compute_dtype=dt)
        self.conv2 = conv(outc, outc, 3, compute_dtype=dt, impl=conv_impl)
        self.bn2 = GroupedBatchNorm(outc, eps=1e-5, compute_dtype=dt)

    def forward(self, x: torch.Tensor, groups: int = 1) -> torch.Tensor:
        identity = x if self.conv_expand is None else self.conv_expand(x)
        y = leaky_relu(self.bn1(self.conv1(x), groups))
        return leaky_relu(self.bn2(self.conv2(y), groups) + identity)


class Conv2dBatchNorm(nn.Module):
    """1x1 conv (no bias) -> BN(1e-4) -> LReLU (reference models.py:118-138;
    JAX models/blocks.py:352)."""

    def __init__(self, inc: int, outc: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(inc, outc, 1, compute_dtype=compute_dtype)
        self.batch_norm = GroupedBatchNorm(outc, eps=1e-4, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor, groups: int = 1) -> torch.Tensor:
        return leaky_relu(self.batch_norm(self.conv(x), groups))


class InceptionResnetBlock(nn.Module):
    """Two-branch 1x1 inception block with a residual add (reference
    models.py:141-182; JAX models/blocks.py:367).

    branch_0: 1x1 -> outc/2; branch_1: 1x1 -> midc -> 1x1 -> outc/2;
    concat -> 1x1 ``conv`` (with bias) -> + identity (a 1x1 ``conv_expand``
    when inc != outc) -> LReLU. Every conv is 1x1, so ``conv_impl`` and
    ``tile_rows`` route nothing (accepted as the other blocks accept them).
    """

    def __init__(self, inc: int, outc: int, scale: float = 1.0,
                 compute_dtype: torch.dtype = torch.float32,
                 conv_impl: str = "xla", tile_rows: int = 0):
        super().__init__()
        if outc % 2:
            raise ValueError(f"outc {outc} must be even")
        dt = compute_dtype
        midc = int(outc * scale)
        self.conv_expand = Conv2d(inc, outc, 1, compute_dtype=dt) if inc != outc else None
        self.branch_0 = Conv2dBatchNorm(inc, outc // 2, compute_dtype=dt)
        self.branch_1 = nn.ModuleList([Conv2dBatchNorm(inc, midc, compute_dtype=dt),
                                       Conv2dBatchNorm(midc, outc // 2, compute_dtype=dt)])
        self.conv = Conv2d(outc, outc, 1, bias=True, compute_dtype=dt)

    def forward(self, x: torch.Tensor, groups: int = 1) -> torch.Tensor:
        identity = x if self.conv_expand is None else self.conv_expand(x)
        x0 = self.branch_0(x, groups)
        x1 = self.branch_1[1](self.branch_1[0](x, groups), groups)
        y = self.conv(torch.cat([x0, x1], dim=1))
        return leaky_relu(y + identity)


_BLOCKS = {"conv": ConvolutionalBlock, "res": ResidualBlock,
           "inception": InceptionResnetBlock}


def get_conv_class(arch: str):
    """Block class for an architecture string (reference models.py:185-193)."""
    try:
        return _BLOCKS[arch]
    except KeyError:
        raise ValueError(f"unknown arch '{arch}' (expected one of {list(_BLOCKS)})")
