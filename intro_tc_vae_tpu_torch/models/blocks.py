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

Tensor parallelism (``parallel.shard_state``): a module whose leaves are
sharded over the model axis records them in ``tp_dims``, and every module
of a sharded model knows its ``model_group``. An activation then holds
either all its channels (the same on every rank of the model group) or
this rank's contiguous slice of them, and each module reads which from
the channel count it is handed:

* a conv whose weight is sharded computes its output-channel slice from
  its whole input (gathered first, ``gather_channels``, if it came
  sharded), through ``copy_to_model``, whose backward sums the ranks'
  partial input gradients; its bias slice is its own;
* a conv whose weight is whole takes a whole input and gives a whole
  output;
* a sharded ``GroupedBatchNorm`` and the leaky ReLU after it run on the
  slice; its statistics still sum over the data group only;
* a dense layer sharded along its input features (row-parallel) takes its
  slice of the features and sums the ranks' partial products
  (``reduce_from_model``); one sharded along its outputs (column-parallel)
  gives this rank's slice of them;
* where the next op needs every channel (a whole conv, the inception
  block's concat, a residual add of another layout), the slice is
  gathered, and where a sharded op is handed a whole tensor it takes its
  slice (``copy_to_model``, then the slice).

A conv the kernel gate routes (``ops/conv.py::supported``: 64 -> 64) is
never sharded at the default ``min_dim`` 256. Where a lower ``min_dim``
shards one, ``PallasConv3x3`` gathers its weight and runs it whole on the
whole input, as GSPMD runs a custom call whose operands it cannot
partition, and the BatchNorm after it takes its slice.

``STOCK_CALLS`` counts the calls that take a stock route where the
decision is made, one add a call (forward only: a conv's backward follows
its forward's route). It is registered with ``ops/launch_counts.py``, so
it keeps counting under CUDA graph replay (Python runs only at the
capture; each replay adds the capture's tally):

* ``conv_stock_size``: a ``PallasConv3x3`` (impl 'pallas' or 'hybrid')
  whose weight is 64 -> 64 3x3 but whose input ``supported`` refuses by
  H, W or H * W (a 64 -> 64 conv at 256 x 256), run by the stock conv;
* ``conv_stock_channels``: a ``PallasConv3x3`` that is not 64 -> 64, run
  by the stock conv;
* ``residual_tail``: a ``ResidualBlock`` call, whose residual add and
  LeakyReLU run as stock passes;
* ``conv_expand``: a ``ResidualBlock`` call through its 1x1 projection.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from intro_tc_vae_tpu_torch.ops import launch_counts
from intro_tc_vae_tpu_torch.ops.batchnorm_cuda import batchnorm_act_train
from intro_tc_vae_tpu_torch.ops.conv import WEIGHT_SHAPE, supported
from intro_tc_vae_tpu_torch.ops.conv_cuda import conv3x3_hybrid, conv3x3_pallas
from intro_tc_vae_tpu_torch.parallel.collectives import (
    copy_to_model,
    gather_channels,
    reduce_from_model,
)

LEAKY_SLOPE = 0.2
STOCK_CALLS = launch_counts.register(dict.fromkeys(
    ("conv_stock_size", "conv_stock_channels", "residual_tail", "conv_expand"), 0))


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LEAKY_SLOPE)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(2): window 2, stride 2."""
    return F.avg_pool2d(x, 2)


def upsample_nearest2(x: torch.Tensor) -> torch.Tensor:
    """nn.Upsample(scale_factor=2, mode='nearest')."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def tp_dim(module: nn.Module, name: str = "weight"):
    """The dim along which ``module``'s leaf ``name`` is sharded, or None."""
    return getattr(module, "tp_dims", {}).get(name)


def whole(x: torch.Tensor, channels: int, group, dim: int = 1) -> torch.Tensor:
    """x with all of its ``channels`` along ``dim``: gathered from the
    model group when x holds this rank's slice."""
    if group is None or x.shape[dim] == channels:
        return x
    return gather_channels(x, group, dim)


def local(x: torch.Tensor, channels: int, group, dim: int = 1) -> torch.Tensor:
    """This rank's slice of x's ``channels`` along ``dim``; a whole x goes
    through ``copy_to_model`` first, so its gradient is summed."""
    if x.shape[dim] != channels:
        return x
    width = channels // group.size
    return copy_to_model(x, group).narrow(dim, group.rank * width, width)


def like(x: torch.Tensor, ref: torch.Tensor, channels: int, group) -> torch.Tensor:
    """x, of ``channels`` channels, in the layout of ``ref`` (whole or
    this rank's slice), for a residual add."""
    if x.shape[1] == ref.shape[1]:
        return x
    return whole(x, channels, group) if ref.shape[1] == channels else local(x, channels, group)


def whole_leaf(module: nn.Module, name: str) -> torch.Tensor:
    """A parameter of ``module`` whole: gathered when it is sharded (the
    backward keeps this rank's slice of its gradient)."""
    t = getattr(module, name)
    d = tp_dim(module, name)
    return t if d is None else gather_channels(t, module.model_group, d)


class Conv2d(nn.Conv2d):
    """Stride-1 'SAME' conv computed in ``compute_dtype``."""

    def __init__(self, inc: int, outc: int, kernel: int, bias: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(inc, outc, kernel, padding=kernel // 2, bias=bias)
        self.compute_dtype = compute_dtype

    def tp_input(self, x: torch.Tensor) -> torch.Tensor:
        """The whole input; through ``copy_to_model`` when the weight is
        sharded (this rank then computes its output-channel slice)."""
        group = getattr(self, "model_group", None)
        x = whole(x, self.in_channels, group)
        return x if tp_dim(self) is None else copy_to_model(x, group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.tp_input(x)
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
        group = getattr(self, "model_group", None)
        x, w = whole(x, self.in_channels, group), self.weight
        if tp_dim(self) is not None:
            if supported(x.shape, (self.out_channels, *w.shape[1:])):
                w = whole_leaf(self, "weight")  # a routed conv runs whole
            else:
                x = copy_to_model(x, group)
        x, w = x.to(dt), w.to(dt)
        if supported(x.shape, w.shape):
            fn = conv3x3_hybrid if self.impl == "hybrid" else conv3x3_pallas
            return fn(x, w)
        STOCK_CALLS["conv_stock_size" if tuple(w.shape) == WEIGHT_SHAPE
                    else "conv_stock_channels"] += 1
        return F.conv2d(x, w, padding=self.padding)


def conv(inc: int, outc: int, kernel: int, compute_dtype: torch.dtype = torch.float32,
         impl: str = "xla", tile_rows: int = 0, bias: bool = False) -> Conv2d:
    """A stride-1 'SAME' conv (JAX ``conv()``, models/blocks.py:38).
    ``impl`` 'pallas' or 'hybrid' routes a 3x3 conv without bias through
    ``PallasConv3x3`` when ``tile_rows`` is 0; ``tile_rows > 0`` makes every
    conv with kernel > 1 a ``StripTiledConv``, a 1x1 conv stays plain. So
    with ``tile_rows > 0`` no conv reaches the conv kernels, as in JAX."""
    if impl in ("pallas", "hybrid") and kernel == 3 and not bias and tile_rows == 0:
        return PallasConv3x3(inc, outc, compute_dtype=compute_dtype, impl=impl)
    if tile_rows > 0 and kernel > 1:
        return StripTiledConv(inc, outc, kernel, tile_rows, bias=bias,
                              compute_dtype=compute_dtype)
    return Conv2d(inc, outc, kernel, bias=bias, compute_dtype=compute_dtype)


class StripTiledConv(Conv2d):
    """The same stride-1 'SAME' conv as ``Conv2d``, computed space-to-batch
    (JAX ``StripTiledConv``, models/blocks.py:74): when the input height H
    is at least ``2 * tile_rows``, the image is cut into t = H //
    tile_rows horizontal strips with ``kernel // 2`` halo rows on each
    side, stacked sample-major on the batch axis and convolved VALID in H,
    SAME in W. Every output pixel takes exactly the plain conv's taps; only
    the order of the sums may differ. H < 2 * tile_rows, or H not a
    multiple of t, runs the plain conv. ``weight`` and ``bias`` are
    ``Conv2d``'s, so ``state_dict`` keys and checkpoints do not change.

    NCHW reassembly: the strips' outputs [N*t, C, hs, W] are viewed as
    [N, t, C, hs, W] and their strip axis moved next to the rows before the
    reshape to [N, C, H, W]; JAX's NHWC needs no move."""

    def __init__(self, inc: int, outc: int, kernel: int, tile_rows: int,
                 bias: bool = False, compute_dtype: torch.dtype = torch.float32):
        super().__init__(inc, outc, kernel, bias=bias, compute_dtype=compute_dtype)
        self.tile_rows = tile_rows

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x, w = self.tp_input(x).to(dt), self.weight.to(dt)
        bias = None if self.bias is None else self.bias.to(dt)
        n, c, h, width = x.shape
        r = self.kernel_size[0] // 2
        t = h // self.tile_rows if h >= 2 * self.tile_rows else 1
        if t == 1 or h % t:
            return F.conv2d(x, w, bias, padding=r)
        hs = h // t
        xp = F.pad(x, (0, 0, r, r))
        strips = torch.stack([xp[:, :, i * hs:i * hs + hs + 2 * r] for i in range(t)], dim=1)
        y = F.conv2d(strips.reshape(n * t, c, hs + 2 * r, width), w, bias, padding=(0, r))
        return y.reshape(n, t, -1, hs, width).transpose(1, 2).reshape(n, -1, h, width)


def packed_tap_table(block: int, kernel: int = 5) -> np.ndarray:
    """The one-hot table [9 * block^4, kernel^2] of the packed predict conv
    (JAX ``PackedPredictConv``, models/blocks.py:449-462): row (di, dj, ai,
    aj, ao, bo) of the packed 3x3 tap (di, dj) from input offset (ai, aj)
    in a block to output offset (ao, bo) picks the original tap (ky, kx)
    with ky = (di - 1) * block + ai + kernel // 2 - ao (kx likewise), or
    nothing when that lies outside the kernel."""
    b, k = block, kernel
    di, ai, ao = np.ogrid[0:3, 0:b, 0:b]
    ky = (di - 1) * b + ai + k // 2 - ao                       # [3, b, b]
    ky = np.where((ky >= 0) & (ky < k), ky, -1)
    rows = ky[:, None, :, None, :, None]
    cols = ky[None, :, None, :, None, :]
    sel = np.where((rows < 0) | (cols < 0), -1, rows * k + cols)  # [3, 3, b, b, b, b]
    onehot = np.zeros(sel.shape + (k * k,), np.float32)
    np.put_along_axis(onehot, np.maximum(sel, 0)[..., None],
                      (sel >= 0)[..., None].astype(np.float32), axis=-1)
    return onehot.reshape(-1, k * k)


class PackedPredictConv(Conv2d):
    """The decoder's 5x5 stride-1 'SAME' conv to ``cdim`` channels (with
    bias), computed output-packed (JAX ``PackedPredictConv``,
    models/blocks.py:404): ``pixel_unshuffle`` by ``block`` b, a 3x3 conv
    from b^2 * in to b^2 * cdim channels at 1/b^2 of the pixels, and
    ``pixel_shuffle`` back. The same products summed in another order.

    ``weight`` [cdim, in, 5, 5] and ``bias`` [cdim] are the plain conv's,
    so ``state_dict`` keys and checkpoints do not change. The packed
    weight is rebuilt from ``weight`` on every call by the one-hot product
    ``P @ w`` (exact in any dtype: one nonzero a row), so autograd carries
    its gradient back to ``weight``; the table P is a non-persistent
    buffer. Channel orders are PyTorch's: ``pixel_unshuffle`` gives input
    channel c * b^2 + ai * b + aj and ``pixel_shuffle`` reads output
    channel co * b^2 + ao * b + bo (both channel-major, where JAX's
    space-to-depth is channel-minor), so the bias is repeated b^2 times
    per channel, not tiled."""

    def __init__(self, inc: int, cdim: int, block: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(inc, cdim, 5, bias=True, compute_dtype=compute_dtype)
        self.block = block
        self.register_buffer("onehot", torch.from_numpy(packed_tap_table(block)),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, b = self.compute_dtype, self.block
        cdim, cin, k, _ = self.weight.shape
        w = self.weight.to(dt).permute(2, 3, 1, 0).reshape(k * k, cin * cdim)
        # [di, dj, ai, aj, ao, bo, cin, cdim] -> [cdim, ao, bo, cin, ai, aj, di, dj]
        wp = (self.onehot.to(dt) @ w).reshape(3, 3, b, b, b, b, cin, cdim)
        wp = wp.permute(7, 4, 5, 6, 2, 3, 0, 1).reshape(cdim * b * b, cin * b * b, 3, 3)
        bias = self.bias.to(dt).repeat_interleave(b * b)
        yp = F.conv2d(F.pixel_unshuffle(self.tp_input(x).to(dt), b), wp, bias, padding=1)
        return F.pixel_shuffle(yp, b)


class Linear(nn.Linear):
    """Dense layer computed in ``compute_dtype``.

    Under tensor parallelism its weight [out, in] is sharded along dim 0
    (column-parallel: the output is this rank's slice of the features,
    the bias slice its own) or dim 1 (row-parallel: this rank's slice of
    the input features times its slice of the weight, summed over the
    model group in at least float32, then the whole bias). A sharded bias
    of a layer whose weight is not column-parallel is gathered."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        group = getattr(self, "model_group", None)
        d = tp_dim(self)
        bias = self.bias if d == 0 else whole_leaf(self, "bias")
        if d == 1:
            x = local(x, self.in_features, group)
            acc = torch.promote_types(dt, torch.float32)
            y = reduce_from_model(F.linear(x.to(dt), self.weight.to(dt)).to(acc), group)
            return (y + bias.to(acc)).to(dt)
        x = whole(x, self.in_features, group)
        if d == 0:
            x = copy_to_model(x, group)
        return F.linear(x.to(dt), self.weight.to(dt), bias.to(dt))


class GroupedBatchNorm(nn.Module):
    """BatchNorm with the JAX package's numerics and *grouped* statistics,
    and the leaky ReLU after it.

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

    ``forward(x, groups, slope)`` returns the leaky ReLU of slope ``slope``
    (1.0: none) of the normalized x, in ``compute_dtype``: the activation
    the blocks apply after it, taken into the call so that train mode runs
    both as the CUDA kernels of ``ops/batchnorm_cuda.py`` on the card
    (``batchnorm_act_train``, which also picks the plain two-pass version
    of ``ops/batchnorm.py`` for CPU tensors and the cases its docstring
    lists). Eval mode uses the running statistics, unfused.

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
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.update_stats = True

    def forward(self, x: torch.Tensor, groups: int = 1, slope: float = 1.0) -> torch.Tensor:
        group = getattr(self, "model_group", None)
        if tp_dim(self) is not None:
            x = local(x, self.num_features, group)
        else:
            x = whole(x, self.num_features, group)
        if not self.training:
            bshape = (x.shape[1],) + (1,) * (x.dim() - 2)  # broadcast over [C, H, W]
            scale = torch.rsqrt(self.running_var + self.eps) * self.weight
            y = (x - self.running_mean.reshape(bshape)) * scale.reshape(bshape) \
                + self.bias.reshape(bshape)
            y = y.to(self.compute_dtype)
            return y if slope == 1.0 else F.leaky_relu(y, slope)
        if x.shape[0] % groups:
            raise ValueError(f"batch {x.shape[0]} not divisible by groups {groups}")
        running = (self.running_mean, self.running_var) if self.update_stats else None
        return batchnorm_act_train(x, self.weight, self.bias, running, groups, self.eps,
                                   self.momentum, slope, self.compute_dtype, self.data_group)


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
        dt = compute_dtype
        self.conv1 = conv(inc, outc, 3, compute_dtype=dt, impl=conv_impl, tile_rows=tile_rows)
        self.bn1 = GroupedBatchNorm(outc, eps=1e-4, compute_dtype=dt)
        self.conv2 = conv(outc, outc, 3, compute_dtype=dt, impl=conv_impl, tile_rows=tile_rows)
        self.bn2 = GroupedBatchNorm(outc, eps=1e-4, compute_dtype=dt)

    def forward(self, x: torch.Tensor, groups: int = 1) -> torch.Tensor:
        y = self.bn1(self.conv1(x), groups, LEAKY_SLOPE)
        return self.bn2(self.conv2(y), groups, LEAKY_SLOPE)


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
        dt = compute_dtype
        self.conv_expand = Conv2d(inc, outc, 1, compute_dtype=dt) if inc != outc else None
        self.conv1 = conv(inc, outc, 3, compute_dtype=dt, impl=conv_impl, tile_rows=tile_rows)
        self.bn1 = GroupedBatchNorm(outc, eps=1e-5, compute_dtype=dt)
        self.conv2 = conv(outc, outc, 3, compute_dtype=dt, impl=conv_impl, tile_rows=tile_rows)
        self.bn2 = GroupedBatchNorm(outc, eps=1e-5, compute_dtype=dt)

    def forward(self, x: torch.Tensor, groups: int = 1) -> torch.Tensor:
        if self.conv_expand is None:
            identity = x
        else:
            STOCK_CALLS["conv_expand"] += 1
            identity = self.conv_expand(x)
        y = self.bn1(self.conv1(x), groups, LEAKY_SLOPE)
        y = self.bn2(self.conv2(y), groups)
        group = getattr(self, "model_group", None)
        STOCK_CALLS["residual_tail"] += 1
        return leaky_relu(y + like(identity, y, self.bn2.num_features, group))


class Conv2dBatchNorm(nn.Module):
    """1x1 conv (no bias) -> BN(1e-4) -> LReLU (reference models.py:118-138;
    JAX models/blocks.py:352)."""

    def __init__(self, inc: int, outc: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(inc, outc, 1, compute_dtype=compute_dtype)
        self.batch_norm = GroupedBatchNorm(outc, eps=1e-4, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor, groups: int = 1) -> torch.Tensor:
        return self.batch_norm(self.conv(x), groups, LEAKY_SLOPE)


class InceptionResnetBlock(nn.Module):
    """Two-branch 1x1 inception block with a residual add (reference
    models.py:141-182; JAX models/blocks.py:367).

    branch_0: 1x1 -> outc/2; branch_1: 1x1 -> midc -> 1x1 -> outc/2;
    concat -> 1x1 ``conv`` (with bias) -> + identity (a 1x1 ``conv_expand``
    when inc != outc) -> LReLU. Every conv is 1x1, so ``conv_impl`` and
    ``tile_rows`` route nothing (accepted as the other blocks accept them).
    Under tensor parallelism each branch is gathered before the concat:
    two channel slices side by side are not a slice of the concat.
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
        group = getattr(self, "model_group", None)
        half = self.conv.in_channels // 2
        y = self.conv(torch.cat([whole(x0, half, group), whole(x1, half, group)], dim=1))
        return leaky_relu(y + like(identity, y, self.conv.out_channels, group))


_BLOCKS = {"conv": ConvolutionalBlock, "res": ResidualBlock,
           "inception": InceptionResnetBlock}


def get_conv_class(arch: str):
    """Block class for an architecture string (reference models.py:185-193)."""
    try:
        return _BLOCKS[arch]
    except KeyError:
        raise ValueError(f"unknown arch '{arch}' (expected one of {list(_BLOCKS)})")
