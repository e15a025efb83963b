"""Train-mode grouped BatchNorm + leaky ReLU: CUDA kernels, autograd, routing.

The kernels (``csrc/bn_kernels.cu``; design and bound in the source) replace
no TPU kernel: the JAX package leaves BatchNorm to XLA. Forward:
``bn_stats`` (per-run partial sums), ``bn_finalize`` (mean, rstd, scale;
the running statistics' EMA), ``bn_apply`` (y); backward: ``bn_bwd_reduce``
(per-run partial sums of the gradient) and ``bn_bwd_dx`` (dx, and dweight
and dbias where asked for). The plain version, the numerics and the launch
plan are ``ops/batchnorm.py``'s.

``resample`` ("pool": the 2x2 average pool, stride 2; "up": the nearest 2x
upsample) takes the resample that follows the call into its kernels: the
output is the resampled act(BN(x)), written by ``bn_apply`` without the
full-size y, and the backward reads the resampled output's gradient in
``bn_bwd_reduce`` and ``bn_bwd_dx`` (an upsample's summed gradient is
written once by the first, for the second to read). The bits are those of
the call followed by ``F.avg_pool2d(y, 2)`` or ``F.interpolate(y,
scale_factor=2)`` and their backward passes (but a channels-last pool's
gradients, which its NHWC bodies sum window by window in another order:
within rounding); ``takes_resample`` says which
calls the kernels take it for (x [N, C, H, W] on the kernels' route, and,
for the pool, H and W even). Every other resample (the plain routes, an
odd plane's pool, eval mode, a residual or inception block's tail) is the
stock pass ``stock_resample``; this module is the one place that decides.

``batchnorm_act_train`` is the one entry point of ``GroupedBatchNorm``'s
train mode, for every resample; ``route`` decides from what the call can
observe:

* a tensor on the CPU: the plain version;
* the statistics of a data group (``data_group`` set): the plain version,
  whose sums cross the ranks in one all-reduce between the two passes;
  counted in ``CALLS``. This is the one path on the card still waiting
  for a kernel: the kernels' split leaves room for the same all-reduce on
  their partials;
* else the kernels, which refuse (``ValueError``) what they cannot take:
  a dtype other than float32, bfloat16 or float16, an output dtype other
  than x's, parameters that are not float32, 2^31 elements or more.

Layout (``nhwc``): x [N, C, H, W] lying channels-last, as the stock convs
around the call write it (``models/blocks.py::conv_layout``), takes the
kernels' NHWC bodies as it lies; every other x is made contiguous first.
y, dx and an upsample's summed gradient are written in x's layout and dy
is read in y's (made so, once, where it arrives in the other).

``LAUNCHES`` counts kernel launches (``bn_stats`` once a call that takes
the kernels; a resample variant counts under its kernel's name; in NHWC
``bn_bwd_dx`` launches ``bn_bwd_fold`` in front of its streaming kernel and
counts once), ``CALLS`` the calls that take the plain version on a data
group (``plain_data_group``) and those that take the NHWC bodies
(``bn_nhwc``), and
``RESAMPLES`` a stage's resamples by who ran them: ``resample_pool`` /
``resample_up`` the kernels, ``pool_stock`` / ``up_stock`` the stock pass.
All are registered with ``launch_counts``, which keeps them counting under
CUDA graph replay. ``running`` None (a ``remat`` recompute) leaves the
running statistics as they are. Saved for the
backward: x in its own dtype, the bias and the [G, C] float32 statistics;
a gradient nobody asked for (``needs_input_grad``) is not computed.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from intro_tc_vae_tpu_torch.ops import cuda_build, launch_counts
from intro_tc_vae_tpu_torch.ops.batchnorm import (
    batchnorm_act,
    launch_plan,
    nhwc_vector,
)
from intro_tc_vae_tpu_torch.ops.layout_cuda import channels_last
from intro_tc_vae_tpu_torch.parallel.collectives import all_reduce_sum

KERNELS = ("bn_stats", "bn_finalize", "bn_apply", "bn_bwd_reduce", "bn_bwd_dx")
LAUNCHES = launch_counts.register(dict.fromkeys(KERNELS, 0))
CALLS = launch_counts.register({"plain_data_group": 0, "bn_nhwc": 0})
RESAMPLES = launch_counts.register(dict.fromkeys(
    ("resample_pool", "resample_up", "pool_stock", "up_stock"), 0))
_RESAMPLE_CODE = {None: 0, "pool": 1, "up": 2}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SHAPE = [_I] * 10  # n, c, hw, w, groups, slices, per_slice, vec, threads, nhwc
_TAIL = [_I, _F, _I]  # resample, slope, dtype
LIBRARY = cuda_build.Library("bn_kernels", {
    # x, part, shape, dtype
    "bn_stats": [_P, _P] + _SHAPE + [_I],
    # part, weight, stat, running_mean, running_var, c, groups, slices,
    # count, eps, keep, momentum
    "bn_finalize": [_P] * 5 + [_I] * 4 + [_F] * 3,
    # x, stat, bias, y, shape, resample, slope, dtype
    "bn_apply": [_P] * 4 + _SHAPE + _TAIL,
    # x, dy, stat, bias, part, dsum, shape, resample, slope, dtype
    "bn_bwd_reduce": [_P] * 6 + _SHAPE + _TAIL,
    # x, dy, stat, bias, part, coef, dx, dweight, dbias, shape, resample, slope, dtype
    "bn_bwd_dx": [_P] * 9 + _SHAPE + _TAIL,
})
launch = functools.partial(cuda_build.launch, LIBRARY, counts=LAUNCHES)


def route(x: torch.Tensor, data_group) -> str:
    """Which path a train-mode call takes (module docstring):
    "plain_data_group", "plain" (the CPU) or "fused"."""
    if data_group is not None:
        return "plain_data_group"
    return "plain" if x.device.type == "cpu" else "fused"


def nhwc(x: torch.Tensor) -> bool:
    """Whether the kernels take x as it lies, channels-last: x [N, C, H, W]
    lying so (``layout_cuda.channels_last``), with channels the NHWC bodies
    hold (``batchnorm.nhwc_vector``)."""
    return (channels_last(x)
            and nhwc_vector(x.shape[1], x.element_size(), x.data_ptr() % 16 == 0) > 0)


def kernel_layout(x: torch.Tensor) -> torch.memory_format:
    """The layout the kernels take x in (``nhwc``)."""
    return torch.channels_last if nhwc(x) else torch.contiguous_format


def takes_resample(x: torch.Tensor, resample, data_group) -> bool:
    """Whether the kernels take ``resample`` ("pool", "up" or None) into
    the call: a call on their route (``route``) of x [N, C, H, W], with H
    and W even for the pool (an upsample has no such condition). Elsewhere
    the stock resample runs after the call."""
    if resample is None or x.dim() != 4 or route(x, data_group) != "fused":
        return False
    return resample == "up" or (x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0)


def stock_resample(x: torch.Tensor, resample) -> torch.Tensor:
    """x after a stage's ``resample`` as a stock pass ("pool": AvgPool2d(2),
    window 2, stride 2; "up": nn.Upsample(scale_factor=2, mode='nearest');
    None: none), counted in ``pool_stock`` / ``up_stock``."""
    if resample is None:
        return x
    RESAMPLES[f"{resample}_stock"] += 1
    if resample == "pool":
        return F.avg_pool2d(x, 2)
    return F.interpolate(x, scale_factor=2, mode="nearest")


def batchnorm_act_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, running,
                        groups: int, eps: float, momentum: float, slope: float,
                        out_dtype: torch.dtype, data_group=None,
                        resample=None) -> torch.Tensor:
    """Train-mode BatchNorm of x [N, C, ...] in ``groups`` groups, then a
    leaky ReLU of ``slope`` (1.0: none), by the route ``route`` picks;
    ``running``: (running_mean, running_var) to update, or None;
    ``resample``: the stage's "pool" or "up" after it, or None, taken into
    the kernels where ``takes_resample`` holds (counted in
    ``resample_pool`` / ``resample_up``), else run after the call as the
    stock pass (``stock_resample``)."""
    path = route(x, data_group)
    if path == "fused":
        if out_dtype != x.dtype:
            raise ValueError(f"the kernels write y in x's dtype {x.dtype}, not {out_dtype}")
        if nhwc(x):
            CALLS["bn_nhwc"] += 1
        else:
            x = x.contiguous()
        args = (x, weight, bias, running, groups, eps, momentum, slope)
        if takes_resample(x, resample, data_group):
            RESAMPLES[f"resample_{resample}"] += 1
            return _BatchNormAct.apply(*args, resample)
        return stock_resample(_BatchNormAct.apply(*args), resample)
    reduce = None
    if path == "plain_data_group":
        CALLS[path] += 1
        reduce = functools.partial(all_reduce_sum, mesh=data_group)
    return stock_resample(batchnorm_act(x, weight, bias, running, groups, eps, momentum, slope,
                                        out_dtype, reduce), resample)


def plan_of(x: torch.Tensor, groups: int) -> tuple:
    """(plan, the launchers' shape arguments) of x [N, C, ...] in
    ``groups`` groups, in x's layout (``nhwc``)."""
    n, c = x.shape[0], x.shape[1]
    hw = x.numel() // (n * c)
    w = x.shape[-1] if x.dim() > 2 else 1
    cut = nhwc(x)
    plan = launch_plan(n, c, hw, groups, x.element_size(), cuda_build.sm_count(x.device),
                       aligned=x.data_ptr() % 16 == 0, nhwc=cut, w=w)
    return plan, (n, c, hw, w, groups, plan.slices, plan.samples, plan.vector, plan.threads,
                  int(cut))


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int) -> None:
    if (x.device.type != "cuda" or x.dtype not in cuda_build.DTYPE_CODE
            or not x.is_contiguous(memory_format=kernel_layout(x))):
        raise ValueError(f"x must be a contiguous or channels-last CUDA tensor of float32, "
                         f"bfloat16 or float16, got {x.dtype} on {x.device}")
    if x.dim() < 2 or x.numel() >= 2**31 or x.numel() == 0 or x.shape[0] % groups:
        raise ValueError(f"x {tuple(x.shape)}: [N, C, ...] with N a multiple of groups "
                         f"{groups} and 1 to 2^31 - 1 elements")
    for name, t in (("weight", weight), ("bias", bias)):
        if (t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous()
                or tuple(t.shape) != (x.shape[1],)):
            raise ValueError(f"{name} must be float32 [{x.shape[1]}] on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def resampled_shape(x: torch.Tensor, resample) -> tuple:
    """The shape of x [N, C, H, W] after ``resample``."""
    if resample is None:
        return tuple(x.shape)
    n, c, h, w = x.shape
    return (n, c, h // 2, w // 2) if resample == "pool" else (n, c, 2 * h, 2 * w)


class _BatchNormAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, running, groups: int, eps: float, momentum: float,
                slope: float, resample=None):
        _check(x, weight, bias, groups)
        plan, shape = plan_of(x, groups)
        n, c, hw = shape[:3]
        code, dev = cuda_build.DTYPE_CODE[x.dtype], x.device
        part = torch.empty((groups * c * plan.slices, 2), device=dev, dtype=torch.float32)
        launch("bn_stats", x, part, *shape, code, device=dev)
        stat = torch.empty((groups, c, 4), device=dev, dtype=torch.float32)
        rm, rv = running if running is not None else (None, None)
        launch("bn_finalize", part, weight, stat, rm, rv, c, groups, plan.slices,
               n // groups * hw, eps, 1.0 - momentum, momentum, device=dev)
        y = torch.empty(resampled_shape(x, resample), dtype=x.dtype, device=dev,
                        memory_format=kernel_layout(x))
        launch("bn_apply", x, stat, bias, y, *shape, _RESAMPLE_CODE[resample], slope, code,
               device=dev)
        ctx.save_for_backward(x, bias, stat)
        ctx.meta = (groups, slope, resample)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, bias, stat = ctx.saved_tensors
        groups, slope, resample = ctx.meta
        plan, shape = plan_of(x, groups)
        c, cut = shape[1], bool(shape[-1])
        dy = dy.to(x.dtype).contiguous(memory_format=kernel_layout(x))
        if cut and plan.vector > 1 and dy.data_ptr() % 16:
            dy = dy.clone(memory_format=torch.channels_last)  # NHWC reads dy in vectors
        elif not cut and resample is None and plan != plan_of(dy, groups)[0]:
            # a vector width dy's alignment refuses; a resampled dy is read
            # element by element instead (the kernels' rows), in x's plan
            plan = plan._replace(vector=1)
            shape = shape[:7] + (1,) + shape[8:]
        code, dev = cuda_build.DTYPE_CODE[x.dtype], x.device
        rcode = _RESAMPLE_CODE[resample]
        part = torch.empty((groups * c * plan.slices, 2), device=dev, dtype=torch.float32)
        dsum = torch.empty_like(x) if resample == "up" else None
        launch("bn_bwd_reduce", x, dy, stat, bias, part, dsum, *shape, rcode, slope, code,
               device=dev)
        if dsum is not None:  # the upsample's gradient, summed: the plain bn_bwd_dx reads it
            dy, rcode = dsum, 0
        want_x, want_w, want_b = ctx.needs_input_grad[:3]
        dx = torch.empty_like(x) if want_x else None
        dw = torch.empty(c, device=dev, dtype=torch.float32) if want_w else None
        db = torch.empty(c, device=dev, dtype=torch.float32) if want_b else None
        coef = torch.empty((groups, c, 2), device=dev, dtype=torch.float32) if cut else None
        launch("bn_bwd_dx", x, dy, stat, bias, part, coef, dx, dw, db, *shape, rcode, slope,
               code, device=dev)
        return dx, dw, db, None, None, None, None, None, None
