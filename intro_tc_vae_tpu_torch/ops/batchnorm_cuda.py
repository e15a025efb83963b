"""Train-mode grouped BatchNorm + leaky ReLU: CUDA kernels, autograd, routing.

The kernels (``csrc/bn_kernels.cu``; design and bound in the source) replace
no TPU kernel: the JAX package leaves BatchNorm to XLA. Forward:
``bn_stats`` (per-run partial sums), ``bn_finalize`` (mean, rstd, scale;
the running statistics' EMA), ``bn_apply`` (y); backward: ``bn_bwd_reduce``
(per-run partial sums of the gradient) and ``bn_bwd_dx`` (dx, and dweight
and dbias where asked for). The plain version, the numerics and the launch
plan are ``ops/batchnorm.py``'s.

``batchnorm_act_train`` is the one entry point of ``GroupedBatchNorm``'s
train mode; ``route`` decides from what the call can observe:

* a tensor on the CPU: the plain version;
* the statistics of a data group (``data_group`` set): the plain version,
  whose sums cross the ranks in one all-reduce between the two passes;
  counted in ``CALLS``. This is the one path on the card still waiting
  for a kernel: the kernels' split leaves room for the same all-reduce on
  their partials;
* else the kernels, which refuse (``ValueError``) what they cannot take:
  a dtype other than float32, bfloat16 or float16, an output dtype other
  than x's, parameters that are not float32, 2^31 elements or more.

``LAUNCHES`` counts kernel launches (``bn_stats`` once a call that takes
the kernels) and ``CALLS`` the calls that take the plain version on a data
group; both are registered with ``launch_counts``, which keeps them
counting under CUDA graph replay. ``running`` None (a ``remat``
recompute) leaves the running statistics as they are. Saved for the
backward: x in its own dtype, the bias and the [G, C] float32 statistics;
a gradient nobody asked for (``needs_input_grad``) is not computed.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from intro_tc_vae_tpu_torch.ops import launch_counts
from intro_tc_vae_tpu_torch.ops.batchnorm import (
    Plan,
    batchnorm_act,
    launch_plan,
)
from intro_tc_vae_tpu_torch.ops.cuda_build import load_library
from intro_tc_vae_tpu_torch.parallel.collectives import all_reduce_sum

KERNELS = ("bn_stats", "bn_finalize", "bn_apply", "bn_bwd_reduce", "bn_bwd_dx")
LAUNCHES = launch_counts.register(dict.fromkeys(KERNELS, 0))
CALLS = launch_counts.register({"plain_data_group": 0})

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SHAPE = [_I] * 8  # n, c, hw, groups, slices, per_slice, vec, threads
_ARGTYPES = {
    # x, part, shape, dtype, device, stream
    "bn_stats": [_P, _P] + _SHAPE + [_I, _I, _P],
    # part, weight, stat, running_mean, running_var, c, groups, slices,
    # count, eps, keep, momentum, device, stream
    "bn_finalize": [_P] * 5 + [_I] * 4 + [_F] * 3 + [_I, _P],
    # x, stat, bias, y, shape, slope, dtype, device, stream
    "bn_apply": [_P] * 4 + _SHAPE + [_F, _I, _I, _P],
    # x, dy, stat, bias, part, shape, slope, dtype, device, stream
    "bn_bwd_reduce": [_P] * 5 + _SHAPE + [_F, _I, _I, _P],
    # x, dy, stat, bias, part, dx, dweight, dbias, shape, slope, dtype, device, stream
    "bn_bwd_dx": [_P] * 8 + _SHAPE + [_F, _I, _I, _P],
}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, CALLS):
        for k in counts:
            counts[k] = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("bn_kernels")
    for entry, argtypes in _ARGTYPES.items():
        fn = getattr(lib, f"{entry}_launch")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(entry: str, *args, device: torch.device) -> None:
    """Enqueue ``entry`` on the current stream; tensors pass as their data
    pointers (None as a null pointer), then the device and the stream."""
    fn = getattr(_library(), f"{entry}_launch")
    stream = torch.cuda.current_stream(device).cuda_stream
    with launch_counts.host_range(f"itcvae::launch:{entry}"):
        err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
                 device.index, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {entry} failed to launch: cudaError {err}")
    LAUNCHES[entry] += 1


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def route(x: torch.Tensor, data_group) -> str:
    """Which path a train-mode call takes (module docstring):
    "plain_data_group", "plain" (the CPU) or "fused"."""
    if data_group is not None:
        return "plain_data_group"
    return "plain" if x.device.type == "cpu" else "fused"


def batchnorm_act_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, running,
                        groups: int, eps: float, momentum: float, slope: float,
                        out_dtype: torch.dtype, data_group=None) -> torch.Tensor:
    """Train-mode BatchNorm of x [N, C, ...] in ``groups`` groups, then a
    leaky ReLU of ``slope`` (1.0: none), by the route ``route`` picks;
    ``running``: (running_mean, running_var) to update, or None."""
    path = route(x, data_group)
    if path == "fused":
        if out_dtype != x.dtype:
            raise ValueError(f"the kernels write y in x's dtype {x.dtype}, not {out_dtype}")
        return _BatchNormAct.apply(x.contiguous(), weight, bias, running, groups, eps,
                                   momentum, slope)
    reduce = None
    if path == "plain_data_group":
        CALLS[path] += 1
        reduce = functools.partial(all_reduce_sum, mesh=data_group)
    return batchnorm_act(x, weight, bias, running, groups, eps, momentum, slope, out_dtype,
                         reduce)


def _plan(x: torch.Tensor, groups: int) -> tuple:
    """(n, c, hw, plan) of x [N, C, ...] in ``groups`` groups."""
    n, c = x.shape[0], x.shape[1]
    hw = x.numel() // (n * c)
    plan = launch_plan(n, c, hw, groups, x.element_size(), sm_count(x.device),
                       aligned=x.data_ptr() % 16 == 0)
    return n, c, hw, plan


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int) -> None:
    if x.device.type != "cuda" or x.dtype not in _DTYPE_CODE or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous CUDA tensor of float32, bfloat16 or "
                         f"float16, got {x.dtype} on {x.device}")
    if x.dim() < 2 or x.numel() >= 2**31 or x.numel() == 0 or x.shape[0] % groups:
        raise ValueError(f"x {tuple(x.shape)}: [N, C, ...] with N a multiple of groups "
                         f"{groups} and 1 to 2^31 - 1 elements")
    for name, t in (("weight", weight), ("bias", bias)):
        if (t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous()
                or tuple(t.shape) != (x.shape[1],)):
            raise ValueError(f"{name} must be float32 [{x.shape[1]}] on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _shape_args(n: int, c: int, hw: int, groups: int, plan: Plan) -> tuple:
    return (n, c, hw, groups, plan.slices, plan.samples, plan.vector, plan.threads)


class _BatchNormAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, running, groups: int, eps: float, momentum: float,
                slope: float):
        _check(x, weight, bias, groups)
        n, c, hw, plan = _plan(x, groups)
        shape = _shape_args(n, c, hw, groups, plan)
        code, dev = _DTYPE_CODE[x.dtype], x.device
        part = torch.empty((groups * c * plan.slices, 2), device=dev, dtype=torch.float32)
        launch("bn_stats", x, part, *shape, code, device=dev)
        stat = torch.empty((groups, c, 4), device=dev, dtype=torch.float32)
        rm, rv = running if running is not None else (None, None)
        launch("bn_finalize", part, weight, stat, rm, rv, c, groups, plan.slices,
               n // groups * hw, eps, 1.0 - momentum, momentum, device=dev)
        y = torch.empty_like(x)
        launch("bn_apply", x, stat, bias, y, *shape, slope, code, device=dev)
        ctx.save_for_backward(x, bias, stat)
        ctx.meta = (groups, slope)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, bias, stat = ctx.saved_tensors
        groups, slope = ctx.meta
        dy = dy.to(x.dtype).contiguous()
        n, c, hw, plan = _plan(x, groups)
        if plan != _plan(dy, groups)[3]:  # a vector width dy's alignment refuses
            plan = plan._replace(vector=1)
        shape = _shape_args(n, c, hw, groups, plan)
        code, dev = _DTYPE_CODE[x.dtype], x.device
        part = torch.empty((groups * c * plan.slices, 2), device=dev, dtype=torch.float32)
        launch("bn_bwd_reduce", x, dy, stat, bias, part, *shape, slope, code, device=dev)
        want_x, want_w, want_b = ctx.needs_input_grad[:3]
        dx = torch.empty_like(x) if want_x else None
        dw = torch.empty(c, device=dev, dtype=torch.float32) if want_w else None
        db = torch.empty(c, device=dev, dtype=torch.float32) if want_b else None
        launch("bn_bwd_dx", x, dy, stat, bias, part, dx, dw, db, *shape, slope, code,
               device=dev)
        return dx, dw, db, None, None, None, None, None
