"""Train-mode grouped BatchNorm with the activation after it: the plain
two-pass version and the launch plan of the CUDA kernels.

The function is ``models/blocks.py::GroupedBatchNorm`` in train mode
followed by a leaky ReLU of slope ``slope`` (1.0: none). The batch is G
equal groups of samples; per (group, channel) pair:

* the statistics, in at least float32: the sum and the sum of squares of
  the pair's elements, mean = sum / n, var = max(0, E[x^2] - mean^2) (the
  JAX package's numerics), rstd = rsqrt(var + eps), a = rstd * weight;
* the running averages take the G EMA updates in group order;
* y = act(round((x - mean) * a + bias)), where round is the cast to the
  compute dtype and act the leaky ReLU of that rounded value, computed in
  float32 and rounded once more: the rounding points of the module's
  output followed by ``F.leaky_relu``.

``batchnorm_act`` is the plain version: the same operations as the module
computed before it had a kernel, so on the CPU its values and its autograd
are the module's. ``batchnorm_act_backward_reference`` is the gradient in
the form the kernels compute it (``csrc/bn_kernels.cu``), with dy' the
incoming gradient through the activation's mask, recomputed from x:

    dx = a * (dy' - sum(dy') / n - xhat * sum(dy' * xhat) / n),
    xhat = (x - mean) * rstd,

where the last term is dropped for a pair whose variance was clamped
(var's gradient is zero there, as ``clamp``'s is); dweight[c] and
dbias[c] are sum(dy' * xhat) and sum(dy') added over the groups.

``launch_plan`` says how the kernels cut the work, from the shape alone:
each (group, channel) pair's samples are cut into ``slices`` runs of
``samples`` (the last may hold fewer), one block a run; a block reads the
run's planes in 16-byte vectors where the plane allows.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

VECTOR_BYTES = 16         # a thread's load or store
MAX_THREADS = 256         # threads of a block
BLOCK_ELEMENTS = 32768    # elements a block aims at: 64 KB of bf16
MIN_BLOCK_ELEMENTS = 4096  # a pair is not cut below this to fill the card
BLOCKS_PER_SM = 4         # blocks a multiprocessor should have to fill the card


class Plan(NamedTuple):
    slices: int    # runs of samples a (group, channel) pair is cut into
    samples: int   # samples a run holds; the last run holds the rest
    vector: int    # elements a thread loads at once: 16 bytes, or 1
    threads: int   # threads a block


def launch_plan(n: int, c: int, hw: int, groups: int, elem_bytes: int, sm_count: int,
                aligned: bool = True) -> Plan:
    """The cut of x [n, c, hw] in ``groups`` groups. A pair holds
    (n / groups) * hw elements: about ``BLOCK_ELEMENTS`` a block, and more
    blocks where the pairs are too few to give every multiprocessor
    ``BLOCKS_PER_SM``, while a run keeps ``MIN_BLOCK_ELEMENTS``. So the
    4x4 and 8x8 planes take one block a pair and the 128 px planes many.
    Vectors of 16 bytes where a plane is a whole number of them and x is
    aligned to 16 bytes; threads: the block's vectors in whole warps, up
    to ``MAX_THREADS``."""
    per_group = n // groups
    pair = per_group * hw
    slices = -(-pair // BLOCK_ELEMENTS)
    fill = min(-(-BLOCKS_PER_SM * sm_count // (groups * c)), pair // MIN_BLOCK_ELEMENTS)
    slices = min(max(slices, fill, 1), per_group)
    samples = -(-per_group // slices)
    slices = -(-per_group // samples)
    vector = VECTOR_BYTES // elem_bytes
    if hw % vector or not aligned:
        vector = 1
    vectors = samples * hw // vector
    threads = min(MAX_THREADS, max(32, -(-vectors // 32) * 32))
    return Plan(slices, samples, vector, threads)


def stats_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


@torch.no_grad()
def update_running(running_mean: torch.Tensor, running_var: torch.Tensor, mean: torch.Tensor,
                   var: torch.Tensor, momentum: float) -> None:
    """The G EMA updates of [G, C] mean and var, composed in group order
    (one batch-G*B pass equals G sequential batch-B passes)."""
    keep = 1.0 - momentum
    rm, rv = running_mean, running_var
    for g in range(mean.shape[0]):
        rm = keep * rm + (1.0 - keep) * mean[g]
        rv = keep * rv + (1.0 - keep) * var[g]
    running_mean.copy_(rm)
    running_var.copy_(rv)


def batchnorm_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, running,
                  groups: int, eps: float, momentum: float, slope: float,
                  out_dtype: torch.dtype,
                  reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """The plain version (module docstring). x [N, C, ...]; ``running``:
    (running_mean, running_var) to update, or None; ``reduce``, where the
    statistics are a data group's: takes the [G, 2C + 1] per-group sums,
    sums of squares and element counts and returns their sum over the
    ranks (one all-reduce)."""
    b, c = x.shape[0], x.shape[1]
    bshape = (c,) + (1,) * (x.dim() - 2)  # broadcast over [C, H, W]
    xg = x.reshape(groups, b // groups, *x.shape[1:])
    xf = xg.to(stats_dtype(xg.dtype))
    axes = (1,) + tuple(range(3, xg.dim()))
    total, sq = xf.sum(axes), (xf * xf).sum(axes)            # [G, C]
    if reduce is None:
        n = xf.numel() // (groups * c)
    else:
        count = torch.full((groups, 1), xf.numel() // (groups * c), dtype=xf.dtype,
                           device=xf.device)
        total, sq, n = reduce(torch.cat([total, sq, count], dim=1)).split([c, c, 1], dim=1)
    mean = total / n
    var = torch.clamp(sq / n - mean * mean, min=0.0)
    if running is not None:
        update_running(*running, mean.detach(), var.detach(), momentum)
    gshape = (groups, 1) + bshape
    y = (xg - mean.reshape(gshape)) * (
        torch.rsqrt(var.reshape(gshape) + eps) * weight.reshape(bshape)
    ) + bias.reshape(bshape)
    y = y.reshape(x.shape).to(out_dtype)
    return y if slope == 1.0 else F.leaky_relu(y, slope)


def batchnorm_act_backward_reference(x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor,
                                     bias: torch.Tensor, groups: int, eps: float,
                                     slope: float) -> tuple:
    """(dx, dweight, dbias) of ``batchnorm_act`` for the incoming dy, in
    the kernels' form (module docstring), computed in x's dtype promoted
    to at least float32; the activation's mask from the forward's value
    rounded to x's dtype, as the kernels recompute it."""
    b, c = x.shape[0], x.shape[1]
    gshape = (groups, 1, c) + (1,) * (x.dim() - 2)
    dt = stats_dtype(x.dtype)
    xg = x.reshape(groups, b // groups, *x.shape[1:]).to(dt)
    axes = (1,) + tuple(range(3, xg.dim()))
    n = xg.numel() // (groups * c)
    mean = xg.sum(axes) / n
    raw = (xg * xg).sum(axes) / n - mean * mean
    var = torch.clamp(raw, min=0.0)
    rstd = torch.rsqrt(var + eps)
    a = rstd * weight.to(dt)
    xc = xg - mean.reshape(gshape)
    d = dy.reshape(xg.shape).to(dt)
    if slope != 1.0:
        t = (xc * a.reshape(gshape) + bias.to(dt).reshape(gshape[1:])).to(x.dtype)
        d = torch.where(t > 0, d, d * slope)
    s_dy = d.sum(axes)                       # [G, C]
    s_dyxc = (d * xc).sum(axes)
    keep = (raw >= 0).to(dt)
    k1 = -a * s_dy / n
    k2 = -a * rstd * rstd * s_dyxc / n * keep
    dx = a.reshape(gshape) * d + k1.reshape(gshape) + xc * k2.reshape(gshape)
    dweight = (rstd * s_dyxc).sum(0)
    dbias = s_dy.sum(0)
    return dx.reshape(x.shape).to(x.dtype), dweight, dbias
