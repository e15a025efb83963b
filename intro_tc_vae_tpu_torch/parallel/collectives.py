"""Differentiable collectives over a data group and over a model group.

The counterparts of ``jax.lax.all_gather`` (the sharded TC gathers the mu
bank, ``intro_tc_vae_tpu/ops/tc.py:250``) and of the psums that GSPMD
inserts where a reduction crosses the batch axis (BatchNorm's
statistics, the global-batch TC mean).

Semantics: each rank's backward computes the gradient of the sum of all
ranks' losses, and the solvers average the parameter gradients over the
ranks. The backward of each collective is then its adjoint: a sum over
ranks of the incoming gradients (``all_gather_rows``: a reduce-scatter
of the bank's gradient; ``all_reduce_sum``: itself).

These run inside ``torch.autograd.grad``, so every rank must reach them
in the same order, which holds because every rank builds the same graph.
Only the list forms of the collectives are used (``all_gather``,
``reduce_scatter``, ``all_reduce``), which both ``gloo`` and ``nccl``
take for CUDA tensors (gloo checked on an H100 with torch 2.11; PERF.md).

The model axis (tensor parallelism, ``parallel/mesh.py``) needs the other
pair of adjoints. The ranks of one model group hold the same rows and
compute the *same* loss, each from its slice of the sharded leaves, so
their gradients must not be summed as the data axis sums them:

* ``gather_channels``: all-gather along ``dim`` in model-rank order. Every
  rank's gradient of the gathered tensor is the whole (and the same)
  gradient, so the backward keeps this rank's slice of it.
* ``copy_to_model``: identity. Placed where a replicated tensor enters a
  computation each rank does only a part of (a conv that computes its
  output-channel slice); each rank's backward then holds the part of the
  gradient its slice contributes, and the all-reduce sums the parts.
* ``reduce_from_model``: all-reduce (sum) of the ranks' partial results
  (a row-parallel dense layer); the sum's gradient is the same on every
  rank, so the backward is the identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from intro_tc_vae_tpu_torch.parallel import comm_counts


_HALF = (torch.bfloat16, torch.float16)


def _all_reduce_copy(x: torch.Tensor, mesh, site: str) -> torch.Tensor:
    """The sum over the group's ranks of x, in a new tensor; a half-width
    x is summed in float32 and rounded back once. ``site``: its name in
    ``comm_counts``."""
    y = x.contiguous().to(torch.float32 if x.dtype in _HALF else x.dtype, copy=True)
    dist.all_reduce(y, group=mesh.group)
    comm_counts.count("all-reduce", site, y)
    return y.to(x.dtype)


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(mesh.size)]
        dist.all_gather(parts, x, group=mesh.group)
        comm_counts.count("all-gather", "all_gather_rows", *parts)
        ctx.mesh = mesh
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        parts = list(g.contiguous().chunk(ctx.mesh.size))
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=ctx.mesh.group)
        comm_counts.count("reduce-scatter", "all_gather_rows backward", out)
        return out, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce_copy(x, mesh, "all_reduce_sum")

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_copy(g, ctx.mesh, "all_reduce_sum backward"), None


def all_gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """[B, ...] rows of every rank, concatenated in rank order: [R*B, ...]."""
    return _AllGatherRows.apply(x, mesh)


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over ranks of x, on every rank."""
    return _AllReduceSum.apply(x, mesh)


def all_reduce_mean_(x: torch.Tensor, mesh) -> torch.Tensor:
    """In place, outside autograd: x becomes the mean over ranks of x."""
    dist.all_reduce(x, group=mesh.group)
    comm_counts.count("all-reduce", "all_reduce_mean_", x)
    return x.div_(mesh.size)


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.width = group, dim, x.shape[dim]
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.group.rank * ctx.width, ctx.width), None, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_copy(g, ctx.group, "copy_to_model backward"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_copy(x, group, "reduce_from_model")

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's x concatenated along ``dim`` in rank order, outside
    autograd. Half-width tensors travel as bytes (a copy of the bits;
    gloo has no 16-bit types)."""
    x = x.detach().contiguous()
    wire = x.view(torch.uint8) if x.dtype in _HALF else x
    parts = [torch.empty_like(wire) for _ in range(group.size)]
    dist.all_gather(parts, wire, group=group.group)
    comm_counts.count("all-gather", "all_gather_cat", *parts)
    return torch.cat(parts, dim=dim).view(x.dtype)


def gather_channels(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """The model group's slices of a tensor, concatenated along ``dim`` in
    model-rank order; the backward keeps this rank's slice."""
    return _GatherChannels.apply(x, group, dim)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """x itself; the backward sums the model group's partial gradients."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the model group of the ranks' partial x; the backward
    passes the gradient through."""
    return _ReduceFromModel.apply(x, group)
