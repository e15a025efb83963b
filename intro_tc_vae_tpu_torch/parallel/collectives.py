"""Differentiable collectives over a data group.

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
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _all_reduce_copy(x: torch.Tensor, mesh) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=mesh.group)
    return y


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(mesh.size)]
        dist.all_gather(parts, x, group=mesh.group)
        ctx.mesh = mesh
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        parts = list(g.contiguous().chunk(ctx.mesh.size))
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=ctx.mesh.group)
        return out, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce_copy(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_copy(g, ctx.mesh), None


def all_gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """[B, ...] rows of every rank, concatenated in rank order: [R*B, ...]."""
    return _AllGatherRows.apply(x, mesh)


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over ranks of x, on every rank."""
    return _AllReduceSum.apply(x, mesh)


def all_reduce_mean_(x: torch.Tensor, mesh) -> torch.Tensor:
    """In place, outside autograd: x becomes the mean over ranks of x."""
    dist.all_reduce(x, group=mesh.group)
    return x.div_(mesh.size)
