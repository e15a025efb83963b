"""Total-correlation estimator of β-TC-VAE.

Counterpart of ``intro_tc_vae_tpu/ops/tc.py``. The minibatch TC estimate
needs the [B, B, z] tensor of pairwise latent log densities
log q(z(x_j)_l | x_i) and two logsumexp reductions over i:

* ``impl='xla'``       — the plain materialized [B, B, z] path in PyTorch
  ops (``tc_logsumexp_reference``).
* ``impl='blockwise'`` — a streaming loop over blocks of mu rows with
  online logsumexps (``tc_logsumexp_blockwise``), O(B·z + B·block)
  memory.
* ``impl='pallas'``    — the fused CUDA kernels (``tc_logsumexp_cuda``),
  which never write the [B, B, z] tensor; the name is the JAX package's
  config value.

``sampling='weighted'`` (the minibatch-weighted estimate) and
``tc_decomposition`` (the full ELBO decomposition of ``kl_kind:
"tc_full"``) are the materialized form only, as in the JAX package.

Under a data group of several ranks (``mesh``), ``total_correlation``
computes the global-batch TC with every impl
(``total_correlation_sharded``: one all-gather of mu, then each rank's
rows against the whole bank). The JAX package does that for the scaling
impls only and leaves 'xla' to GSPMD, which also computes the global
batch; the port has no GSPMD, so it routes all three. The weighted
estimate and the decomposition need every sample's z and variance too,
so they gather z, mu and logvar and compute the global batch's
materialized form on every rank, which then keeps its rows
(``rows_of_global_batch``), as GSPMD partitions the JAX form.

Indexing quirk kept from the as-executed reference: entry [j, i, l] is
log N(z_j | mu_i, var_j) — the *sample's* variance, not the
distribution's. ``tc_decomposition`` indexes the variance by i, as the
reference's full decomposition does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from intro_tc_vae_tpu_torch.ops.density import (
    gaussian_log_density,
    gaussian_log_density_nll,
    log_importance_weight_block,
    minibatch_stratified_sampling,
    minibatch_weighted_sampling,
)
from intro_tc_vae_tpu_torch.ops.tc_cuda import (
    tc_logsumexp_cuda,
    tc_logsumexp_cuda_gathered,
    tc_logsumexp_reference,
    tc_logsumexp_reference_gathered,
)
from intro_tc_vae_tpu_torch.parallel.collectives import all_gather_rows, all_reduce_sum

IMPLS = ("xla", "blockwise", "pallas")
SAMPLINGS = ("stratified", "weighted")


def total_correlation(
    z: torch.Tensor,
    mu: torch.Tensor,
    logvar: torch.Tensor,
    dataset_size: int,
    reduce: str = "mean",
    impl: str = "xla",
    sampling: str = "stratified",
    mesh=None,
) -> torch.Tensor:
    """Minibatch estimate of TC(z): E_j[log q(z_j) - log prod_l q(z_jl)],
    stratified (what the reference executes) or ``sampling='weighted'``
    (the materialized form whatever ``impl``, JAX ``ops/tc.py:86-90``).

    Returns a scalar for reduce='mean', else the [B] vector. With a
    ``mesh`` (``parallel.DataGroup``) of more than one rank, z/mu/logvar
    are this rank's rows and the estimate is the global batch's.
    """
    if sampling not in SAMPLINGS:
        raise ValueError(f"tc_sampling={sampling!r}: expected 'stratified' or 'weighted'")
    if impl not in IMPLS:
        raise ValueError(f"tc_impl={impl!r}: expected 'xla', 'blockwise' or 'pallas'")
    sharded = mesh is not None and mesh.size > 1
    if sampling == "weighted":
        def weighted(z, mu, logvar):
            log_qz_prob = gaussian_log_density_nll(z[:, None, :], mu[None, :, :],
                                                   logvar[:, None, :])
            pm, qz = minibatch_weighted_sampling(log_qz_prob, z.shape[0], dataset_size)
            return (qz - pm,)

        tc, = (rows_of_global_batch(weighted, mesh, z, mu, logvar) if sharded
               else weighted(z, mu, logvar))
    elif sharded:
        return total_correlation_sharded(z, mu, logvar, dataset_size, mesh,
                                         reduce=reduce, impl=impl)
    else:
        log_qz_product, log_qz = _logsumexps(impl, z, mu, logvar, dataset_size)
        tc = log_qz - log_qz_product
    if reduce == "mean":
        return tc.mean()
    return tc


def tc_decomposition(z: torch.Tensor, mu: torch.Tensor, logvar: torch.Tensor,
                     dataset_size: int, mesh=None):
    """The full ELBO decomposition, per sample (JAX ``ops/tc.py:283-316``;
    reference solvers/tc.py:91-144):

        mi = log q(z|x) - log q(z)
        tc = log q(z) - log prod_l q(z_l)
        kl = log prod_l q(z_l) - log p(z)

    with the plain (non-floored) Gaussian density, the variance indexed by
    i, and the stratified weights. Returns the [B] vectors (mi, tc, kl);
    with a ``mesh`` of several ranks, this rank's rows of the global
    batch's decomposition."""
    if mesh is not None and mesh.size > 1:
        return rows_of_global_batch(
            lambda *t: tc_decomposition(*t, dataset_size), mesh, z, mu, logvar)
    logqz_condx = gaussian_log_density(z, mu, logvar).sum(dim=1)
    zeros = torch.zeros_like(z)
    logpz = gaussian_log_density(z, zeros, zeros).sum(dim=1)
    log_qz_prob = gaussian_log_density(z[:, None, :], mu[None, :, :], logvar[None, :, :])
    logqz_prodmarginals, log_qz = minibatch_stratified_sampling(
        log_qz_prob, z.shape[0], dataset_size)
    return (logqz_condx - log_qz, log_qz - logqz_prodmarginals,
            logqz_prodmarginals - logpz)


def rows_of_global_batch(fn, mesh, z, mu, logvar) -> tuple:
    """``fn(z, mu, logvar)`` (a tuple of [GB] vectors) on the global batch,
    every rank's rows gathered in one all-gather, and this rank's rows of
    each result. Each rank's backward then sends every rank the gradient
    of its own rows' results, and the gather's adjoint sums them."""
    b = z.shape[0]
    glob = all_gather_rows(torch.stack([z, mu, logvar], dim=1), mesh)
    out = fn(*glob.unbind(dim=1))
    rows = slice(mesh.rank * b, (mesh.rank + 1) * b)
    return tuple(o[rows] for o in out)


def _logsumexps(impl: str, z, mu, logvar, dataset_size: int,
                row_off: Optional[int] = None, global_batch: Optional[int] = None):
    """(log prod_l q(z_l), log q(z)) by ``impl``; with ``row_off``, z and
    logvar are rows row_off.. of a global batch whose whole mu bank is
    ``mu``."""
    if impl == "pallas":
        z, mu, logvar = z.contiguous(), mu.contiguous(), logvar.contiguous()
        if row_off is None:
            return tc_logsumexp_cuda(z, mu, logvar, dataset_size)
        return tc_logsumexp_cuda_gathered(z, mu, logvar, row_off, dataset_size,
                                          global_batch)
    if impl == "blockwise":
        return tc_logsumexp_blockwise(z, mu, logvar, dataset_size,
                                      row_offset=row_off, global_batch=global_batch)
    if row_off is None:
        return tc_logsumexp_reference(z, mu, logvar, dataset_size)
    return tc_logsumexp_reference_gathered(z, mu, logvar, row_off, dataset_size,
                                           global_batch)


def _online_block(m_m, s_m, m_j, s_j, z, mu_blk, logvar, iw):
    """Fold one block of mu rows into the online logsumexps: per (j, l)
    over i of iw + P (marginals), per j over i of iw + sum_l P (joint)."""
    p = gaussian_log_density_nll(z[:, None, :], mu_blk[None, :, :], logvar[:, None, :])
    xm = iw[:, :, None] + p                                     # [B, blk, z]
    new_m = torch.maximum(m_m, xm.amax(dim=1))
    s_m = s_m * torch.exp(m_m - new_m) + torch.exp(xm - new_m[:, None, :]).sum(dim=1)
    xj = iw + p.sum(dim=2)                                      # [B, blk]
    new_j = torch.maximum(m_j, xj.amax(dim=1))
    s_j = s_j * torch.exp(m_j - new_j) + torch.exp(xj - new_j[:, None]).sum(dim=1)
    return new_m, s_m, new_j, s_j


def tc_logsumexp_blockwise(z: torch.Tensor, mu: torch.Tensor, logvar: torch.Tensor,
                           dataset_size: int, block: int = 128,
                           row_offset: Optional[int] = None,
                           global_batch: Optional[int] = None):
    """Streaming TC reductions over blocks of mu rows; never materializes
    [B, B, z] (``intro_tc_vae_tpu/ops/tc.py::tc_logsumexp_blockwise``).

    Each block is recomputed in the backward (``checkpoint``, as the JAX
    scan body is ``jax.checkpoint``ed), so memory stays O(B·z + B·block).
    Sharded use: z/logvar are this rank's rows, mu the gathered bank,
    ``row_offset`` the rows' global start and ``global_batch`` the batch
    whose stratified weights apply. Returns (log prod_l q(z_l) [B],
    log q(z) [B]), the plain version's values up to summation order.
    """
    b_j = z.shape[0]
    b_i = mu.shape[0]
    block = min(block, b_i)
    if b_i % block != 0:  # fall back to any divisor
        block = math.gcd(b_i, block)
    off = 0 if row_offset is None else row_offset
    gb = global_batch or b_j
    m_m = torch.full_like(z, -math.inf)
    s_m = torch.zeros_like(z)
    m_j = torch.full_like(z[:, 0], -math.inf)
    s_j = torch.zeros_like(z[:, 0])
    for c0 in range(0, b_i, block):
        iw = log_importance_weight_block(off, b_j, gb, dataset_size, z.device,
                                         col_off=c0, n_cols=block)
        m_m, s_m, m_j, s_j = checkpoint(_online_block, m_m, s_m, m_j, s_j, z,
                                        mu[c0:c0 + block], logvar, iw,
                                        use_reentrant=False)
    return (torch.log(s_m) + m_m).sum(dim=1), torch.log(s_j) + m_j


def total_correlation_sharded(
    z: torch.Tensor,
    mu: torch.Tensor,
    logvar: torch.Tensor,
    dataset_size: int,
    mesh,
    reduce: str = "mean",
    impl: str = "blockwise",
) -> torch.Tensor:
    """Global-batch TC over a batch split across the ranks of ``mesh``.

    log N(z_j | mu_i, var_j) couples sample j to the rest of the batch
    only through mu_i, so the cross-rank form is one all-gather of mu
    followed by each rank's rows against the whole bank, weighted by
    global (row, col); the gather's adjoint sums dmu over the ranks
    (``intro_tc_vae_tpu/ops/tc.py:221-280``). 'mean' is the mean over
    the global batch (an all-reduce of the rank sums), the same scalar on
    every rank; 'none' is this rank's [B_local] vector. ``mesh`` is the
    data group: under a model axis the ranks of a model group hold the
    same (replicated) mu and logvar rows and compute the same estimate.
    """
    mu_bank = all_gather_rows(mu, mesh)
    gb = mu_bank.shape[0]
    pm, qz = _logsumexps(impl, z, mu_bank, logvar, dataset_size,
                         row_off=mesh.rank * z.shape[0], global_batch=gb)
    tc = qz - pm
    if reduce == "mean":
        return all_reduce_sum(tc.sum(), mesh) / gb
    return tc
