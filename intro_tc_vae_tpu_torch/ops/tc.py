"""Total-correlation estimator of β-TC-VAE.

Counterpart of ``intro_tc_vae_tpu/ops/tc.py``. The minibatch TC estimate
needs the [B, B, z] tensor of pairwise latent log densities
log q(z(x_j)_l | x_i) and two logsumexp reductions over i:

* ``impl='xla'``    — the plain materialized [B, B, z] path in PyTorch ops
  (``tc_logsumexp_reference``).
* ``impl='pallas'`` — the fused CUDA kernels (``tc_logsumexp_cuda``), which
  never write the [B, B, z] tensor; the name is the JAX package's config
  value.

Indexing quirk kept from the as-executed reference: entry [j, i, l] is
log N(z_j | mu_i, var_j) — the *sample's* variance, not the
distribution's.
"""

from __future__ import annotations

import torch

from intro_tc_vae_tpu_torch import not_ported
from intro_tc_vae_tpu_torch.ops.tc_cuda import (
    tc_logsumexp_cuda,
    tc_logsumexp_reference,
)


def total_correlation(
    z: torch.Tensor,
    mu: torch.Tensor,
    logvar: torch.Tensor,
    dataset_size: int,
    reduce: str = "mean",
    impl: str = "xla",
    sampling: str = "stratified",
) -> torch.Tensor:
    """Minibatch (stratified) estimate of TC(z): E_j[log q(z_j) - log prod_l q(z_jl)].

    Returns a scalar for reduce='mean', else the [B] vector.
    """
    if sampling != "stratified":
        raise not_ported(f"tc_sampling='{sampling}'", "Queue 1 item 6")
    if impl == "pallas":
        log_qz_product, log_qz = tc_logsumexp_cuda(
            z.contiguous(), mu.contiguous(), logvar.contiguous(), dataset_size
        )
    elif impl == "xla":
        log_qz_product, log_qz = tc_logsumexp_reference(z, mu, logvar, dataset_size)
    elif impl == "blockwise":
        raise not_ported("tc_impl='blockwise'", "Queue 1 item 6")
    else:
        raise ValueError(f"tc_impl={impl!r}: expected 'xla', 'blockwise' or 'pallas'")

    tc = log_qz - log_qz_product
    if reduce == "mean":
        return tc.mean()
    return tc
