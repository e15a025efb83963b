"""Gaussian log densities and minibatch stratified and weighted sampling
for the β-TC-VAE total-correlation estimator.

Counterpart of ``intro_tc_vae_tpu/ops/density.py``, with its two
deliberate quirks of the reference: the variance floor 1e-4 (of
``F.gaussian_nll_loss``) with the ``max(log_prob, -50)`` clamp, and the
column-structured stratified importance-weight matrix.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

LOG_2PI = math.log(2.0 * math.pi)
LOG_PROB_FLOOR = -50.0
VAR_FLOOR = 1e-4


def gaussian_log_density_nll(x: torch.Tensor, mu: torch.Tensor,
                             logvar: torch.Tensor) -> torch.Tensor:
    """log N(x | mu, exp(logvar)), variance floored at 1e-4, result
    clamped at -50. ``torch.clamp`` passes no gradient where it clamps."""
    var = torch.clamp(torch.exp(logvar), min=VAR_FLOOR)
    log_prob = -0.5 * (torch.log(var) + (x - mu) ** 2 / var + LOG_2PI)
    return torch.clamp(log_prob, min=LOG_PROB_FLOOR)


def gaussian_log_density(x: torch.Tensor, mu: torch.Tensor,
                         logvar: torch.Tensor) -> torch.Tensor:
    """Plain Gaussian log density (no variance floor), clamped at -50."""
    inv_sigma = torch.exp(-logvar)
    tmp = x - mu
    log_prob = -0.5 * (tmp * tmp * inv_sigma + logvar + LOG_2PI)
    return torch.clamp(log_prob, min=LOG_PROB_FLOOR)


@functools.lru_cache(maxsize=64)
def _log_importance_weight_matrix_np(batch_size: int, dataset_size: int) -> np.ndarray:
    """The stratified-sampling log-weight matrix, built once per (B, N).

    With M = B-1 the reference's flat stride M+1 == B walks down a
    *column*, so the matrix is column-structured:

        W[:, 0]   = 1/N        (except W[M-1, 0] = strat_weight)
        W[:, 1]   = strat_weight
        W[:, 2:]  = 1/M
    """
    n = float(dataset_size)
    m = batch_size - 1
    strat_weight = (n - m) / (n * m)
    w = np.full((batch_size, batch_size), 1.0 / m, dtype=np.float64)
    flat = w.reshape(-1)
    flat[:: m + 1] = 1.0 / n
    flat[1 :: m + 1] = strat_weight
    w[m - 1, 0] = strat_weight
    out = np.log(w).astype(np.float32)
    out.flags.writeable = False  # shared by every caller through the cache
    return out


@functools.lru_cache(maxsize=64)
def log_importance_weight_matrix(batch_size: int, dataset_size: int,
                                 device: torch.device) -> torch.Tensor:
    """[B, B] log importance weights on ``device``, cached per (B, N, device)
    so the step pays no host->device copy for them."""
    w = _log_importance_weight_matrix_np(int(batch_size), int(dataset_size))
    return torch.tensor(w, device=device)


def log_importance_weight_block(row_off: int, n_rows: int, global_batch: int,
                                dataset_size: int, device: torch.device,
                                col_off: int = 0, n_cols: Optional[int] = None
                                ) -> torch.Tensor:
    """Rows [row_off, row_off + n_rows) and columns [col_off, col_off +
    n_cols) (default: all ``global_batch``) of the [GB, GB] log-weight
    matrix, float32, generated from the global row and column indices
    without the [GB, GB] matrix: the plain counterpart of ``_iw_block``
    with ``row_off`` (intro_tc_vae_tpu/ops/tc_pallas.py:91) and of the
    blockwise weights (intro_tc_vae_tpu/ops/tc.py:158-170). A rank of a
    data-parallel batch owns the rows of its samples and every column."""
    n_cols = global_batch if n_cols is None else n_cols
    n = float(dataset_size)
    m = global_batch - 1
    full = functools.partial(torch.full, (n_rows, n_cols), dtype=torch.float32,
                             device=device)
    rows = torch.arange(row_off, row_off + n_rows, device=device)[:, None]
    cols = torch.arange(col_off, col_off + n_cols, device=device)[None, :]
    logstrat = full(math.log((n - m) / (n * m)))
    col0 = torch.where(rows == m - 1, logstrat, full(math.log(1.0 / n)))
    iw = torch.where(cols == 0, col0, full(math.log(1.0 / m)))
    return torch.where(cols == 1, logstrat, iw)


def minibatch_stratified_sampling(log_qz_prob: torch.Tensor, batch_size: int,
                                  dataset_size: int):
    """(log prod_l q(z_l), log q(z)) from the [B, B, z] tensor of
    log q(z(x_j)_l | x_i), indexed [j, i, l]."""
    log_iw = log_importance_weight_matrix(batch_size, dataset_size,
                                          log_qz_prob.device)
    logqz_prodmarginals = torch.logsumexp(
        log_iw[:, :, None] + log_qz_prob, dim=1
    ).sum(dim=1)
    log_qz = torch.logsumexp(log_iw + log_qz_prob.sum(dim=2), dim=1)
    return logqz_prodmarginals, log_qz


def minibatch_weighted_sampling(log_qz_prob: torch.Tensor, batch_size: int,
                                dataset_size: int):
    """Minibatch-weighted (log prod_l q(z_l), log q(z)) from the same
    [B, B, z] tensor (reference ops.py:92-101; JAX ops/density.py:89)."""
    log_bn = math.log(batch_size * dataset_size)
    logqz_prodmarginals = (torch.logsumexp(log_qz_prob, dim=1) - log_bn).sum(dim=1)
    log_qz = torch.logsumexp(log_qz_prob.sum(dim=2), dim=1) - log_bn
    return logqz_prodmarginals, log_qz
