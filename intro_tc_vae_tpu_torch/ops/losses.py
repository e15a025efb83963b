"""Core VAE loss primitives (KL, reconstruction, reparameterization).

Counterpart of ``intro_tc_vae_tpu/ops/losses.py`` with the same
semantics: per-sample sums over latent/pixel axes followed by the
requested batch reduction.
"""

from __future__ import annotations

import torch


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                   eps: torch.Tensor) -> torch.Tensor:
    """z = mu + exp(0.5*logvar) * eps.

    The noise ``eps`` ~ N(0, I) is passed in: torch and JAX draw different
    numbers from the same seed, so the caller owns the generator (and the
    parity tests hand both packages the same draws).
    """
    return mu + eps * torch.exp(0.5 * logvar)


def kl_no_reduce(logvar: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Per-sample KL(q(z|x) || N(0, I)), summed over the latent axis.
    Argument order (logvar, mu) as in the reference."""
    return -0.5 * torch.sum(1.0 + logvar - torch.exp(logvar) - mu * mu, dim=1)


def kl_divergence(logvar: torch.Tensor, mu: torch.Tensor,
                  reduce: str = "sum") -> torch.Tensor:
    """KL divergence with 'sum' | 'mean' | 'none' batch reduction."""
    kl = kl_no_reduce(logvar, mu)
    if reduce == "sum":
        return kl.sum()
    if reduce == "mean":
        return kl.mean()
    return kl


def reconstruction_loss(
    x: torch.Tensor,
    recon_x: torch.Tensor,
    loss_type: str = "mse",
    reduction: str = "sum",
) -> torch.Tensor:
    """Per-pixel error summed per sample, then reduced.

    The target ``x`` is detached. loss_type: 'mse', 'l1' or 'bce' (binary
    cross-entropy on probabilities, log terms clamped at -100 like
    ``F.binary_cross_entropy``).
    """
    if reduction not in ("sum", "mean", "none"):
        raise NotImplementedError(f"reduction '{reduction}' not supported")

    batch = recon_x.shape[0]
    recon_flat = recon_x.reshape(batch, -1)
    x_flat = x.detach().reshape(batch, -1)

    if loss_type == "mse":
        err = (recon_flat - x_flat) ** 2
    elif loss_type == "l1":
        err = (recon_flat - x_flat).abs()
    elif loss_type == "bce":
        log_p = torch.clamp(torch.log(recon_flat), min=-100.0)
        log_1mp = torch.clamp(torch.log1p(-recon_flat), min=-100.0)
        err = -(x_flat * log_p + (1.0 - x_flat) * log_1mp)
    else:
        raise NotImplementedError(f"loss_type '{loss_type}' not supported")

    per_sample = err.sum(dim=1)
    if reduction == "sum":
        return per_sample.sum()
    if reduction == "mean":
        return per_sample.mean()
    return per_sample
