"""Single-phase ELBO train step (vae / tc solvers).

Counterpart of ``intro_tc_vae_tpu/solvers/vae.py::build_vae_step``: one
forward, loss = scale * (beta_rec * rec_mean + kl_term), gradients for
both networks, an optional global-norm clip over both, two Adam updates.
The one reparameterization draw is the noise entry ``"real"``, drawn
from ``state.generator`` unless it is passed in (the parity tests hand
the JAX step's draw to the port). Under a data group the gradients and
metrics are averaged over the ranks, and under a model axis the norms
count the sharded gradients' slices once (``solvers/base.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from intro_tc_vae_tpu_torch import ops
from intro_tc_vae_tpu_torch.solvers.base import (
    SolverHyper,
    TrainState,
    apply_grads,
    average_grads,
    clip_by_global_norm,
    decode,
    encode,
    global_norm,
    kl_term,
    rec_term,
    shards,
    step_noise,
    tc_decomp_metrics,
)

VAE_NOISE_KEYS = ("real",)


def build_vae_step(h: SolverHyper, encoder, decoder):
    """Build step(state, batch, noise=None) -> metrics, updating in place."""
    enc_params = list(encoder.parameters())
    dec_params = list(decoder.parameters())
    fc_ids = {id(p) for p in encoder.fc.parameters()}
    n_enc = len(enc_params)

    def step(state: TrainState, batch: torch.Tensor,
             noise: Optional[dict] = None) -> dict:
        noise = step_noise(h, state.generator, noise, batch.shape[0], batch.device,
                           VAE_NOISE_KEYS)
        mu, logvar = encode(encoder, batch)
        z = ops.reparameterize(mu, logvar, noise["real"])
        rec = decode(decoder, z)
        loss_rec = rec_term(h, batch, rec, reduction="mean")
        loss_kl, kl_unscaled = kl_term(h, z, mu, logvar)
        loss = h.scale * (loss_rec + loss_kl)

        # one all-reduce for both networks' gradients under a data group
        shard = shards(enc_params + dec_params)
        grads = average_grads(torch.autograd.grad(loss, enc_params + dec_params), h.mesh,
                              shard)
        fc_grad_norm = global_norm([g for g, p in zip(grads, enc_params) if id(p) in fc_ids],
                                   [s for s, p in zip(shard, enc_params) if id(p) in fc_ids])
        metrics = dict(
            loss_enc=loss,
            loss_dec=loss,
            loss_kl=loss_kl,
            loss_rec=loss_rec,
            kl_loss_unscaled=kl_unscaled,
            r_loss_unscaled=loss_rec / max(h.beta_rec, 1e-12),
            fc_grad_norm=fc_grad_norm,
        )
        if h.kl_kind == "tc_full":
            metrics.update(tc_decomp_metrics(h, z, mu, logvar))
        if h.clip:
            grads, total_norm = clip_by_global_norm(grads, h.clip, shard)
            metrics["total_norm"] = total_norm
            metrics["L2"] = total_norm
        apply_grads(state.opt_e, enc_params, grads[:n_enc])
        apply_grads(state.opt_d, dec_params, grads[n_enc:])
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return step
