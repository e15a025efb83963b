"""Soft-Intro two-phase adversarial train step.

Counterpart of ``intro_tc_vae_tpu/solvers/intro.py::build_intro_step``.
Phase E differentiates the loss with respect to the encoder's parameters
only (``torch.autograd.grad``); gradients still flow *through* the
decoder's activations. Adam updates the encoder in place, so phase D runs
with the encoder phase E just updated, as the JAX step does. Each phase
runs with the other network ``frozen`` (its parameters not requiring
grad), which changes no value: the conv kernels' autograd then launches
no weight-gradient kernel for the network the phase does not update, as
XLA drops those dead gradients in the JAX step.

BatchNorm running statistics update in place on every train-mode pass —
including the detached/fake passes — so each pass runs exactly once, in
the JAX step's order:

  phase E: dec(noise), enc(real), dec(z), enc(rec'), dec(z_rec),
           enc(fake'), dec(z_fake)
  phase D: dec(noise), dec(z'), enc(rec), enc(fake), dec(z_rec'),
           dec(z_fake')

(' = detached). paired=True batches each phase's independent passes of
one network into one call of twice the batch with per-group BatchNorm
statistics (GroupedBatchNorm), which gives every sample the statistics
it would see in the sequential order above.

remat_passes=True (config ``remat: "pass"``; JAX solvers/intro.py:62-78)
recomputes every encode/decode pass in its phase's backward
(``models.blocks.remat``): only the passes' inputs and outputs are kept.
The recompute updates no BatchNorm statistic, draws no noise, and runs
inside the phase's ``frozen`` block like the forward.
"""

from __future__ import annotations

from typing import Optional

import torch

from intro_tc_vae_tpu_torch import ops
from intro_tc_vae_tpu_torch.models.blocks import remat
from intro_tc_vae_tpu_torch.solvers.base import (
    SolverHyper,
    TrainState,
    VAESolver,
    apply_grads,
    average_grads,
    clip_by_global_norm,
    decode,
    encode,
    frozen,
    global_norm,
    kl_term,
    rec_term,
    shards,
    step_noise,
    tc_decomp_metrics,
)


def build_intro_step(h: SolverHyper, encoder, decoder, paired: bool = True,
                     remat_passes: bool = False):
    """Build the two-phase step(state, batch, noise=None) -> metrics.

    ``noise`` maps each of ``NOISE_KEYS`` to a [B, z] N(0, I) draw of the
    global batch; when it is None the step draws them from
    ``state.generator``. Under a data group (``h.mesh``) the batch is
    this rank's rows, the step takes its rows of the noise, and each
    phase's gradients are averaged over the ranks before the clip. Under
    a model axis the sharded parameters' gradients are this rank's slices
    (``average_grads``, ``global_norm`` count them once).
    """
    enc_p, dec_p = encode, decode
    if remat_passes:
        def enc_p(encoder, x, groups=1):
            return remat(encoder, encoder, x, groups)

        def dec_p(decoder, z, groups=1):
            return remat(decoder, decoder, z, groups)
    enc_params = list(encoder.parameters())
    dec_params = list(decoder.parameters())
    fc_ids = {id(p) for p in encoder.fc.parameters()}
    is_fc = [id(p) in fc_ids for p in enc_params]

    def step(state: TrainState, batch: torch.Tensor,
             noise: Optional[dict] = None) -> dict:
        noise = step_noise(h, state.generator, noise, batch.shape[0], batch.device)
        prior = noise["prior"]

        # ================= Phase E: update encoder =======================
        # only the encoder is differentiated: no decoder weight gradient
        with frozen(decoder):
            if paired:
                mu, logvar = enc_p(encoder, batch)
                z = ops.reparameterize(mu, logvar, noise["real"])
                # decoder pass-group order (noise, z) == dec(noise) ... dec(z)
                fake, rec = dec_p(decoder, torch.cat([prior, z]), groups=2).chunk(2)

                loss_rec = rec_term(h, batch, rec, reduction="mean")
                lossE_real_kl, kl_unscaled = kl_term(h, z, mu, logvar)

                mus, logvars = enc_p(encoder, torch.cat([rec, fake]).detach(), groups=2)
                rec_mu, fake_mu = mus.chunk(2)
                rec_logvar, fake_logvar = logvars.chunk(2)
                z_rec = ops.reparameterize(rec_mu, rec_logvar, noise["rec_e"])
                z_fake = ops.reparameterize(fake_mu, fake_logvar, noise["fake_e"])
                rec_rec, rec_fake = dec_p(decoder, torch.cat([z_rec, z_fake]),
                                           groups=2).chunk(2)
            else:
                fake = dec_p(decoder, prior)

                mu, logvar = enc_p(encoder, batch)
                z = ops.reparameterize(mu, logvar, noise["real"])
                rec = dec_p(decoder, z)

                loss_rec = rec_term(h, batch, rec, reduction="mean")
                lossE_real_kl, kl_unscaled = kl_term(h, z, mu, logvar)

                rec_mu, rec_logvar = enc_p(encoder, rec.detach())
                z_rec = ops.reparameterize(rec_mu, rec_logvar, noise["rec_e"])
                rec_rec = dec_p(decoder, z_rec)

                fake_mu, fake_logvar = enc_p(encoder, fake.detach())
                z_fake = ops.reparameterize(fake_mu, fake_logvar, noise["fake_e"])
                rec_fake = dec_p(decoder, z_fake)

            kl_rec, _ = kl_term(h, z_rec, rec_mu, rec_logvar, reduce="none", beta=h.beta_neg)
            kl_fake, _ = kl_term(h, z_fake, fake_mu, fake_logvar, reduce="none",
                                 beta=h.beta_neg)
            rec_rec_e = rec_term(h, rec, rec_rec, reduction="none")
            rec_fake_e = rec_term(h, fake, rec_fake, reduction="none")
            expelbo_rec = torch.exp(-2.0 * h.scale * (rec_rec_e + kl_rec)).mean()
            expelbo_fake = torch.exp(-2.0 * h.scale * (rec_fake_e + kl_fake)).mean()

            lossE = (h.scale * (loss_rec + lossE_real_kl)
                     + 0.25 * (expelbo_rec + expelbo_fake))
            shard_e = shards(enc_params)
            grads_e = average_grads(torch.autograd.grad(lossE, enc_params), h.mesh, shard_e)
        # the real batch's KL site (JAX solvers/intro.py:154-155)
        decomp = tc_decomp_metrics(h, z, mu, logvar) if h.kl_kind == "tc_full" else {}
        fc_grad_norm = global_norm([g for g, f in zip(grads_e, is_fc) if f],
                                   [s for s, f in zip(shard_e, is_fc) if f])
        total_norm_e = None
        if h.clip:
            grads_e, total_norm_e = clip_by_global_norm(grads_e, h.clip, shard_e)
        apply_grads(state.opt_e, enc_params, grads_e)

        # ================= Phase D: update decoder =======================
        # only the decoder is differentiated: no encoder weight gradient
        with frozen(encoder):
            z_detached = z.detach()
            if paired:
                fake, rec = dec_p(decoder, torch.cat([prior, z_detached]), groups=2).chunk(2)
                loss_rec_d = rec_term(h, batch, rec, reduction="mean")

                # encoder pass-group order (rec, fake) == enc(rec) ... enc(fake)
                mus, logvars = enc_p(encoder, torch.cat([rec, fake]), groups=2)
                rec_mu, fake_mu = mus.chunk(2)
                rec_logvar, fake_logvar = logvars.chunk(2)
                z_rec = ops.reparameterize(rec_mu, rec_logvar, noise["rec_d"])
                z_fake = ops.reparameterize(fake_mu, fake_logvar, noise["fake_d"])
                rec_rec, rec_fake = dec_p(decoder, torch.cat([z_rec, z_fake]).detach(),
                                           groups=2).chunk(2)
            else:
                fake = dec_p(decoder, prior)
                rec = dec_p(decoder, z_detached)
                loss_rec_d = rec_term(h, batch, rec, reduction="mean")

                rec_mu, rec_logvar = enc_p(encoder, rec)
                z_rec = ops.reparameterize(rec_mu, rec_logvar, noise["rec_d"])
                fake_mu, fake_logvar = enc_p(encoder, fake)
                z_fake = ops.reparameterize(fake_mu, fake_logvar, noise["fake_d"])

                rec_rec = dec_p(decoder, z_rec.detach())
                rec_fake = dec_p(decoder, z_fake.detach())

            beta_rr = h.gamma_r * h.beta_rec
            loss_rec_rec = rec_term(h, rec.detach(), rec_rec, reduction="mean", beta=beta_rr)
            loss_fake_rec = rec_term(h, fake.detach(), rec_fake, reduction="mean", beta=beta_rr)
            lossD_rec_kl, _ = kl_term(h, z_rec, rec_mu, rec_logvar)
            lossD_fake_kl, _ = kl_term(h, z_fake, fake_mu, fake_logvar)

            lossD = h.scale * (
                loss_rec_d
                + 0.5 * (lossD_rec_kl + lossD_fake_kl)
                + 0.5 * (loss_rec_rec + loss_fake_rec)
            )
            shard_d = shards(dec_params)
            grads_d = average_grads(torch.autograd.grad(lossD, dec_params), h.mesh, shard_d)
        total_norm_d = None
        if h.clip:
            grads_d, total_norm_d = clip_by_global_norm(grads_d, h.clip, shard_d)
        apply_grads(state.opt_d, dec_params, grads_d)
        state.step += 1

        metrics = dict(
            loss_enc=lossE,
            loss_dec=lossD,
            lossE=lossE,
            lossD=lossD,
            loss_kl=lossE_real_kl,
            loss_rec=loss_rec_d,
            kl_loss_unscaled=kl_unscaled,
            r_loss_unscaled=loss_rec_d / max(h.beta_rec, 1e-12),
            expelbo_f=expelbo_fake,
            expelbo_r=expelbo_rec,
            diff_kl=-lossE_real_kl + lossD_fake_kl,
            fc_grad_norm=fc_grad_norm,
        )
        metrics.update(decomp)
        if h.clip:
            metrics["total_norm_E"] = total_norm_e
            metrics["total_norm_D"] = total_norm_d
            metrics["L2"] = torch.maximum(total_norm_e, total_norm_d)
        return {k: v.detach() for k, v in metrics.items()}

    return step


class IntroSolver(VAESolver):
    """Soft-Intro VAE solver (reference solvers/intro.py:17-196)."""

    kl_kind = "gaussian"

    def build_step(self):
        return build_intro_step(self.hyper, self.encoder, self.decoder,
                                paired=self.fuse_passes, remat_passes=self.remat_passes)
