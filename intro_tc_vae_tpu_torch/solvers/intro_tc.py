"""Intro-TC-VAE: the flagship solver — Soft-Intro's two-phase step with
every KL term replaced by the β-TC composition (β-1)·TC + KL.

Counterpart of ``intro_tc_vae_tpu/solvers/intro_tc.py``. All five KL
sites (real, rec, fake in phase E; rec, fake in phase D) run the TC
estimator, so with ``tc_impl: "pallas"`` each step launches each of the
three CUDA TC kernels five times.
"""

from __future__ import annotations

from intro_tc_vae_tpu_torch.solvers.intro import IntroSolver


class IntroTCSolver(IntroSolver):
    kl_kind = "tc"
