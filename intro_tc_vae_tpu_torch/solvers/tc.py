"""β-TC-VAE solver: the single-phase ELBO step with the total-correlation
KL composition (β-1)·TC + KL.

Counterpart of ``intro_tc_vae_tpu/solvers/tc.py``. With ``tc_impl:
"pallas"`` each step launches each of the three CUDA TC kernels once.
"""

from __future__ import annotations

from intro_tc_vae_tpu_torch.solvers.base import VAESolver


class TCSolver(VAESolver):
    """β-TC-VAE (single-phase ELBO step, TC-augmented KL)."""

    kl_kind = "tc"


# The reference spells it 'TCSovler' (its solvers/tc.py:22); the JAX
# package keeps the alias, and so does the port.
TCSovler = TCSolver
