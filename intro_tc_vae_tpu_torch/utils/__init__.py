"""Host-side utilities: the weight bridge from the JAX package."""

from intro_tc_vae_tpu_torch.utils.transplant import flax_to_port

__all__ = ["flax_to_port"]
