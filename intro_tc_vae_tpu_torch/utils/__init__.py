"""Host-side utilities: checkpoints, loss averaging, non-finite checks,
profiling, and the weight bridge from the JAX package."""

from intro_tc_vae_tpu_torch.utils.checkpoint import (
    find_latest_checkpoint,
    finalize_checkpoints,
    load_checkpoint,
    load_model,
    save_checkpoint,
    save_losses,
)
from intro_tc_vae_tpu_torch.utils.lossdict import LossDict
from intro_tc_vae_tpu_torch.utils.nan import check_non_finite_gradients, check_non_finite_gradints
from intro_tc_vae_tpu_torch.utils.profiling import StepTimer, profile_trace
from intro_tc_vae_tpu_torch.utils.transplant import flax_to_port

__all__ = [
    "LossDict",
    "save_checkpoint",
    "load_checkpoint",
    "load_model",
    "find_latest_checkpoint",
    "finalize_checkpoints",
    "save_losses",
    "check_non_finite_gradients",
    "check_non_finite_gradints",
    "profile_trace",
    "StepTimer",
    "flax_to_port",
]
