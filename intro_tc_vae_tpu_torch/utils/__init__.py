"""Host-side utilities: checkpoints, loss averaging, non-finite checks,
profiling, the flight recorder (``utils.tracing``), the TensorBoard writer
(the reader is ``utils.tb_reader``), and the weight bridges from the JAX
package and from reference checkpoints."""

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
from intro_tc_vae_tpu_torch.utils.profiling import profile_trace
from intro_tc_vae_tpu_torch.utils.transplant import flax_to_port, load_torch_checkpoint
from intro_tc_vae_tpu_torch.utils.writer import SingletonWriter, make_writer

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
    "flax_to_port",
    "load_torch_checkpoint",
    "SingletonWriter",
    "make_writer",
]
