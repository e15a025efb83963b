"""Loss ops: KL, reconstruction, Gaussian densities and the TC estimator."""

from intro_tc_vae_tpu_torch.ops.density import (
    gaussian_log_density,
    gaussian_log_density_nll,
    log_importance_weight_matrix,
    minibatch_stratified_sampling,
)
from intro_tc_vae_tpu_torch.ops.losses import (
    kl_divergence,
    kl_no_reduce,
    reconstruction_loss,
    reparameterize,
)
from intro_tc_vae_tpu_torch.ops.tc import total_correlation
from intro_tc_vae_tpu_torch.ops.tc_cuda import (
    tc_logsumexp_cuda,
    tc_logsumexp_reference,
)

__all__ = [
    "gaussian_log_density",
    "gaussian_log_density_nll",
    "log_importance_weight_matrix",
    "minibatch_stratified_sampling",
    "kl_divergence",
    "kl_no_reduce",
    "reconstruction_loss",
    "reparameterize",
    "total_correlation",
    "tc_logsumexp_cuda",
    "tc_logsumexp_reference",
]
