"""Loss ops: KL, reconstruction, Gaussian densities and the TC estimator."""

from intro_tc_vae_tpu_torch.ops.density import (
    gaussian_log_density,
    gaussian_log_density_nll,
    log_importance_weight_block,
    log_importance_weight_matrix,
    minibatch_stratified_sampling,
)
from intro_tc_vae_tpu_torch.ops.losses import (
    entropy,
    kl_divergence,
    kl_no_reduce,
    reconstruction_loss,
    reparameterize,
)
from intro_tc_vae_tpu_torch.ops.tc import (
    tc_logsumexp_blockwise,
    total_correlation,
    total_correlation_sharded,
)
from intro_tc_vae_tpu_torch.ops.tc_cuda import (
    tc_logsumexp_cuda,
    tc_logsumexp_cuda_gathered,
    tc_logsumexp_reference,
    tc_logsumexp_reference_gathered,
)

__all__ = [
    "gaussian_log_density",
    "gaussian_log_density_nll",
    "log_importance_weight_block",
    "log_importance_weight_matrix",
    "minibatch_stratified_sampling",
    "entropy",
    "kl_divergence",
    "kl_no_reduce",
    "reconstruction_loss",
    "reparameterize",
    "tc_logsumexp_blockwise",
    "total_correlation",
    "total_correlation_sharded",
    "tc_logsumexp_cuda",
    "tc_logsumexp_cuda_gathered",
    "tc_logsumexp_reference",
    "tc_logsumexp_reference_gathered",
]
