"""Data parallelism: process-group start-up, the data group (mesh) and
the differentiable collectives the batch reductions call."""

from intro_tc_vae_tpu_torch.parallel.collectives import (
    all_gather_rows,
    all_reduce_mean_,
    all_reduce_sum,
)
from intro_tc_vae_tpu_torch.parallel.distributed import (
    backend_for,
    initialize_distributed,
    local_batch_slice,
    shutdown_distributed,
)
from intro_tc_vae_tpu_torch.parallel.mesh import (
    DataGroup,
    batch_sharding,
    make_mesh,
    ranks_agree,
    replicate_state,
    state_digest,
)

__all__ = [
    "all_gather_rows",
    "all_reduce_mean_",
    "all_reduce_sum",
    "backend_for",
    "initialize_distributed",
    "local_batch_slice",
    "shutdown_distributed",
    "DataGroup",
    "batch_sharding",
    "make_mesh",
    "ranks_agree",
    "replicate_state",
    "state_digest",
]
