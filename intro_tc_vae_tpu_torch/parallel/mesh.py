"""The data-parallel mesh: the ranks that split the batch.

Counterpart of the data-parallel part of ``intro_tc_vae_tpu/parallel/
mesh.py``. JAX builds a ('data', 'model') device mesh and lets GSPMD
insert the collectives; here each rank is a process, the mesh is the
process group with this rank's place in it (``DataGroup``), and the code
that reduces over the batch calls the collectives itself
(``parallel/collectives.py``): the TC estimator gathers mu, BatchNorm
sums its statistics, the solvers average gradients and metrics.

Parameters are replicated (``replicate_state``). Tensor parallelism
(``model_parallel > 1``, ``param_spec``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from intro_tc_vae_tpu_torch import not_ported
from intro_tc_vae_tpu_torch.parallel.distributed import (
    process_count,
    process_index,
    rank_device,
    row_block,
)


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """The ranks that split the batch, and this rank's place in them.

    ``group`` is the torch.distributed process group (None: the default
    group, or no group at all when ``size`` is 1).
    """

    group: Optional[dist.ProcessGroup]
    size: int
    rank: int
    device: torch.device


def make_mesh(n_devices: int = 0, model_parallel: int = 1,
              device: Optional[torch.device] = None) -> DataGroup:
    """The data group over all ranks; ``n_devices`` 0 means all of them.

    Each rank is a process, so the group cannot leave a rank out: a size
    other than the number of processes raises. ``device`` is this rank's
    device (default: its card, ``rank_device()``).
    """
    if model_parallel > 1:
        raise not_ported("model_parallel > 1 (tensor parallelism, param_spec)",
                         "Queue 1 item 8")
    world = process_count()
    n = n_devices or world
    if n > world:
        raise ValueError(f"requested {n} devices but only {world} available "
                         "(one per process)")
    if n != world:
        raise ValueError(f"a data group of {n} of the {world} processes: each process "
                         "is one rank and every rank takes part")
    return DataGroup(group=None, size=world, rank=process_index(),
                     device=rank_device() if device is None else torch.device(device))


def batch_sharding(mesh: DataGroup, global_batch: int) -> slice:
    """The rows of the global batch this rank computes on."""
    return row_block(global_batch, mesh.size, mesh.rank)


def state_digest(module: nn.Module) -> str:
    """sha256 of every parameter and buffer, bit for bit."""
    h = hashlib.sha256()
    for name, t in module.state_dict().items():
        h.update(name.encode())
        h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def ranks_agree(module: nn.Module, mesh: DataGroup) -> bool:
    """True when every rank holds bit-equal parameters and buffers."""
    digests = [None] * mesh.size
    dist.all_gather_object(digests, state_digest(module), group=mesh.group)
    return len(set(digests)) == 1


def replicate_state(state, mesh: DataGroup):
    """Give every rank rank 0's parameters and BatchNorm statistics, then
    check that every rank holds the same bits (the counterpart of
    ``shard_state`` for a data-parallel mesh). Returns ``state``."""
    if mesh.size == 1:
        return state
    with torch.no_grad():
        for t in state.model.state_dict().values():
            dist.broadcast(t, src=0, group=mesh.group)
    if not ranks_agree(state.model, mesh):
        raise RuntimeError("ranks hold different parameters after the broadcast")
    return state
