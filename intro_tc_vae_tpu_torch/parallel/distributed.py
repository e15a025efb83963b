"""Process-group start-up for data- and tensor-parallel training.

Counterpart of ``intro_tc_vae_tpu/parallel/distributed.py``. Each rank is
one process; a user starts R of them, either with ``torchrun
--nproc_per_node R -m intro_tc_vae_tpu_torch.main ...`` or with the
environment the JAX package reads: ``ITCVAE_COORDINATOR_ADDRESS``
(host:port of rank 0) plus the standard ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``. ``initialize_distributed()`` is a no-op in a single
process.

The backend rule, stated once (``backend_for``): ``nccl`` when every
rank of a host has a card of its own, ``gloo`` when ranks share a card
(NCCL refuses two ranks on one device) or there is none. A backend that
fails to initialise raises; nothing falls back to the other one. Each
rank trains on ``cuda:(LOCAL_RANK % device_count)`` and its tensors stay
on the card under either backend: gloo copies them through the host for
each collective.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

COORDINATOR_ENV = "ITCVAE_COORDINATOR_ADDRESS"


def backend_for(ranks_per_host: int, cards_per_host: int) -> tuple:
    """(backend, reason): the one place the backend is chosen."""
    if cards_per_host == 0:
        return "gloo", "no CUDA device"
    if ranks_per_host <= cards_per_host:
        return "nccl", f"{ranks_per_host} rank(s) per host, one card each"
    return "gloo", f"{ranks_per_host} ranks share {cards_per_host} card(s)"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join the process group from args or the environment.

    Returns True when this process is one rank of several (also when the
    group already exists), False for a single process, which needs
    nothing. torchrun's ``MASTER_ADDR``/``MASTER_PORT`` stand in for the
    coordinator address when it is not given. Without
    ``LOCAL_WORLD_SIZE`` (torchrun sets it) all ranks are taken to run on
    one host.
    """
    if dist.is_initialized():
        return True
    address = coordinator_address or os.environ.get(COORDINATOR_ENV)
    if address is None and "MASTER_ADDR" in os.environ:
        address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    world = num_processes if num_processes is not None else int(os.environ.get("WORLD_SIZE", "1"))
    if address is None or world <= 1:
        return False
    if process_id is None and "RANK" not in os.environ:
        raise ValueError(f"{world} processes but RANK is not set: give each process its "
                         "rank (RANK, and LOCAL_RANK on a host of several)")
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    backend, why = backend_for(int(os.environ.get("LOCAL_WORLD_SIZE", world)), cards)
    if backend == "nccl":
        torch.cuda.set_device(rank_device())
    dist.init_process_group(backend, init_method=f"tcp://{address}", rank=rank,
                            world_size=world)
    if rank == 0:
        print(f"distributed: {world} ranks, backend {backend} ({why})")
    return True


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", process_index()))


def rank_device() -> torch.device:
    """This rank's card, ``cuda:(LOCAL_RANK % device_count)``; raises when
    CUDA is absent (no rank runs on the CPU unless told to)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "intro_tc_vae_tpu_torch trains on a CUDA device and none is "
            "available; pass device=torch.device('cpu') explicitly to run "
            "the plain PyTorch versions on the CPU"
        )
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def row_block(global_batch: int, parts: int, index: int) -> slice:
    """Block ``index`` of ``parts`` equal contiguous row blocks."""
    if global_batch % parts != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by {parts} processes — "
            f"per-process rows would not tile the global batch"
        )
    per = global_batch // parts
    return slice(index * per, (index + 1) * per)


def local_batch_slice(global_batch: int) -> slice:
    """The [start, stop) rows of the global batch this process feeds
    (uniform split by process index)."""
    return row_block(global_batch, process_count(), process_index())
