"""The ('data', 'model') mesh of ranks, and the tensor-parallel layout of
the state.

Counterpart of ``intro_tc_vae_tpu/parallel/mesh.py``. JAX builds a
('data', 'model') device mesh and lets GSPMD insert the collectives; here
each rank is a process, the mesh is this rank's place in two families of
process groups, and the code that reduces over an axis calls the
collectives itself (``parallel/collectives.py``).

Rank r of R sits at data index ``r // M`` and model index ``r % M`` (M =
``model_parallel``), as JAX's ``np.asarray(devices).reshape(n // mp, mp)``
lays the devices out. ``make_mesh`` returns this rank's ``DataGroup``:
the ranks with its model index, which split the batch (``size`` and
``rank`` are the data axis, as they were before the model axis existed),
and, for M > 1, its ``ModelGroup`` (``mesh.model``): the M ranks of its
data index, which hold the same rows and split the wide leaves.

Data axis: parameters replicated (``replicate_state``); the TC gathers
mu, BatchNorm sums its statistics, the solvers average gradients and
metrics over the data group.

Model axis (tensor parallelism): ``param_spec`` states JAX's partition
rules on this port's names and layouts, and ``shard_state`` replaces each
sharded parameter's data and each sharded buffer by this rank's
contiguous slice. The models compute with the slices
(``models/blocks.py``); ``gather_state`` and ``gather_optimizer_state``
give whole tensors back (checkpoints, the writer's eval copy) and
``shard_state_dict`` / ``shard_optimizer_state_dict`` slice whole ones.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch import nn

from intro_tc_vae_tpu_torch.parallel.collectives import all_gather_cat
from intro_tc_vae_tpu_torch.parallel.distributed import (
    process_count,
    process_index,
    rank_device,
    row_block,
)


@dataclasses.dataclass(frozen=True)
class ModelGroup:
    """The ranks of one data index, which split the sharded leaves:
    ``rank`` is this rank's model index, its slice of every sharded leaf."""

    group: Optional[dist.ProcessGroup]
    size: int
    rank: int


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """The ranks that split the batch, and this rank's place in them.

    ``group`` is the torch.distributed process group (None: the default
    group, or no group at all when ``size`` is 1). ``model`` is this
    rank's model group when the mesh has a model axis of more than one
    rank, else None.
    """

    group: Optional[dist.ProcessGroup]
    size: int
    rank: int
    device: torch.device
    model: Optional[ModelGroup] = None


@dataclasses.dataclass(frozen=True)
class Shard:
    """How a parameter is sharded: along ``dim`` over ``group``
    (set on the parameter as ``tp`` by ``shard_state``)."""

    dim: int
    group: ModelGroup


def make_mesh(n_devices: int = 0, model_parallel: int = 1,
              device: Optional[torch.device] = None) -> DataGroup:
    """This rank's place in the ('data', 'model') mesh over all ranks;
    ``n_devices`` 0 means all of them.

    Each rank is a process, so the mesh cannot leave a rank out: a size
    other than the number of processes raises. ``device`` is this rank's
    device (default: its card, ``rank_device()``). With ``model_parallel``
    M > 1 every rank creates every group (``dist.new_group``), the model
    groups first, in one order; M = 1 creates none.
    """
    world = process_count()
    n = n_devices or world
    if n > world:
        raise ValueError(f"requested {n} devices but only {world} available "
                         "(one per process)")
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    if n != world:
        raise ValueError(f"a mesh of {n} of the {world} processes: each process "
                         "is one rank and every rank takes part")
    device = rank_device() if device is None else torch.device(device)
    rank = process_index()
    if model_parallel == 1:
        return DataGroup(group=None, size=world, rank=rank, device=device)
    mp, n_data = model_parallel, n // model_parallel
    model = data = None
    for d in range(n_data):
        ranks = [d * mp + m for m in range(mp)]
        group = dist.new_group(ranks)
        if rank in ranks:
            model = ModelGroup(group=group, size=mp, rank=rank % mp)
    for m in range(mp):
        ranks = [d * mp + m for d in range(n_data)]
        group = dist.new_group(ranks)
        if rank in ranks:
            data = group
    return DataGroup(group=data, size=n_data, rank=rank // mp, device=device, model=model)


def model_size(mesh: Optional[DataGroup]) -> int:
    """The size of the mesh's model axis (1 without one)."""
    return 1 if mesh is None or mesh.model is None else mesh.model.size


def batch_sharding(mesh: DataGroup, global_batch: int) -> slice:
    """The rows of the global batch this rank computes on: its data
    index's block (the ranks of a model group get the same rows)."""
    return row_block(global_batch, mesh.size, mesh.rank)


def param_spec(name: str, shape, mesh: Optional[DataGroup], min_dim: int = 256) -> Optional[int]:
    """The dim along which one state leaf is sharded over the model axis,
    or None for a replicated leaf: JAX ``param_spec``'s rules
    (``intro_tc_vae_tpu/parallel/mesh.py:56-86``) on this port's layouts.

    * conv weights [out, in, kh, kw] (JAX [kh, kw, in, out]): the output
      channels when wide enough;
    * ``Linear`` weights [out, in] (JAX kernels [in, out]): JAX shards the
      widest divisible axis, out on a tie, so dim 0 when out >= in, else
      dim 1 (the encoder fc [2z, h w c] is cut along its input features,
      the decoder fc [h w c, z] along its outputs);
    * per-channel vectors (biases, BatchNorm weight, bias and running
      statistics): when wide enough.

    "Wide enough" is at least ``min_dim`` and divisible by the model axis.
    Optimizer moments have their parameter's shape and follow it.
    """
    ms = model_size(mesh)
    if ms == 1:
        return None
    shape = tuple(shape)

    def wide(n: int) -> bool:
        return n >= min_dim and n % ms == 0

    if len(shape) == 4:
        return 0 if wide(shape[0]) else None
    if len(shape) == 2 and name.endswith("weight"):
        ax = int(shape[1] > shape[0])
        return ax if wide(shape[ax]) else None
    if len(shape) == 1 and wide(shape[0]):
        return 0
    return None


def _model(state: Any) -> nn.Module:
    """The model of a TrainState, or the module itself."""
    return getattr(state, "model", state)


def _leaf_owner(model: nn.Module, key: str):
    prefix, _, name = key.rpartition(".")
    return (model.get_submodule(prefix) if prefix else model), name


def sharded_keys(model: nn.Module) -> dict:
    """{state_dict key: (owning module, leaf name, dim)} of every sharded leaf."""
    out = {}
    for prefix, m in model.named_modules():
        for name, d in getattr(m, "tp_dims", {}).items():
            out[f"{prefix}.{name}" if prefix else name] = (m, name, d)
    return out


def shard_state(state, mesh: DataGroup, min_dim: int = 256):
    """Shard a model (or a TrainState's model) over the mesh's model axis,
    in place: every leaf ``param_spec`` shards keeps only this rank's
    contiguous slice, a parameter through its ``.data`` (so it stays the
    same ``nn.Parameter`` and carries ``tp``, a ``Shard``), a buffer by a
    new tensor; each owning module records ``tp_dims`` {leaf: dim}, and
    every module of the model gets ``model_group``. Optimizers must not
    have stepped yet: they then make moments of the shard's size.

    Called on a state every rank holds alike (``replicate_state``). With
    no model axis it changes nothing (the data-parallel mesh replicates).
    Returns ``state``."""
    if model_size(mesh) == 1:
        return state
    model = _model(state)
    if sharded_keys(model):
        raise ValueError("shard_state: the model is sharded already")
    for opt in (getattr(state, "opt_e", None), getattr(state, "opt_d", None)):
        if opt is not None and opt.state:
            raise ValueError("shard_state: an optimizer has stepped; shard the state "
                             "before the first step")
    group = mesh.model
    for key, t in model.state_dict(keep_vars=True).items():
        d = param_spec(key, t.shape, mesh, min_dim)
        if d is None:
            continue
        module, name = _leaf_owner(model, key)
        width = t.shape[d] // group.size
        piece = t.detach().narrow(d, group.rank * width, width).clone()
        if name in module._parameters:
            t.data = piece
            t.tp = Shard(d, group)
        else:
            module._buffers[name] = piece
        module.__dict__.setdefault("tp_dims", {})[name] = d
    for m in model.modules():
        m.model_group = group
    return state


def gather_state(state) -> dict:
    """The model's ``state_dict`` with whole tensors: every sharded leaf
    gathered from the model group (a collective: every rank of the group
    calls it). A model that is not sharded gives its own state_dict."""
    model = _model(state)
    sd = model.state_dict()
    for key, (module, _, d) in sharded_keys(model).items():
        sd[key] = all_gather_cat(sd[key], module.model_group, d)
    return sd


def shard_state_dict(state, whole: dict) -> dict:
    """``whole`` (a state_dict of whole tensors) with every leaf that this
    model shards cut to this rank's slice; what ``load_state_dict`` of the
    sharded model takes."""
    model = _model(state)
    out = dict(whole)
    for key, (module, _, d) in sharded_keys(model).items():
        group = module.model_group
        width = out[key].shape[d] // group.size
        out[key] = out[key].narrow(d, group.rank * width, width).contiguous()
    return out


def _opt_params(opt: torch.optim.Optimizer) -> list:
    return [p for g in opt.param_groups for p in g["params"]]


def gather_optimizer_state(opt: torch.optim.Optimizer) -> dict:
    """The optimizer's ``state_dict`` with every moment of a sharded
    parameter (a tensor of the parameter's shape) gathered whole from the
    model group (a collective); other entries (steps) as they are."""
    sd = opt.state_dict()
    state = dict(sd["state"])
    for i, p in enumerate(_opt_params(opt)):
        shard = getattr(p, "tp", None)
        if shard is None or i not in state:
            continue
        state[i] = {k: all_gather_cat(v, shard.group, shard.dim)
                    if torch.is_tensor(v) and v.dim() > 0 and v.shape == p.shape else v
                    for k, v in state[i].items()}
    return {**sd, "state": state}


def shard_optimizer_state_dict(opt: torch.optim.Optimizer, whole: dict) -> dict:
    """A whole optimizer ``state_dict`` cut to this rank's slices of the
    sharded parameters' moments."""
    state = dict(whole["state"])
    for i, p in enumerate(_opt_params(opt)):
        shard = getattr(p, "tp", None)
        if shard is None or i not in state:
            continue
        full = list(p.shape)
        full[shard.dim] *= shard.group.size
        lo = shard.group.rank * p.shape[shard.dim]
        state[i] = {k: v.narrow(shard.dim, lo, p.shape[shard.dim]).contiguous()
                    if torch.is_tensor(v) and list(v.shape) == full else v
                    for k, v in state[i].items()}
    return {**whole, "state": state}


def whole_copy(model: nn.Module) -> nn.Module:
    """A copy of a sharded model with whole leaves, no model group and no
    data group: every rank of the model group calls it (it gathers), and
    the copy runs alone on any of them (the writer's eval passes on rank
    0). A model that is not sharded is returned as it is."""
    keys = sharded_keys(model)
    if not keys:
        return model
    whole = gather_state(model)
    groups = {id(g): g for m in model.modules()
              for g in (getattr(m, "model_group", None), getattr(m, "data_group", None))
              if g is not None}
    out = copy.deepcopy(model, memo=dict(groups))
    for key in keys:
        module, name = _leaf_owner(out, key)
        if name in module._parameters:
            old = module._parameters[name]
            module._parameters[name] = nn.Parameter(whole[key].to(old.device),
                                                    requires_grad=old.requires_grad)
        else:
            module._buffers[name] = whole[key].to(module._buffers[name].device)
    for m in out.modules():
        m.__dict__.pop("tp_dims", None)
        m.model_group = None
        if hasattr(m, "data_group"):
            m.data_group = None
    return out


def state_digest(module: nn.Module, replicated_only: bool = False) -> str:
    """sha256 of every parameter and buffer (with ``replicated_only``, of
    every leaf the model axis does not shard), bit for bit."""
    skip = set(sharded_keys(module)) if replicated_only else set()
    h = hashlib.sha256()
    for name, t in module.state_dict().items():
        if name in skip:
            continue
        h.update(name.encode())
        h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def ranks_agree(module: nn.Module, mesh: Optional[DataGroup], replicated_only: bool = False
                ) -> bool:
    """True when every rank of ``mesh``'s data group (every rank of the
    job for ``mesh`` None) holds bit-equal parameters and buffers (with
    ``replicated_only``, bit-equal replicated leaves)."""
    group = None if mesh is None else mesh.group
    size = dist.get_world_size(group)
    digests = [None] * size
    dist.all_gather_object(digests, state_digest(module, replicated_only), group=group)
    return len(set(digests)) == 1


def replicate_state(state, mesh: DataGroup):
    """Give every rank of the job rank 0's parameters and BatchNorm
    statistics, then check that every rank holds the same bits (for a
    data-parallel mesh the counterpart of ``shard_state``; with a model
    axis it comes first, and ``shard_state`` cuts the replicated state).
    Returns ``state``."""
    if mesh.size * model_size(mesh) == 1:
        return state
    model = _model(state)
    if sharded_keys(model):
        raise ValueError("replicate_state: the model is sharded; replicate it first")
    with torch.no_grad():
        for t in model.state_dict().values():
            dist.broadcast(t, src=0)
    if not ranks_agree(model, None):
        raise RuntimeError("ranks hold different parameters after the broadcast")
    return state
