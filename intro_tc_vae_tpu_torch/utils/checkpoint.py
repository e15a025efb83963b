"""Checkpoints with ``torch.save`` / ``torch.load``.

Counterpart of ``intro_tc_vae_tpu/utils/checkpoint.py`` (Orbax there).
A checkpoint is one file, ``{prefix}model_epoch_{E}_iter_{I}`` in the
checkpoint directory (the JAX package's name, so ``resume: "auto"`` ranks
both packages' names alike), holding the encoder's and the decoder's
``state_dict`` (parameters and BatchNorm running statistics), both
optimizers' ``state_dict``, the step and the epoch. It is written under a
temporary name and renamed into place (``os.replace``), so a crash in
mid-write leaves nothing that ``find_latest_checkpoint`` would pick.

No generator state is saved, as in the JAX package: a resumed run draws
fresh noise from the config seed, and its loader reshuffles from the
seed.

``async_save``: the save starts non-blocking device-to-host copies into
pinned buffers, in stream order behind the step that made the state,
and one background thread waits on a CUDA event recorded after them,
then writes. The next save, ``load_checkpoint`` and
``finalize_checkpoints()`` each wait for the save in flight. On the CPU
the copies are plain clones, taken before the call returns (the loop
goes on updating the parameters in place).

Data parallel (``group``, a ``parallel.DataGroup`` of several ranks):
rank 0 writes; after a synchronous save every rank passes a barrier, so
the file exists on return. ``load_checkpoint`` first lets rank 0 finish
any save in flight, then a barrier, then every rank loads.

Tensor parallel (``group.model`` set): the ranks of rank 0's model group
gather the sharded parameters, BatchNorm statistics and optimizer
moments (``parallel.gather_state``, ``gather_optimizer_state``; a
collective among them, synchronous also for a background save), and
rank 0 writes the same one-file format with whole tensors, so the file
loads in one process (``sample.py``, ``evaluate.py``) and a one-process
file loads on tensor-parallel ranks. On load every rank cuts its slices
from the whole tensors (``shard_state_dict``,
``shard_optimizer_state_dict``), as JAX restores into a sharded target.
"""

from __future__ import annotations

import os
import pickle
import re
import threading
from typing import Any, Optional

import torch
import torch.distributed as dist

from intro_tc_vae_tpu_torch.parallel.mesh import (
    gather_optimizer_state,
    gather_state,
    shard_optimizer_state_dict,
    shard_state_dict,
)

_in_flight: Optional[threading.Thread] = None
_failure: list = []  # the exception of a background write, raised on the next wait


def _ckpt_path(checkpoint_dir: str, prefix: str, epoch: int, iteration: int) -> str:
    name = f"{prefix}model_epoch_{epoch}_iter_{iteration}"
    return os.path.abspath(os.path.join(checkpoint_dir, name))


def _model(state: Any):
    """The ``SoftIntroVAE`` of a TrainState, or the module itself."""
    return getattr(state, "model", state)


def _host_copy(obj: Any, pinned: bool) -> Any:
    """``obj`` with every tensor copied to the host: into pinned memory
    without blocking (``pinned``, CUDA tensors), else a plain copy."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        if pinned and t.is_cuda:
            out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return out.copy_(t, non_blocking=True)
        return t.to("cpu", copy=True)
    if isinstance(obj, dict):
        return type(obj)((k, _host_copy(v, pinned)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v, pinned) for v in obj)
    return obj


def _parts(state: Any, group) -> dict:
    """The state's four dicts with whole tensors: gathered from the model
    group under tensor parallelism (every rank of the group calls it)."""
    model = _model(state)
    if group is None or group.model is None:
        return {"encoder": model.encoder.state_dict(), "decoder": model.decoder.state_dict(),
                "opt_e": state.opt_e.state_dict(), "opt_d": state.opt_d.state_dict()}
    return {"encoder": gather_state(model.encoder), "decoder": gather_state(model.decoder),
            "opt_e": gather_optimizer_state(state.opt_e),
            "opt_d": gather_optimizer_state(state.opt_d)}


def _payload(parts: dict, state: Any, epoch: int, pinned: bool) -> dict:
    return _host_copy({"epoch": int(epoch), "step": int(state.step), **parts}, pinned)


def _write(payload: dict, path: str) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _write_after(event, payload: dict, path: str) -> None:
    try:
        if event is not None:
            event.synchronize()
        _write(payload, path)
    except Exception as e:  # raised by the next wait, on the loop's thread
        _failure.append(e)


def _is_writer(group) -> bool:
    """Rank 0 of the job."""
    return group is None or (group.rank == 0 and (group.model is None or group.model.rank == 0))


def _gathers(group) -> bool:
    """Whether this rank takes part in gathering the state for a save:
    the writer, and under tensor parallelism the rest of its model group."""
    return _is_writer(group) or (group.model is not None and group.rank == 0)


def _barrier(group) -> None:
    if group is not None and dist.get_world_size() > 1:
        dist.barrier()


def finalize_checkpoints() -> None:
    """Block until the save in flight, if any, is written; raise what its
    write raised."""
    global _in_flight
    if _in_flight is not None:
        _in_flight.join()
        _in_flight = None
    if _failure:
        raise RuntimeError("a background checkpoint write failed") from _failure.pop()


def save_checkpoint(
    state: Any,
    epoch: int,
    iteration: int,
    prefix: str = "",
    checkpoint_dir: str = "./saves",
    async_save: bool = False,
    group=None,
) -> str:
    """Save the whole train state: parameters, BatchNorm statistics, both
    optimizer states, step and epoch. Returns the checkpoint's path."""
    global _in_flight
    path = _ckpt_path(checkpoint_dir, prefix, epoch, iteration)
    parts = _parts(state, group) if _gathers(group) else None
    if _is_writer(group):
        finalize_checkpoints()  # one save in flight at a time
        os.makedirs(checkpoint_dir, exist_ok=True)
        if async_save:
            payload = _payload(parts, state, epoch, pinned=True)
            event = None
            if torch.cuda.is_available() and any(
                    p.is_cuda for p in _model(state).parameters()):
                event = torch.cuda.Event()
                event.record()
            _in_flight = threading.Thread(target=_write_after, args=(event, payload, path),
                                          name="checkpoint-writer", daemon=True)
            _in_flight.start()
            print(f"model checkpoint saving (async) @ {path}")
        else:
            _write(_payload(parts, state, epoch, pinned=False), path)
            print(f"model checkpoint saved @ {path}")
    if not async_save:
        _barrier(group)
    return path


def _read(path: str, group) -> dict:
    """The payload, on the host: ``load_state_dict`` then copies each
    tensor onto its parameter's device, except the step counts of
    ``torch.optim``'s optimizers, which it keeps on the host, where those
    optimizers read them."""
    if _is_writer(group):
        finalize_checkpoints()  # never read while a save is in flight
    _barrier(group)
    return torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)


def load_checkpoint(path: str, target_state: Optional[Any] = None, group=None):
    """Restore a checkpoint into ``target_state`` (a TrainState built as
    the saved one was: same modules and optimizers), in place, onto the
    device of its parameters. Returns (state, epoch); the step is
    restored, the noise generator is not. Without a target, returns the
    raw payload dict (on the CPU). A sharded target takes its slices."""
    payload = _read(path, group)
    if target_state is None:
        return payload
    _load_model(_model(target_state), payload)
    for key in ("opt_e", "opt_d"):
        opt = getattr(target_state, key)
        opt.load_state_dict(shard_optimizer_state_dict(opt, payload[key]))
    target_state.step = int(payload["step"])
    return target_state, int(payload["epoch"])


def find_latest_checkpoint(checkpoint_dir: str, prefix: str = "") -> Optional[str]:
    """Newest checkpoint (by epoch, then iteration) matching the run's
    hparam prefix — what ``resume: "auto"`` restores."""
    if not os.path.isdir(checkpoint_dir):
        return None
    best, best_key = None, (-1, -1)
    pattern = re.compile(re.escape(prefix) + r"model_epoch_(\d+)_iter_(\d+)$")
    for name in os.listdir(checkpoint_dir):
        m = pattern.match(name)
        key = (int(m.group(1)), int(m.group(2))) if m else None
        if key is not None and key > best_key:
            best_key = key
            best = os.path.join(checkpoint_dir, name)
    return best


def load_model(state: Any, path: str, group=None):
    """Parameters and BatchNorm statistics only, into a TrainState or a
    ``SoftIntroVAE`` (the reference's ``load_model``); returns ``state``."""
    _load_model(_model(state), _read(path, group))
    return state


def _load_model(model, payload: dict) -> None:
    for key in ("encoder", "decoder"):
        net = getattr(model, key)
        net.load_state_dict(shard_state_dict(net, payload[key]))


def save_losses(fig_dir: str, kls_real, kls_fake, kls_rec, rec_errs):
    """Pickle training curves (reference utils.py:15-23)."""
    with open(os.path.join(fig_dir, "soft_intro_train_graphs_data.pickle"), "wb") as fp:
        pickle.dump(
            {
                "kl_real": kls_real,
                "kl_fake": kls_fake,
                "kl_rec": kls_rec,
                "rec_err": rec_errs,
            },
            fp,
        )
