"""Rank workers for tests/test_torch_tensor_parallel.py and the
tensor-parallel trainer test of tests/test_torch_train.py.

Each worker is one rank of a ('data', 'model') mesh, started by
``tests/_torch_dp_workers.py::run_ranks`` (spawned processes that join a
``gloo`` group on the CPU through the port's start-up, under its 120 s
timeout). Nothing here imports jax.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from intro_tc_vae_tpu_torch.config import load_config
from intro_tc_vae_tpu_torch.data import Synthetic
from intro_tc_vae_tpu_torch.models import Decoder, Encoder, SoftIntroVAE
from intro_tc_vae_tpu_torch.parallel import (
    batch_sharding,
    copy_to_model,
    gather_channels,
    gather_optimizer_state,
    gather_state,
    make_mesh,
    ranks_agree,
    reduce_from_model,
    replicate_state,
    shard_state,
    state_digest,
)
from intro_tc_vae_tpu_torch.solvers import make_optimizer, make_solver
from intro_tc_vae_tpu_torch.train import train_soft_intro_vae
from intro_tc_vae_tpu_torch.utils import checkpoint
from tests._torch_dp_workers import _count_tc_routes

CPU = torch.device("cpu")
# the small model of tests/test_parallel.py's TP2xDP4 test, and its min_dim
SMALL = dict(cdim=3, zdim=8, channels=(8, 16), image_size=32)
MIN_DIM = 8
HYPER = dict(beta_kl=0.5, beta_rec=0.75, beta_neg=64.0)


def tp_solver(arch: str, init: dict, batch_size: int, mesh=None, remat=False,
              bump: float = 0.0, min_dim: int = MIN_DIM, tc_impl: str = "pallas",
              model: dict = None):
    """The small float64 intro_tc solver (``model``: other model arguments)
    from the weights ``init`` (whole tensors, plus ``bump`` on every
    parameter): ``remat`` False, "block" or "pass"; under ``mesh``
    replicated, then sharded with ``min_dim``."""
    kw = dict(arch=arch, **{**SMALL, **(model or {})}, compute_dtype=torch.float64,
              remat=remat == "block")
    enc, dec = Encoder(**kw), Decoder(**kw)
    model = SoftIntroVAE(enc, dec).double()
    model.load_state_dict(init)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(bump)
    solver = make_solver(
        "intro_tc", dataset=Synthetic(image_size=32, cdim=3, sizes=(2, 2, 2, 2)),
        encoder=enc, decoder=dec, batch_size=batch_size,
        optimizer_e=make_optimizer("adam", 2e-4), optimizer_d=make_optimizer("adam", 2e-4),
        tc_impl=tc_impl, mesh=mesh, remat_passes=remat == "pass", **HYPER)
    state = solver.init_state(0)
    if mesh is not None:
        state = shard_state(replicate_state(state, mesh), mesh, min_dim=min_dim)
    return solver, state


def _rows(mesh, batch: np.ndarray) -> torch.Tensor:
    """This rank's rows of the global NHWC ``batch``, as NCHW."""
    return torch.from_numpy(batch[batch_sharding(mesh, batch.shape[0])]
                            .transpose(0, 3, 1, 2).copy())


def _result(state, metrics) -> dict:
    """Metrics, the whole state (gathered), both optimizers' whole states,
    and which leaves this rank holds a slice of."""
    from intro_tc_vae_tpu_torch.parallel.mesh import sharded_keys

    return dict(metrics={k: float(v) for k, v in metrics.items()},
                state={k: v.clone() for k, v in gather_state(state.model).items()},
                opt_e=copy.deepcopy(gather_optimizer_state(state.opt_e)),
                opt_d=copy.deepcopy(gather_optimizer_state(state.opt_d)),
                sharded=sorted(sharded_keys(state.model)),
                local={k: tuple(v.shape) for k, v in state.model.state_dict().items()})


def collectives(xs: list, whole_x, partials: list, cot) -> dict:
    """The model-axis collectives on this rank, float64, forward and
    backward: ``gather_channels`` of this rank's slice ``xs[m]`` (and of
    its bf16 rounding), ``copy_to_model`` of the whole ``whole_x`` with
    each rank differentiating its column slice of the loss, and
    ``reduce_from_model`` of this rank's partial ``partials[m]``; every
    loss is weighted by ``cot`` (the same on every rank)."""
    mesh = make_mesh(model_parallel=len(xs), device=CPU)
    group, m = mesh.model, mesh.model.rank
    cot = torch.from_numpy(cot)
    x = torch.tensor(xs[m], requires_grad=True)
    g = gather_channels(x, group)
    (dx,) = torch.autograd.grad((g * cot).sum(), x)
    bf = gather_channels(x.detach().to(torch.bfloat16), group)
    w = torch.tensor(whole_x, requires_grad=True)
    width = w.shape[1] // group.size
    part = copy_to_model(w, group)[:, m * width:(m + 1) * width]
    (dw,) = torch.autograd.grad((part * cot[:, m * width:(m + 1) * width]).sum(), w)
    p = torch.tensor(partials[m], requires_grad=True)
    s = reduce_from_model(p, group)
    (dp,) = torch.autograd.grad((s * cot).sum(), p)
    return dict(gathered=g.detach(), dx=dx, gathered_bf16=bf, dcopy=dw, sum=s.detach(), dp=dp,
                mesh=(mesh.size, mesh.rank, group.size, group.rank))


def count_conv_kernel_calls() -> dict:
    """Counts this process's calls of the conv kernels' wrapper from the
    models (``models/blocks.py``; on the CPU it takes its plain version)."""
    from intro_tc_vae_tpu_torch.models import blocks

    counts = {"conv3x3_pallas": 0}
    wrapped = blocks.conv3x3_pallas

    def counted(*args, **kwargs):
        counts["conv3x3_pallas"] += 1
        return wrapped(*args, **kwargs)

    blocks.conv3x3_pallas = counted
    return counts


def tp_steps(cases: dict, batches: list, noises: list, model_parallel: int,
             resume: dict) -> dict:
    """On this rank of a mesh with ``model_parallel`` model ranks: one
    step of each case ({label: (arch, remat, init, model arguments,
    min_dim)}) on this rank's rows of ``batches[0]`` with ``noises[0]``
    (the conv kernels' wrapper calls counted); for ``resume`` (arch, init,
    checkpoint dir, path of a one-process checkpoint after the first
    step): three steps (the digests of the replicated leaves, the whole
    state), a background save after the first (rank 0 writes) loaded into
    a fresh state that takes the second step, and the one-process
    checkpoint loaded into a fresh state that takes the second step."""
    mesh = make_mesh(model_parallel=model_parallel, device=CPU)
    routes, convs = _count_tc_routes(), count_conv_kernel_calls()
    out = {"mesh": (mesh.size, mesh.rank, mesh.model.size, mesh.model.rank)}
    b = batches[0].shape[0]
    for label, (arch, remat, init, model, min_dim) in cases.items():
        solver, state = tp_solver(arch, init, b, mesh, remat, model=model, min_dim=min_dim)
        routes.update(gathered=0, single=0)
        convs.update(conv3x3_pallas=0)
        _, metrics = solver.train_step(state, _rows(mesh, batches[0]), noise=noises[0])
        out[label] = dict(_result(state, metrics), routes=dict(routes), convs=dict(convs))

    arch, init, ckpt_dir, one_process_path = resume
    solver, state = tp_solver(arch, init, b, mesh)
    writes = []
    write = checkpoint._write
    checkpoint._write = lambda payload, path: (writes.append(path), write(payload, path))
    runs = []
    for k in range(3):
        _, metrics = solver.train_step(state, _rows(mesh, batches[k]), noise=noises[k])
        if k == 0:
            path = checkpoint.save_checkpoint(state, 0, state.step, "tp_",
                                              checkpoint_dir=ckpt_dir, async_save=True,
                                              group=mesh)
            saved = _result(state, metrics)
        runs.append(_result(state, metrics))
    out["three_steps"] = dict(runs=runs, digest=state_digest(state.model, replicated_only=True),
                              agree=ranks_agree(state.model, None, replicated_only=True))
    for label, src in (("tp_resume", path), ("one_process_resume", one_process_path)):
        solver_r, restored = tp_solver(arch, init, b, mesh, bump=0.5)
        checkpoint.load_checkpoint(src, restored, group=mesh)
        loaded = _result(restored, {})
        _, metrics = solver_r.train_step(restored, _rows(mesh, batches[1]), noise=noises[1])
        out[label] = dict(loaded=loaded, step=_result(restored, metrics))
    checkpoint.finalize_checkpoints()
    out["saved"], out["writes"] = saved, writes
    return out


def tp_jax_step(init: dict, batch, noise: dict) -> dict:
    """TP2 x DP2: one res-arch step, tc_impl 'pallas' (the gathered
    kernels' plain version on the CPU), from the JAX package's weights
    ``init``, on this rank's rows of ``batch`` with the JAX step's noise."""
    mesh = make_mesh(model_parallel=2, device=CPU)
    routes = _count_tc_routes()
    solver, state = tp_solver("res", init, batch.shape[0], mesh)
    _, metrics = solver.train_step(state, _rows(mesh, batch),
                                   noise={k: torch.from_numpy(np.array(v)) for k, v in noise.items()})
    return dict(_result(state, metrics), routes=dict(routes),
                mesh=(mesh.size, mesh.rank, mesh.model.size, mesh.model.rank))


def train_tp(config_path: str, update: dict) -> dict:
    """``train_soft_intro_vae`` on this rank with ``update`` (its
    ``model_parallel``) and the sharding threshold lowered to
    ``MIN_DIM`` (as JAX's tests lower it), so the small model's leaves are
    cut: the history, the run's TC routes, the sharded keys and digests."""
    from intro_tc_vae_tpu_torch import train
    from intro_tc_vae_tpu_torch.parallel.mesh import sharded_keys

    train.shard_state = lambda state, mesh: shard_state(state, mesh, min_dim=MIN_DIM)
    routes = _count_tc_routes()
    state = train_soft_intro_vae(load_config(config_path, update), device=CPU)
    return dict(history=state.history, routes=routes, sharded=sorted(sharded_keys(state.model)),
                replicated=state_digest(state.model, replicated_only=True),
                whole=state_digest_whole(state.model), samples=state.samples)


def state_digest_whole(model) -> str:
    """The digest of the whole (gathered) parameters and statistics."""
    import hashlib

    h = hashlib.sha256()
    for name, t in gather_state(model).items():
        h.update(name.encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def tp2dp2(init: dict, batch, noise: dict, config_path: str, update: dict) -> dict:
    """TP2 x DP2 (4 ranks): ``tp_jax_step``, then ``train_tp``."""
    return dict(step=tp_jax_step(init, batch, noise), train=train_tp(config_path, update))
