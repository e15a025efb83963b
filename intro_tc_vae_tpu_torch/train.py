"""Training entry: dataset/model/solver wiring + epoch loop.

Counterpart of ``intro_tc_vae_tpu/train.py::train_soft_intro_vae``:
seeding, dataset, model, two optimizers, loader, solver, and an epoch
loop that checks every step's losses are finite. Runs on ``cuda:0``
unless the caller passes another device; there is no CPU fallback (the
tests pass ``torch.device("cpu")`` explicitly).

Data parallel (JAX ``train.py:90-138``, ``:219``): started as R
processes (``parallel/distributed.py`` says how), each rank trains on
its card, ``cuda:(LOCAL_RANK % device_count)``, with its rows of every
global batch of ``batch_size``; rank 0's weights are broadcast to all,
and only rank 0 prints. ``data_parallel`` must be 0 or the number of
processes: a process cannot be left out of the mesh, so where JAX
shrinks the mesh to a size that divides the batch, the port raises.

``precision: "fp32"`` means fp32 on the card too: for such a run both
TF32 switches are off (PyTorch lets cuDNN compute fp32 convolutions in TF32
by default), as the JAX counterpart computes in true fp32 and as the
``conv_impl: pallas`` kernels do; they are restored when the run ends.

Options this port does not carry yet raise ``NotImplementedError``
naming their ROADMAP item (``check_ported``). Checkpoints are not ported
yet either: the loop says so and saves none.
"""

from __future__ import annotations

import contextlib
import random
import time
from typing import Optional

import numpy as np
import torch

from intro_tc_vae_tpu_torch import not_ported
from intro_tc_vae_tpu_torch.config import Config, validate_config
from intro_tc_vae_tpu_torch.data import DeviceLoader, load_dataset
from intro_tc_vae_tpu_torch.models import Decoder, Encoder, num_params, resolve_conv_impl
from intro_tc_vae_tpu_torch.models.vae import SoftIntroVAE
from intro_tc_vae_tpu_torch.parallel import (
    batch_sharding,
    initialize_distributed,
    make_mesh,
    replicate_state,
)
from intro_tc_vae_tpu_torch.parallel.distributed import process_count, rank_device
from intro_tc_vae_tpu_torch.solvers import TrainState, make_optimizer, make_solver

PRINT_EVERY = 5     # steps between progress lines
WARMUP_STEPS = 3    # steps left out of the final img/s figure


def check_ported(config: Config) -> None:
    """Raise for every option whose behaviour this port does not carry."""
    unported = [
        (config.use_tensorboard, "use_tensorboard: true", "Queue 1 item 6"),
        (config.resume, "resume", "Queue 1 item 7"),
        (config.profile, "profile: true", "Queue 1 item 7"),
        (config.anomaly_detection, "anomaly_detection: true", "Queue 1 item 7"),
        (config.model_parallel > 1, "model_parallel > 1", "Queue 1 item 9"),
        (config.scan_steps > 1, "scan_steps > 1", "Queue 1 item 6"),
        (config.remat, f"remat: {config.remat!r}", "Queue 1 item 6"),
        (config.pack_predict > 1, "pack_predict > 1", "Queue 1 item 10"),
        (config.device_cache == "force", "device_cache: 'force'", "Queue 1 item 7"),
        (config.transfer_dtype == "uint8", "transfer_dtype: 'uint8'", "Queue 1 item 7"),
        (config.tc_sampling == "weighted", "tc_sampling: 'weighted'", "Queue 1 item 6"),
    ]
    for bad, what, item in unported:
        if bad:
            raise not_ported(what, item)


def data_axis_size(config: Config, world: int) -> int:
    """The number of ranks the batch splits over (JAX train.py:116-138):
    ``data_parallel``, or every process for 0."""
    n = config.data_parallel or world
    if n != world:
        raise ValueError(
            f"data_parallel={config.data_parallel} but {world} process(es) run: "
            f"start {n} ranks (torchrun --nproc_per_node {n}, or RANK/WORLD_SIZE/"
            f"LOCAL_RANK with ITCVAE_COORDINATOR_ADDRESS), or set data_parallel "
            f"to 0 or {world}"
        )
    if config.batch_size % n != 0:
        raise ValueError(
            f"batch_size {config.batch_size} not divisible by the data-axis "
            f"size {n} (data_parallel={config.data_parallel} total devices / "
            f"model_parallel=1)"
        )
    return n


def _quiet(*args, **kwargs) -> None:
    pass


@contextlib.contextmanager
def true_fp32(precision: str):
    """For ``precision`` "fp32": cuDNN convolutions and matrix products in
    fp32 proper, not TF32 (10 mantissa bits), until the block ends, however
    it ends. A bf16 run leaves the switches as it found them."""
    if precision != "fp32":
        yield
        return
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def train_soft_intro_vae(config: Config,
                         device: Optional[torch.device] = None) -> TrainState:
    """Run one training job from a Config; returns the final TrainState,
    whose ``history`` holds one record per step (losses and seconds)."""
    with true_fp32(config.precision):
        return _train(config, device)


def _train(config: Config, device: Optional[torch.device]) -> TrainState:
    validate_config(config)
    check_ported(config)
    distributed = initialize_distributed()
    n_data = data_axis_size(config, process_count())
    device = rank_device() if device is None else torch.device(device)
    mesh = make_mesh(n_data, device=device)
    say = print if mesh.rank == 0 else _quiet

    # ----- seeding (reference train.py:38-44) -----
    seed = config.seed if config.seed != -1 else int(time.time()) % (2**31)
    if distributed:  # one seed for all ranks: the noise generators must agree
        box = [seed]
        torch.distributed.broadcast_object_list(box, src=0)
        seed = box[0]
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)  # the modules' default init draws from it
    if config.seed != -1:
        say("random seed: ", seed)

    # ----- data + model -----
    train_set, image_size, channels, ch = load_dataset(
        config.dataset, data_root=config.data_root
    )
    model_kwargs = dict(
        arch=config.arch, cdim=ch, zdim=config.z_dim, channels=tuple(channels),
        image_size=image_size,
        compute_dtype=torch.bfloat16 if config.precision == "bf16" else torch.float32,
        conv_impl=resolve_conv_impl(config.conv_impl),
        tile_rows=max(0, config.tile_rows),
    )
    encoder = Encoder(**model_kwargs).to(device)
    decoder = Decoder(**model_kwargs).to(device)
    say(f"{num_params(SoftIntroVAE(encoder, decoder)):,} Parameters")

    loader = DeviceLoader(train_set, batch_size=config.batch_size, device=device,
                          shuffle=True, seed=seed,
                          rows=batch_sharding(mesh, config.batch_size))
    solver = make_solver(
        config.solver,
        dataset=train_set,
        encoder=encoder,
        decoder=decoder,
        batch_size=config.batch_size,
        optimizer_e=make_optimizer(config.optimizer, config.lr),
        optimizer_d=make_optimizer(config.optimizer, config.lr),
        recon_loss_type=config.recon_loss_type,
        beta_kl=config.beta_kl,
        beta_rec=config.beta_rec,
        beta_neg=config.beta_neg,
        gamma_r=config.gamma_r,
        clip=config.clip,
        tc_impl=config.tc_impl,
        tc_sampling=config.tc_sampling,
        kl_kind=config.kl_kind,
        # None (auto) pairs the passes; the crossover batch past which
        # unpaired passes win is not measured on this card yet (ROADMAP
        # Queue 1 item 6)
        fuse_passes=config.fuse_passes is not False,
        mesh=mesh,
    )
    state = replicate_state(solver.init_state(seed), mesh)
    say("checkpoints are not yet ported (ROADMAP Queue 1 item 7): "
        "this run saves none")

    # ----- epoch loop (reference train.py:194-242) -----
    encoder.train()
    decoder.train()
    t_prev = time.perf_counter()
    for epoch in range(config.start_epoch, config.num_epochs):
        for batch in loader:
            state, metrics = solver.train_step(state, batch)
            # one device->host copy of all metrics; waits for the step
            values = torch.stack([v.float() for v in metrics.values()]).tolist()
            record = dict(zip(metrics, values))
            solver.check_finite(record)
            t_now = time.perf_counter()
            record.update(epoch=epoch, step=state.step, seconds=t_now - t_prev)
            t_prev = t_now
            state.history.append(record)
            if state.step % PRINT_EVERY == 0:
                say(f"epoch {epoch} step {state.step}: "
                      f"loss_enc {record['loss_enc']:.4f} loss_dec {record['loss_dec']:.4f} "
                      f"kl {record['loss_kl']:.4f} rec {record['loss_rec']:.4f}")

    rate = images_per_second(state, config.batch_size)  # the global batch
    if rate is not None:
        say(f"training throughput: {rate:,.1f} img/s on {mesh.size} x "
            f"{device_name(device)} (steps after the first {WARMUP_STEPS}; "
            f"{len(state.history)} steps)")
    return state


def images_per_second(state: TrainState, batch_size: int) -> Optional[float]:
    """Images per second of wall time over the steps after the warm-up,
    data loading and the per-step finite check included."""
    steady = state.history[WARMUP_STEPS:]
    if not steady:
        return None
    return batch_size * len(steady) / sum(r["seconds"] for r in steady)


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)
