"""Training entry: dataset/model/solver wiring + epoch loop.

Counterpart of ``intro_tc_vae_tpu/train.py::train_soft_intro_vae``:
seeding, dataset, model, two optimizers, loader, solver, and an epoch
loop that checks every step's losses are finite. Runs on ``cuda:0``
unless the caller passes another device; there is no CPU fallback (the
tests pass ``torch.device("cpu")`` explicitly).

Options this port does not carry yet raise ``NotImplementedError``
naming their ROADMAP item (``check_ported``). Checkpoints are not ported
yet either: the loop says so and saves none.
"""

from __future__ import annotations

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
        (config.data_parallel > 1, "data_parallel > 1", "Queue 1 item 9"),
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


def default_device() -> torch.device:
    """cuda:0; raises when CUDA is absent (the port has no CPU fallback)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "intro_tc_vae_tpu_torch trains on a CUDA device and none is "
            "available; pass device=torch.device('cpu') explicitly to run "
            "the plain PyTorch versions on the CPU"
        )
    return torch.device("cuda", 0)


def train_soft_intro_vae(config: Config,
                         device: Optional[torch.device] = None) -> TrainState:
    """Run one training job from a Config; returns the final TrainState,
    whose ``history`` holds one record per step (losses and seconds)."""
    validate_config(config)
    check_ported(config)
    device = default_device() if device is None else torch.device(device)

    # ----- seeding (reference train.py:38-44) -----
    seed = config.seed if config.seed != -1 else int(time.time()) % (2**31)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)  # the modules' default init draws from it
    if config.seed != -1:
        print("random seed: ", seed)

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
    print(f"{num_params(SoftIntroVAE(encoder, decoder)):,} Parameters")

    loader = DeviceLoader(train_set, batch_size=config.batch_size, device=device,
                          shuffle=True, seed=seed)
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
    )
    state = solver.init_state(seed)
    print("checkpoints are not yet ported (ROADMAP Queue 1 item 7): "
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
                print(f"epoch {epoch} step {state.step}: "
                      f"loss_enc {record['loss_enc']:.4f} loss_dec {record['loss_dec']:.4f} "
                      f"kl {record['loss_kl']:.4f} rec {record['loss_rec']:.4f}")

    rate = images_per_second(state, config.batch_size)
    if rate is not None:
        print(f"training throughput: {rate:,.1f} img/s on {device_name(device)} "
              f"(steps after the first {WARMUP_STEPS}; "
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
