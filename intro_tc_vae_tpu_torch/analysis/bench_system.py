"""System-level training throughput: the real ``train()`` loop on the card.

Counterpart of ``analysis/bench_system.py`` (the JAX package's): what a
user gets from ``python -m intro_tc_vae_tpu_torch.main``, the loader's
gather and host-to-device transfer, the step, the metric ring and
TensorBoard, at the flagship's shapes (64x64x3, conv 64-128-256-512, z 128,
bf16, tc and conv ``pallas``) on a uint8-backed array dataset (a
``Synthetic`` render quantized once up front: the storage of dSprites,
MPI3D and the Ukiyo-E decode cache), so the arms isolate the data path:

    python -m intro_tc_vae_tpu_torch.analysis.bench_system              # the four arms
    python -m intro_tc_vae_tpu_torch.analysis.bench_system uint8 cache  # some of them
    python -m intro_tc_vae_tpu_torch.analysis.bench_system --images 5120 \\
        --steps-per-epoch 80 --epochs 3 --graph 1

Arms: ``float32`` (the float batch crosses), ``uint8`` (a quarter of the
bytes; the step normalizes on the card), ``cache`` (the dataset resident
on the card; the indices cross) and ``auto:K`` (uint8 and ``scan_steps``
K: one [K, B, ...] transfer a call); any arm takes ``:K``. Each arm runs
eager and graphed (``--graph``: ``both``, ``0`` or ``1``; the trainer
graphs the step on a card by default, ``train.py::graph_step``). The data
size (``--images``, default 20,480) and the epoch length
(``--steps-per-epoch``, default 320) set the batch, 64 by default. Each
run prints the trainer's steady-state ``training throughput`` lines; the
last line is one JSON object with every arm's img/s: the steps after the
first 4 (``train.images_per_second``) and the median of the epochs after
the first. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile

ARMS = ("float32", "uint8", "cache", "auto:4")


def uint8_dataset(images: int, image_size: int):
    """An array dataset of ``images`` uint8 images of the synthetic
    factors, rendered and quantized once, with no factor hooks."""
    import numpy as np

    from intro_tc_vae_tpu_torch.data.datasets import Synthetic, _ArrayDataset

    class U8Dataset(_ArrayDataset):
        latent_indices = None  # plain dataset: no disentanglement hooks

    syn = Synthetic(image_size=image_size, cdim=3, sizes=(8, 10, 16, 16))
    idx = np.arange(images) % len(syn)
    imgs = syn.get_batch(idx)
    imgs_u8 = np.clip(np.round(imgs * 255.0), 0, 255).astype(np.uint8)
    return U8Dataset(imgs_u8, syn.latents_values[idx], resize=image_size)


def epoch_rates(history: list, batch: int) -> list:
    """img/s of each epoch from the trainer's per-step records."""
    seconds: dict = {}
    for r in history:
        seconds.setdefault(r["epoch"], []).append(r["seconds"])
    return [batch * len(s) / sum(s) for _, s in sorted(seconds.items())]


def run_arm(arm: str, graph: bool, dataset, image_size: int, batch: int, epochs: int,
            out_root: str, device, tensorboard: bool, tc_impl: str, conv_impl: str) -> dict:
    from intro_tc_vae_tpu_torch import train
    from intro_tc_vae_tpu_torch.analysis.profile_step import CHANNELS
    from intro_tc_vae_tpu_torch.config import load_config

    kind, _, scan = arm.partition(":")
    scan = int(scan or 1)
    # 'cache' keeps the dataset on the card; every other arm pins the cache
    # off so that the arm measures the transfer path it names
    cache = "force" if kind == "cache" else "off"
    dtype = "auto" if kind == "cache" else kind
    name = f"{arm.replace(':', '_')}_{'graphed' if graph else 'eager'}"
    config = load_config(update_dict=dict(
        solver="intro_tc", dataset="synthetic", num_epochs=epochs, batch_size=batch,
        z_dim=128, arch="conv", lr=2e-4, beta_kl=0.5, beta_rec=0.75, beta_neg=512.0,
        gamma_r=1e-8, precision="bf16", tc_impl=tc_impl, conv_impl=conv_impl,
        use_tensorboard=tensorboard, transfer_dtype=dtype, scan_steps=scan,
        device_cache=cache, seed=99, log_dir=os.path.join(out_root, name, "tb"),
        checkpoint_dir=os.path.join(out_root, name, "ckpt"),
        test_iter=10**6, save_interval=10**6))
    channels = CHANNELS[image_size]
    original = train.load_dataset
    train.load_dataset = lambda name, data_root=None: (dataset, image_size, list(channels), 3)
    try:
        print(f"=== arm={kind} scan_steps={scan} {'graphed' if graph else 'eager'} ===",
              flush=True)
        state = train.train_soft_intro_vae(config, device=device, graph=graph)
    finally:
        train.load_dataset = original
    rates = epoch_rates(state.history, batch)
    return {"img_s": train.images_per_second(state, batch),
            "img_s_epochs_median": statistics.median(rates[1:]) if len(rates) > 1 else None,
            "epoch_img_s": rates, "steps": len(state.history)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arms", nargs="*", default=list(ARMS))
    ap.add_argument("--images", type=int, default=20480)
    ap.add_argument("--steps-per-epoch", type=int, default=320)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--graph", choices=("both", "0", "1"), default="both")
    ap.add_argument("--tensorboard", type=int, choices=(0, 1), default=1)
    ap.add_argument("--tc-impl", default="pallas")
    ap.add_argument("--conv-impl", default="pallas")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="runs' logs and checkpoints (default: a "
                                                "temporary directory, deleted after)")
    a = ap.parse_args(argv)
    import torch

    if a.images % a.steps_per_epoch:
        raise SystemExit(f"--images {a.images} is no multiple of --steps-per-epoch "
                         f"{a.steps_per_epoch}")
    batch = a.images // a.steps_per_epoch
    device = torch.device(a.device)
    graphs = {"both": (False, True), "0": (False,), "1": (True,)}[a.graph]
    print(f"rendering the uint8 dataset ({a.images:,} images, {a.image_size} px; "
          f"{a.steps_per_epoch} steps of {batch} an epoch) ...", flush=True)
    dataset = uint8_dataset(a.images, a.image_size)
    results: dict = {}
    with tempfile.TemporaryDirectory(prefix="itcvae-bench-system-") as tmp:
        out_root = a.out or tmp
        for arm in a.arms:
            for graph in graphs:
                results.setdefault(arm, {})["graphed" if graph else "eager"] = run_arm(
                    arm, graph, dataset, a.image_size, batch, a.epochs, out_root, device,
                    bool(a.tensorboard), a.tc_impl, a.conv_impl)
    out = {"metric": "bench_system", "unit": "img/s", "images": a.images,
           "steps_per_epoch": a.steps_per_epoch, "batch": batch, "epochs": a.epochs,
           "image_size": a.image_size, "device": str(device),
           "card": torch.cuda.get_device_name(device) if device.type == "cuda" else None,
           "arms": results}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
