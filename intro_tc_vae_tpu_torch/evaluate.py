"""Evaluation CLI: score a trained checkpoint without retraining.

    python -m intro_tc_vae_tpu_torch.evaluate --checkpoint saves/<...> \
        --dataset dsprites --arch conv --z-dim 128 [--num-samples 10000] \
        [--fid] [--out scores.json]

Counterpart of ``intro_tc_vae_tpu/evaluate.py``, with its flags and JSON
keys: restores a port checkpoint's parameters and BatchNorm statistics
(``utils.load_model``) into the fp32 model with the stock convolutions
(``--pack`` b > 1: the decoder's predict conv output-packed), runs the
four disentanglement metric families through the eval-mode encoder on the
device (factor datasets only; each family's failure is recorded as
``<name>_error``, as where sklearn is absent), and with ``--fid`` the FID
between ``--fid-samples`` real images and as many prior samples:
InceptionV3-pool3 when a local weights file exists
(``ITCVAE_INCEPTION_WEIGHTS``; nothing is downloaded), and encoder-feature
FID. TF32 is off (``train.true_fp32``). Runs on ``cuda:0`` and raises when
CUDA is absent, unless ``main`` is given another device.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import torch


def main(argv=None, device: Optional[torch.device] = None) -> dict:
    """Print (and with ``--out`` write) the scores; returns them."""
    ap = argparse.ArgumentParser(description="evaluate a trained checkpoint")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--dataset", default="synthetic",
                    help="dataset name (fixes image size/channels; "
                         "factor-structured datasets enable the "
                         "disentanglement metrics)")
    ap.add_argument("--arch", default="res")
    ap.add_argument("--z-dim", type=int, default=32)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--num-samples", type=int, default=10000,
                    help="sample count per metric split (capped at half "
                         "the dataset)")
    ap.add_argument("--fid", action="store_true",
                    help="also compute FID (real vs prior samples): "
                         "standard InceptionV3-pool3 when "
                         "ITCVAE_INCEPTION_WEIGHTS is set, plus "
                         "encoder-feature FID")
    ap.add_argument("--fid-samples", type=int, default=640)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--pack", type=int, default=0,
                    help="run the predict conv output-packed NxN for sample "
                         "decoding (PackedPredictConv; weight-compatible; "
                         "0 or 1: the plain conv)")
    ap.add_argument("--out", default=None, help="optional JSON output path")
    args = ap.parse_args(argv)

    import numpy as np

    from intro_tc_vae_tpu_torch.data import load_dataset
    from intro_tc_vae_tpu_torch.models import Decoder, Encoder
    from intro_tc_vae_tpu_torch.parallel.distributed import rank_device
    from intro_tc_vae_tpu_torch.solvers import make_optimizer, make_solver
    from intro_tc_vae_tpu_torch.solvers.base import decode
    from intro_tc_vae_tpu_torch.train import true_fp32
    from intro_tc_vae_tpu_torch.utils import load_model

    device = rank_device() if device is None else torch.device(device)
    dataset, image_size, channels, cdim = load_dataset(args.dataset, args.data_root)
    kwargs = dict(arch=args.arch, cdim=cdim, zdim=args.z_dim, channels=tuple(channels),
                  image_size=image_size)
    solver = make_solver(
        "vae", dataset=dataset,
        encoder=Encoder(**kwargs).to(device),
        decoder=Decoder(**kwargs, pack_predict=args.pack).to(device),
        batch_size=args.batch,
        optimizer_e=make_optimizer("adam", 1e-3),
        optimizer_d=make_optimizer("adam", 1e-3),
    )
    state = load_model(solver.init_state(args.seed), args.checkpoint)

    results: dict = {"checkpoint": args.checkpoint, "dataset": args.dataset}
    num_samples = min(args.num_samples, len(dataset) // 2)

    with true_fp32("fp32"):
        if solver.latent_generator is not None:
            from intro_tc_vae_tpu_torch.evaluation import metrics as em

            kw = dict(
                latent_generator=solver.latent_generator,
                encode_fn=solver.make_eval_encoder(state),
                num_samples=num_samples,
                batch_size=args.batch,
            )
            scorers = {
                "bvae": lambda: dict(zip(
                    ("bvae_score", "bvae_score_scaled"), em.compute_bvae_score(**kw))),
                "dci": lambda: dict(zip(
                    ("dci_informativeness", "dci_completeness", "dci_disentanglement"),
                    em.compute_dci_score(**kw))),
                "mig": lambda: {"mig_score": em.compute_mig_score(**kw)},
                "mod_expl": lambda: dict(zip(
                    ("modularity_score", "explicitness_score"),
                    em.compute_mod_expl_score(**kw))),
            }
            for name, fn in scorers.items():
                try:
                    results.update({k: round(float(v), 4) for k, v in fn().items()})
                except Exception as e:  # degenerate draws must not kill the rest
                    results[f"{name}_error"] = str(e)
        else:
            results["disentanglement"] = (
                f"skipped: dataset '{args.dataset}' has no ground-truth factors"
            )

        if args.fid:
            from intro_tc_vae_tpu_torch.evaluation.fid import encoder_fid, standard_fid

            rng = np.random.RandomState(args.seed)
            real = dataset.get_batch(rng.randint(len(dataset), size=args.fid_samples))
            gen = torch.Generator(device=device).manual_seed(args.seed + 7)
            fakes = []
            for _ in range(0, args.fid_samples, args.batch):
                noise = torch.randn((args.batch, args.z_dim), generator=gen, device=device)
                img = decode(state.model.decoder, noise, train=False)
                fakes.append(img.permute(0, 2, 3, 1).cpu().numpy())  # NHWC, as `real`
            fake = np.concatenate(fakes)[: args.fid_samples]
            fid_std = standard_fid(real, fake, batch_size=args.batch, device=device)
            results["fid_inception_pool3"] = (
                round(fid_std, 3) if fid_std is not None else
                "unavailable (set ITCVAE_INCEPTION_WEIGHTS to a pytorch-fid "
                "weights file)"
            )
            results["fid_encoder_features"] = round(
                encoder_fid(solver, state, real, fake, batch_size=args.batch), 3
            )

    print(json.dumps(results, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
        print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
