"""Generation CLI: decode prior samples / reconstruct images from a
trained checkpoint.

    python -m intro_tc_vae_tpu_torch.sample --checkpoint saves/<...> \
        --dataset synthetic --arch conv --z-dim 128 --num 16 --out grid.png

Counterpart of ``intro_tc_vae_tpu/sample.py``, with its flags: builds the
decoder (and the encoder, for ``--reconstruct``) in fp32 with the stock
convolutions, restores parameters and BatchNorm statistics
(``utils.load_model``), draws ``--num`` latents from a generator seeded
with ``--seed`` on the device, decodes them in eval mode, quantises on
the device (``unit_f32_to_u8``) and writes one image grid with PIL, as
the JAX package does. fp32 means fp32 on the card: TF32 is off for the
decode (``train.true_fp32``). Runs on ``cuda:0`` and raises when CUDA is
absent, unless ``main`` is given another device.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from intro_tc_vae_tpu_torch import not_ported


def sample_grid(images: np.ndarray, cols: int = 8) -> np.ndarray:
    """[N, H, W, C] -> one grid image [GH, GW, C] (any dtype)."""
    n, h, w, c = images.shape
    cols = min(cols, n)
    rows = -(-n // cols)
    grid = np.zeros((rows * h, cols * w, c), images.dtype)
    for i, img in enumerate(images):
        r, col = divmod(i, cols)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = img
    return grid


def to_host_u8(images: torch.Tensor) -> np.ndarray:
    """[N, C, H, W] float images in [0, 1] on the device -> [N, H, W, C]
    uint8 on the host, quantised before the copy (a quarter of the bytes)."""
    from intro_tc_vae_tpu_torch.solvers.base import unit_f32_to_u8

    return unit_f32_to_u8(images).permute(0, 2, 3, 1).cpu().numpy()


def main(argv=None, device: Optional[torch.device] = None) -> np.ndarray:
    """Write the grid to ``--out``; returns it ([GH, GW] or [GH, GW, C] uint8)."""
    ap = argparse.ArgumentParser(description="sample from a trained model")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--dataset", default="synthetic",
                    help="dataset name (fixes image size/channels)")
    ap.add_argument("--arch", default="res")
    ap.add_argument("--z-dim", type=int, default=32)
    ap.add_argument("--num", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reconstruct", action="store_true",
                    help="also reconstruct --num dataset images")
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--out", default="samples.png")
    ap.add_argument("--pack", type=int, default=0,
                    help="run the predict conv output-packed NxN "
                         "(PackedPredictConv; not ported yet)")
    args = ap.parse_args(argv)
    if args.pack > 0:
        raise not_ported("--pack > 0 (PackedPredictConv)", "Queue 1 item 9")

    from PIL import Image

    from intro_tc_vae_tpu_torch.data import load_dataset
    from intro_tc_vae_tpu_torch.models import Decoder, Encoder, SoftIntroVAE
    from intro_tc_vae_tpu_torch.parallel.distributed import rank_device
    from intro_tc_vae_tpu_torch.solvers.base import decode, encode
    from intro_tc_vae_tpu_torch.train import true_fp32
    from intro_tc_vae_tpu_torch.utils import load_model

    device = rank_device() if device is None else torch.device(device)
    dataset, image_size, channels, cdim = load_dataset(args.dataset, args.data_root)
    kwargs = dict(arch=args.arch, cdim=cdim, zdim=args.z_dim, channels=tuple(channels),
                  image_size=image_size)
    model = SoftIntroVAE(Encoder(**kwargs), Decoder(**kwargs)).to(device)
    load_model(model, args.checkpoint)

    with true_fp32("fp32"):
        gen = torch.Generator(device=device).manual_seed(args.seed)
        z = torch.randn((args.num, args.z_dim), generator=gen, device=device)
        imgs = [to_host_u8(decode(model.decoder, z, train=False))]
        if args.reconstruct:
            x = dataset.get_batch(np.arange(args.num) % len(dataset))
            xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).to(device)
            mu, _ = encode(model.encoder, xt, train=False)
            rec = decode(model.decoder, mu, train=False)
            x_u8 = (np.clip(x, 0, 1) * 255).astype(np.uint8)
            imgs = [x_u8, to_host_u8(rec), imgs[0]]

    grid = np.squeeze(sample_grid(np.concatenate(imgs, axis=0)))
    Image.fromarray(grid).save(args.out)
    print(f"wrote {args.out} ({grid.shape[0]}x{grid.shape[1]})")
    return grid


if __name__ == "__main__":
    main()
