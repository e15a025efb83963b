"""The inputs a run makes from its seed: the image corpus, the weights
(``reference/model.py::make_weights``), each step's noise and each
request's latents. The same seed gives the same inputs; the program is
handed them and the reference is handed the same.

Seeds up to and past 2**32 are folded into independent 31-bit streams by
``numpy.random.SeedSequence``, one per purpose.
"""

from __future__ import annotations

import numpy as np
import torch

PURPOSES = ("program", "weights", "corpus", "flips", "noise", "latents", "sample")


def sub_seeds(seed: int) -> dict:
    """One 31-bit seed per purpose, drawn from ``seed``."""
    words = np.random.SeedSequence(int(seed)).generate_state(len(PURPOSES))
    return {p: int(w) & 0x7FFFFFFF for p, w in zip(PURPOSES, words)}


def make_corpus(n: int, size: int, cdim: int, seed: int, device) -> np.ndarray:
    """``n`` uint8 images [n, size, size, cdim], NHWC on the host, made on
    ``device`` in a few large draws: each image a smooth field (a coarse
    8 x 8 grid of uniform values, bilinearly upsampled) under its own
    contrast and brightness, plus fine noise, so that images and their
    losses differ from one to the next."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = np.empty((n, size, size, cdim), np.uint8)
    chunk = max(1, (256 << 20) // (size * size * cdim * 4))
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        coarse = torch.rand((m, cdim, 8, 8), generator=gen, device=device)
        field = torch.nn.functional.interpolate(coarse, size=(size, size), mode="bilinear",
                                                align_corners=False)
        gain = 0.4 + 0.6 * torch.rand((m, 1, 1, 1), generator=gen, device=device)
        shift = 0.5 * torch.rand((m, 1, 1, 1), generator=gen, device=device)
        fine = 0.08 * torch.rand((m, cdim, size, size), generator=gen, device=device)
        img = torch.clamp(field * gain + shift * (1.0 - gain) + fine, 0.0, 1.0)
        u8 = torch.floor(img * 255.0).to(torch.uint8).permute(0, 2, 3, 1)
        out[s : s + m] = u8.cpu().numpy()
    return out


class Corpus:
    """The corpus as the program's loader takes a dataset: ``__len__``,
    ``raw_array`` (its exact uint8 storage, which the loader's device cache
    holds), ``get_batch_raw`` (the uint8 path, where the cache declines)
    and ``flip_flags`` (a width flip for half of the rows, as the Ukiyo-E
    set augments, from a seeded stream). Every flag handed out is kept
    (``flags``), so the reference can apply the same flips."""

    def __init__(self, images: np.ndarray, flip_seed: int):
        self.images = images
        self._rng = np.random.RandomState(flip_seed)
        self.flags: list = []

    def __len__(self) -> int:
        return len(self.images)

    def raw_array(self) -> np.ndarray:
        return self.images

    def get_batch_raw(self, indices) -> np.ndarray:
        raw = self.images[np.asarray(indices)]
        flags = self.flip_flags(len(raw))
        return np.where(flags[:, None, None, None] != 0, raw[:, :, ::-1], raw)

    def flip_flags(self, n: int) -> np.ndarray:
        flags = (self._rng.rand(n) < 0.5).astype(np.uint8)
        self.flags.append(flags)
        return flags


def epoch_order(n: int, loader_seed: int) -> np.ndarray:
    """The first epoch's order of a shuffled loader seeded with
    ``loader_seed``: ``RandomState(seed).shuffle(arange(n))``."""
    order = np.arange(n)
    np.random.RandomState(loader_seed).shuffle(order)
    return order


def reference_batch(images: np.ndarray, order: np.ndarray, flags: np.ndarray, step: int,
                    batch: int, device) -> torch.Tensor:
    """Step ``step``'s (0-based) batch of the first epoch, worked out from
    the corpus, the order and the step's flip flags: float32 NCHW in
    [0, 1] on ``device``."""
    rows = images[order[step * batch:(step + 1) * batch]]
    rows = np.where(flags[:, None, None, None] != 0, rows[:, :, ::-1], rows)
    x = torch.from_numpy(np.ascontiguousarray(rows)).to(device)
    return x.permute(0, 3, 1, 2).float() / 255.0


def step_noise(gen: torch.Generator, batch: int, zdim: int, keys, device) -> dict:
    """A step's N(0, I) draws, [batch, zdim] each, in one call."""
    draw = torch.randn((len(keys), batch, zdim), generator=gen, device=device)
    return dict(zip(keys, draw.unbind(0)))


def latent_bank(count: int, batch: int, zdim: int, seed: int) -> np.ndarray:
    """``count`` requests' latents, [count, batch, zdim] float32, drawn on
    the host."""
    rng = np.random.Generator(np.random.PCG64(int(seed)))
    return rng.standard_normal((count, batch, zdim), dtype=np.float32)
