"""Datasets: the procedural ``Synthetic`` set and the ``load_dataset`` table.

Counterpart of ``intro_tc_vae_tpu/data/datasets.py``: ``factor_bases``,
``index_to_factor`` and ``Synthetic`` are copied (plain numpy, float32
NHWC images in [0, 1]) so both packages draw identical batches. The
file-backed datasets (Ukiyo-E, dSprites, MPI3D) are not ported yet.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from intro_tc_vae_tpu_torch import not_ported


def factor_bases(sizes: Sequence[int]) -> np.ndarray:
    """Mixed-radix place values: bases[k] = prod(sizes)/cumprod(sizes)[k]."""
    sizes = np.asarray(sizes)
    return (np.prod(sizes) / np.cumprod(sizes)).astype(np.int64)


def index_to_factor(idx, bases, sizes) -> np.ndarray:
    """Flat dataset index -> factor tuple (mixed-radix decomposition)."""
    return np.mod(np.floor_divide(np.asarray(idx)[..., None], bases), sizes)


class Synthetic:
    """Procedural disentanglement dataset (no files needed).

    Factors (color, scale, x, y) render a filled square on a black
    background; images are generated vectorized per batch.
    """

    def __init__(
        self,
        image_size: int = 64,
        cdim: int = 3,
        sizes: Sequence[int] = (4, 5, 8, 8),
    ):
        self._factor_sizes = list(sizes)
        self.image_size = image_size
        self.cdim = cdim
        self._bases = factor_bases(self._factor_sizes)
        n = int(np.prod(self._factor_sizes))
        self.latents_values = index_to_factor(
            np.arange(n), self._bases, self._factor_sizes
        )

    @property
    def latent_indices(self) -> List[int]:
        return list(range(len(self._factor_sizes)))

    @property
    def factor_sizes(self) -> List[int]:
        return self._factor_sizes

    def __len__(self) -> int:
        return int(np.prod(self._factor_sizes))

    def _render(self, factors: np.ndarray) -> np.ndarray:
        """Vectorized render: factors [B, 4] -> images [B, S, S, C]."""
        s = self.image_size
        n_color, n_scale, n_x, n_y = self._factor_sizes
        color, scale, fx, fy = (factors[:, i] for i in range(4))
        side = ((scale + 1) * s) // (2 * n_scale)  # [s/2n .. s/2]
        x0 = (fx * (s - side)) // max(n_x - 1, 1)
        y0 = (fy * (s - side)) // max(n_y - 1, 1)
        xs = np.arange(s)[None, :]
        col_mask = (xs >= x0[:, None]) & (xs < (x0 + side)[:, None])  # [B, S]
        row_mask = (xs >= y0[:, None]) & (xs < (y0 + side)[:, None])
        mask = row_mask[:, :, None] & col_mask[:, None, :]  # [B, S, S]
        img = mask.astype(np.float32)[..., None]
        intensity = 0.25 + 0.75 * (color[:, None, None, None] / max(n_color - 1, 1))
        if self.cdim == 3:
            chans = [
                img * intensity,
                img * (1.0 - 0.5 * intensity),
                img * np.abs(1.0 - 2.0 * intensity * 0.5),
            ]
            return np.concatenate(chans, axis=-1).astype(np.float32)
        return (img * intensity).astype(np.float32)

    def __getitem__(self, index: int):
        factors = self.latents_values[index : index + 1]
        return self._render(factors)[0], self.latents_values[index]

    def get_batch(self, indices: np.ndarray) -> np.ndarray:
        return self._render(self.latents_values[np.asarray(indices)])


# name -> (image_size, channels, cdim); the table of reference
# train.py:56-92 plus 'synthetic*', as in the JAX package
_TABLE = {
    "ukiyo_e256": (256, [64, 128, 256, 512, 512, 512], 3),
    "ukiyo_e128": (128, [64, 128, 256, 512, 512], 3),
    "ukiyo_e64": (64, [64, 128, 256, 512], 3),
    "dsprites": (64, [64, 128, 256, 512], 1),
    "dsprites_small": (64, [64, 128, 256, 512], 1),
    "mpi3d": (64, [64, 128, 256, 512], 3),
    "mpi3d_small": (64, [64, 128, 256, 512], 3),
    "synthetic": (64, [64, 128, 256, 512], 3),
    "synthetic128": (128, [64, 128, 256, 512, 512], 3),
    "synthetic256": (256, [64, 128, 256, 512, 512, 512], 3),
    "synthetic_small": (32, [16, 32], 3),  # tiny: smoke tests / demos
}


def load_dataset(
    name: str, data_root: str | None = None
) -> Tuple[Synthetic, int, List[int], int]:
    """Dataset factory: name -> (dataset, image_size, channels, cdim)."""
    if name not in _TABLE:
        raise NotImplementedError(f"dataset '{name}' is not supported")
    image_size, channels, cdim = _TABLE[name]
    if not name.startswith("synthetic"):
        raise not_ported(f"the file-backed dataset '{name}'", "Queue 1 item 3")
    sizes = (2, 2, 4, 4) if name == "synthetic_small" else (4, 5, 8, 8)
    return Synthetic(image_size=image_size, cdim=cdim, sizes=sizes), image_size, channels, cdim
