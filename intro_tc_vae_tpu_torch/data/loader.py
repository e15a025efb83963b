"""Epoch iterator that feeds NCHW float32 batches to one device.

Counterpart of ``intro_tc_vae_tpu/data/loader.py`` (``DeviceLoader``,
:138-154): a shuffled, seeded, ``drop_last`` epoch order drawn from the
same ``np.random.RandomState`` stream, so both packages see the same
batches in the same order. Each batch is gathered on the host (NHWC),
converted to NCHW once, pinned when the target is a CUDA device and
copied without blocking the host. The prefetch thread, uint8 transfer,
the device-resident cache and scan stacking are not ported yet.

Data parallel (``rows``, JAX ``loader.py:176-197``): every rank draws
the same seeded global order and gathers only its own rows of each
global batch of ``batch_size``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class DeviceLoader:
    def __init__(self, dataset, batch_size: int, device: torch.device,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 rows: Optional[slice] = None):
        self.dataset = dataset
        self.rows = rows  # this rank's rows of each batch; None: all
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _index_batches(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for start in range(0, stop, self.batch_size):
            yield order[start : start + self.batch_size]

    def _to_device(self, imgs: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(imgs)).permute(0, 3, 1, 2)
        x = x.contiguous()
        if self.device.type == "cuda":
            x = x.pin_memory()
        return x.to(self.device, non_blocking=True)

    def __iter__(self):
        for idx in self._index_batches():
            if self.rows is not None:
                idx = idx[self.rows]
            yield self._to_device(self.dataset.get_batch(idx))
