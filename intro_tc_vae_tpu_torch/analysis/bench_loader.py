"""The host's batch rate on the port's data paths.

Counterpart of ``analysis/bench_loader.py`` (the JAX package's): how fast
the host assembles flagship-shaped batches, the rate that must exceed the
card's step rate for the card never to wait on data:

* ``ukiyo_cached``: the decoded uint8 cache with the native gather,
  resize and flip (the Ukiyo-E path after its first epoch);
* ``ukiyo_uncached``: a PIL decode per image (the first epoch, or
  ``cache=False``);
* ``synthetic``: the procedural render (the benchmark's data);
* ``loader_ukiyo_cached``: the same cached Ukiyo-E set through
  ``DeviceLoader`` to ``--device`` (uint8 transfer, the producer thread):
  batches a second that reach the device.

    python -m intro_tc_vae_tpu_torch.analysis.bench_loader [--data-root DIR] \\
        [--batch 64] [--image-size 64] [--seconds 5] [--device cuda]

Without ``--data-root`` naming an ARC Ukiyo-E corpus it reads the
5-image fixture (``tests/test_data``), drawing indices from it with
replacement so that every batch takes the whole decode and gather path.
The last line is one JSON object. Runs on the card unless ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def measure(get_batch, n_items: int, batch: int, seconds: float, seed: int = 0) -> float:
    """Pump batches for ``seconds``; images per second."""
    rng = np.random.RandomState(seed)
    get_batch(rng.randint(0, n_items, size=batch))  # warm-up: caches, page faults
    t0 = time.perf_counter()
    done = 0
    while time.perf_counter() - t0 < seconds:
        get_batch(rng.randint(0, n_items, size=batch))
        done += batch
    return done / (time.perf_counter() - t0)


def loader_rate(dataset, batch: int, seconds: float, device) -> float:
    """Images a second that ``DeviceLoader`` puts on ``device``, epochs of
    ``dataset`` drawn with replacement to at least ``batch`` rows an
    epoch, for ``seconds``."""
    import torch

    from intro_tc_vae_tpu_torch.data import DeviceLoader

    class Replicated:  # the fixture's few images, indexed past their count
        def __init__(self, ds, n):
            self.ds, self.n = ds, n

        def __len__(self):
            return self.n

        def get_batch(self, idx):
            return self.ds.get_batch(np.asarray(idx) % len(self.ds))

        def get_batch_raw(self, idx):
            return self.ds.get_batch_raw(np.asarray(idx) % len(self.ds))

    loader = DeviceLoader(Replicated(dataset, 16 * batch), batch_size=batch, device=device,
                          shuffle=True, seed=0, transfer_dtype="uint8", device_cache="off")
    done, t0 = 0, None
    while t0 is None or time.perf_counter() - t0 < seconds:
        for x in loader:
            if t0 is None:  # the first batch warms up
                t0 = time.perf_counter()
                continue
            done += x.shape[0]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return done / (time.perf_counter() - t0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-root", default=os.path.join(REPO, "tests", "test_data"))
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    import torch

    from intro_tc_vae_tpu_torch.data import Synthetic, UkiyoE
    from intro_tc_vae_tpu_torch.runtime import native

    device = torch.device(a.device)
    results = {}
    for name, cache in (("ukiyo_cached", True), ("ukiyo_uncached", False)):
        ds = UkiyoE.load_data(resize=a.image_size, data_root=a.data_root, cache=cache)
        results[name] = measure(ds.get_batch, len(ds), a.batch, a.seconds)
    syn = Synthetic(image_size=a.image_size, cdim=3)
    results["synthetic"] = measure(syn.get_batch, len(syn), a.batch, a.seconds)
    cached = UkiyoE.load_data(resize=a.image_size, data_root=a.data_root, cache=True)
    results["loader_ukiyo_cached"] = loader_rate(cached, a.batch, a.seconds, device)
    out = {"metric": "loader_images_per_sec", "unit": "img/s", "batch": a.batch,
           "image_size": a.image_size, "device": str(device),
           "native_data_core": native.available(), **results}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
