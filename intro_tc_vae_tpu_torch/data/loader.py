"""Device feeding: shuffled epoch batching with a prefetch thread, uint8
transfer and a device-resident dataset cache.

Counterpart of ``intro_tc_vae_tpu/data/loader.py`` (``DeviceLoader``,
``WrappedDataLoader``): a shuffled, seeded, ``drop_last`` epoch order
drawn from the same ``np.random.RandomState`` stream, so both packages
see the same batches in the same order, as NCHW tensors here.

Three paths, chosen as the JAX loader chooses them:

* float32: the dataset's float batch, ``pre_process`` applied on the host.
* uint8 (``transfer_dtype`` "uint8", or "auto" where the dataset has a
  bit-exact raw path, ``get_batch_raw``): the raw batch crosses, a quarter
  of the bytes, and the train step normalizes it on the device
  (``solvers/base.py::u8_to_unit_f32``). ``pre_process`` is a float hook
  and is skipped there.
* cache (``device_cache`` "auto" or "force"): the whole uint8 array
  (``raw_array``) is put on the device once, transposed to NCHW, and each
  batch is gathered and conditionally width-flipped there; per step only
  the index and flip vectors cross. "auto" declines when the array exceeds
  the budget or half the device's free memory, and under data parallel
  (more than one process), as JAX declines under several processes;
  "force" raises instead. Each rank then transfers its own rows.

The first two run on a producer thread ``prefetch`` batches ahead, which
gathers on the host, copies into pinned memory and queues the copy to the
device on a stream of its own; the consumer's stream waits on an event
recorded after each copy, and the batch is marked as used on the
consumer's stream (``record_stream``) so the allocator does not reuse its
memory early. A producer error is raised on the consumer's side; a
consumer that stops early (a ``break``, an error in the loop) stops and
joins the producer when its iterator is closed. The cache path has no
thread: its per-step work on the host is two small copies.

There is no counterpart of JAX's ``CachedBatch``: it lets XLA fold the
cache gather into the train step's one program, and eager PyTorch has no
such program, so the loader yields the gathered uint8 batch.

Data parallel (``rows``): every rank draws the same seeded global order
and gathers only its own rows of each global batch of ``batch_size``;
the rows are its data index's (``parallel.batch_sharding``), so the ranks
of one model group get the same rows on every path.

``stack_steps`` K > 1 (the trainer's ``scan_steps``; JAX
``stack_steps``): each item holds K consecutive global batches as one
[K, B, C, H, W] tensor, drawn as one chunk of K·B indices of the same
order (an epoch yields ``per_epoch // K`` items, only whole chunks), and
a rank takes its rows of each of the K steps.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from intro_tc_vae_tpu_torch.parallel.distributed import process_count
from intro_tc_vae_tpu_torch.utils import tracing


@dataclasses.dataclass
class TransferStats:
    """What the host did for the batches so far: how many it made and the
    bytes it copied to the device. The host's time making them is the
    recorder's spans (``utils/tracing.py``): ``loader.batch`` on the cache
    path, ``loader.make`` (the producer thread) and ``loader.wait`` (the
    consumer) on the streamed ones."""

    batches: int = 0
    h2d_bytes: int = 0


class DeviceLoader:
    """Iterates this rank's batches of one epoch as NCHW tensors on
    ``device``: float32, or uint8 on the uint8 and cache paths.

    Args:
        dataset: anything with __len__ and get_batch(indices) (see
            data.datasets) or __getitem__.
        batch_size: the global batch of a step.
        device: where the batches go.
        shuffle: reshuffle each epoch.
        seed: the shuffle RNG's seed.
        drop_last: drop the trailing partial batch.
        rows: this rank's rows of each global batch; None for all.
        prefetch: batches staged ahead by the producer thread.
        pre_process: host-side fn(float NHWC batch) -> batch, before the
            transfer (the WrappedDataLoader hook; float path only).
        include_labels: yield (batch, labels) with labels on the host.
        transfer_dtype: "float32" | "uint8" | "auto".
        device_cache: "off" | "auto" | "force" (or False / True).
        device_cache_budget_mb: the most the cache may take.
        stack_steps: K global batches an item, [K, B, ...].
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        device: torch.device,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        rows: Optional[slice] = None,
        prefetch: int = 2,
        pre_process: Optional[Callable] = None,
        include_labels: bool = False,
        transfer_dtype: str = "float32",
        device_cache="off",
        device_cache_budget_mb: int = 4096,
        stack_steps: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rows = rows
        self.prefetch = max(1, prefetch)
        self.pre_process = pre_process
        self.include_labels = include_labels
        self.stack_steps = max(1, int(stack_steps))
        if transfer_dtype not in ("float32", "uint8", "auto"):
            raise ValueError(f"transfer_dtype: {transfer_dtype!r}")
        self.transfer_dtype = transfer_dtype
        self._want_raw = transfer_dtype in ("uint8", "auto")
        if device_cache is True:
            device_cache = "force"
        elif device_cache is False:
            device_cache = "off"
        if device_cache not in ("off", "auto", "force"):
            raise ValueError(f"device_cache: {device_cache!r}")
        self.device_cache = device_cache
        self.device_cache_budget_mb = device_cache_budget_mb
        self.cache: Optional[torch.Tensor] = None  # uint8 [N, C, H, W] on the device
        self._cache_ready = False
        self._rng = np.random.RandomState(seed)
        self.stats = TransferStats()
        tracing.watch(self)

    def counters(self) -> dict:
        return dataclasses.asdict(self.stats)

    def __len__(self) -> int:
        n = len(self.dataset)
        per_epoch = n // self.batch_size if self.drop_last else -(-n // self.batch_size)
        return per_epoch // self.stack_steps

    def _index_batches(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        k, b = self.stack_steps, self.batch_size
        if k > 1:
            stop = (n // (k * b)) * k * b  # whole chunks of K batches only
        else:
            stop = (n // b) * b if self.drop_last else n
        for start in range(0, stop, k * b):
            idx = order[start : start + k * b]
            if self.rows is not None:  # this rank's rows of each of the K steps
                idx = idx.reshape(k, -1)[:, self.rows].reshape(-1) if k > 1 else idx[self.rows]
            yield idx

    def _stacked(self, x: torch.Tensor) -> torch.Tensor:
        """[K*b, ...] -> [K, b, ...] when items stack K steps."""
        return x.view(self.stack_steps, -1, *x.shape[1:]) if self.stack_steps > 1 else x

    # ----- the streamed paths (float32, uint8) -----

    def _gather(self, idx: np.ndarray) -> np.ndarray:
        """This batch on the host, NHWC: uint8 on the raw path, else float32."""
        if self._want_raw:
            raw_fn = getattr(self.dataset, "get_batch_raw", None)
            raw = raw_fn(idx) if raw_fn is not None else None
            if raw is not None:
                return raw
            if self.transfer_dtype == "uint8":
                raise ValueError(
                    "transfer_dtype='uint8' but the dataset has no exact "
                    "uint8 path (get_batch_raw returned None)"
                )
            self._want_raw = False  # 'auto': settle on the float path
        if hasattr(self.dataset, "get_batch"):
            imgs = self.dataset.get_batch(idx)
        else:
            imgs = np.stack([self.dataset[i][0] for i in idx], axis=0)
        if self.pre_process is not None:
            imgs = self.pre_process(imgs)
        return imgs

    def _make_batch(self, idx: np.ndarray, stream):
        """Gather, lay out as NCHW (into pinned memory for a card) and queue
        the copy on ``stream``. Returns (tensor, event after its copy or
        None, labels or None)."""
        nhwc = torch.from_numpy(np.ascontiguousarray(self._gather(idx)))
        nchw = nhwc.permute(0, 3, 1, 2)
        event = None
        if stream is None:
            x = nchw.contiguous()
        else:
            host = torch.empty(nchw.shape, dtype=nchw.dtype, pin_memory=True)
            host.copy_(nchw)
            with torch.cuda.stream(stream):
                x = host.to(self.device, non_blocking=True)
                event = stream.record_event()
            self.stats.h2d_bytes += host.nbytes
        labels = self._labels_for(idx) if self.include_labels else None
        self.stats.batches += 1
        return x, event, labels

    def _produce(self, q: queue.Queue, stop: threading.Event) -> None:
        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        try:
            stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                      else None)
            for idx in self._index_batches():
                if stop.is_set():
                    return
                with tracing.span("loader.make"):
                    item = self._make_batch(idx, stream)
                if not put(("batch", item)):
                    return
        except Exception as e:  # raised on the consumer's side
            put(("error", e))
            return
        put(("end", None))

    def _streamed(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        producer = threading.Thread(target=self._produce, args=(q, stop),
                                    name="DeviceLoader-prefetch", daemon=True)
        producer.start()
        try:
            while True:
                with tracing.span("loader.wait"):
                    kind, item = q.get()
                if kind == "end":
                    return
                if kind == "error":
                    raise item
                x, event, labels = item
                if event is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(event)
                    x.record_stream(consumer)
                x = self._stacked(x)
                yield (x, labels) if self.include_labels else x
        finally:
            stop.set()
            producer.join()

    # ----- the device-resident cache -----

    def _setup_cache(self) -> bool:
        """Put the whole dataset in device memory once. Returns True when
        the cache path is active; 'force' raises on any ineligibility."""
        if self._cache_ready:
            return self.cache is not None
        self._cache_ready = True
        if self.device_cache == "off":
            return False

        def fail(why: str) -> bool:
            if self.device_cache == "force":
                raise ValueError(f"device_cache='force' but {why}")
            return False

        if process_count() > 1:
            return fail("data-parallel run (each rank takes the uint8 transfer path)")
        raw = getattr(self.dataset, "raw_array", lambda: None)()
        if raw is None:
            return fail("dataset has no bit-exact uint8 storage (raw_array)")
        budget = self.device_cache_budget_mb * (1 << 20)
        if raw.nbytes > budget:
            return fail(
                f"dataset is {raw.nbytes / 1e6:.0f} MB > "
                f"device_cache_budget_mb={self.device_cache_budget_mb}"
            )
        if self.device_cache == "auto" and self.device.type == "cuda":
            # leave room for parameters and activations (budget only elsewhere)
            free, _ = torch.cuda.mem_get_info(self.device)
            if raw.nbytes > free // 2:
                return fail("dataset exceeds half the free device memory")

        n, h, w, c = raw.shape
        cache = torch.empty((n, c, h, w), dtype=torch.uint8, device=self.device)
        chunk = max(1, (64 << 20) // max(1, h * w * c))  # ~64 MB a copy
        for s in range(0, n, chunk):  # transposed on the device, chunk by chunk
            rows = torch.from_numpy(np.ascontiguousarray(raw[s : s + chunk]))
            cache[s : s + chunk] = rows.to(self.device).permute(0, 3, 1, 2)
        self.cache = cache
        print(f"device cache: {raw.nbytes / 1e6:.0f} MB dataset resident "
              f"in device memory ({len(self.dataset):,} rows)")
        return True

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(arr)
        if self.device.type != "cuda":
            return t
        self.stats.h2d_bytes += t.nbytes
        return t.pin_memory().to(self.device, non_blocking=True)

    def _cached_batch(self, idx: np.ndarray):
        """Row gather and conditional width flip on the device: the same
        permutation the host path applies to the uint8 rows."""
        with tracing.span("loader.batch"):
            flags = getattr(self.dataset, "flip_flags", lambda n: None)(len(idx))
            x = self.cache.index_select(0, self._to_device(np.asarray(idx, np.int64)))
            if flags is not None:
                f = self._to_device(np.asarray(flags, np.uint8))
                x = torch.where(f.view(-1, 1, 1, 1) != 0, x.flip(3), x)
            x = self._stacked(x)
        self.stats.batches += 1
        return (x, self._labels_for(idx)) if self.include_labels else x

    def _labels_for(self, idx: np.ndarray) -> np.ndarray:
        ds = self.dataset
        if hasattr(ds, "latents_values"):
            return np.stack([ds.latents_values[i] for i in idx], axis=0)
        if hasattr(ds, "entries"):
            # label-only accessor: never decode images just for labels
            # (UkiyoE entries are (filename, label_code) tuples)
            return np.asarray([ds.entries[int(i)][1] for i in idx])
        return np.stack([ds[i][1] for i in idx], axis=0)

    def __iter__(self) -> Iterator:
        if self._setup_cache():
            return (self._cached_batch(idx) for idx in self._index_batches())
        return self._streamed()


class WrappedDataLoader:
    """API-parity shim (reference dataset.py:16-27): maps every batch of an
    inner iterable through ``pre_process``."""

    def __init__(self, data_loader, pre_process: Callable):
        self.dl = data_loader
        self.func = pre_process

    def __len__(self):
        return len(self.dl)

    def __iter__(self):
        for b in self.dl:
            if isinstance(b, tuple):
                yield self.func(*b)
            else:
                yield self.func(b)
