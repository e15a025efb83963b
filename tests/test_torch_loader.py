"""PyTorch port, the loader (``intro_tc_vae_tpu_torch/data/loader.py``)
against the JAX package's ``DeviceLoader``, on the CPU.

The same seed gives the same order and the same batches on every path:
float32, uint8 (normalized on the device by the 256-entry table,
``solvers/base.py::u8_to_unit_f32``) and the device-resident cache, with
flips drawn from the same injected RNG in both packages; the three paths
give the same float batch. Also: the cache's and the uint8 path's
eligibility rules, ``pre_process``, a producer error raised on the
consumer's side, a consumer that leaves early (no producer thread left),
labels, ``WrappedDataLoader``, ``num_workers`` as the prefetch depth, two
gloo ranks' uint8 rows against one process, and the port's trainer
against the JAX trainer on a dSprites-small subset in the float32 and
uint8 arms: the batches each steps on bit-equal, the losses finite, and
the port's losses of both arms equal.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from intro_tc_vae_tpu.data import datasets as jdatasets
from intro_tc_vae_tpu.data.loader import DeviceLoader as JDeviceLoader
from intro_tc_vae_tpu.solvers.base import u8_to_unit_f32 as ju8_to_unit_f32
from intro_tc_vae_tpu_torch.config import load_config
from intro_tc_vae_tpu_torch.data import DeviceLoader, WrappedDataLoader, datasets
from intro_tc_vae_tpu_torch.solvers.base import normalize_input, u8_to_unit_f32
from tests import _torch_dp_workers as workers
from tests._torch_threads import one_thread  # noqa: F401  (autouse)
from tests.test_torch_data import _ukiyo_pair, dsprites_root  # noqa: F401  (fixture)

CPU = torch.device("cpu")
PATHS = {"float32": dict(transfer_dtype="float32"),
         "uint8": dict(transfer_dtype="uint8"),
         "cache": dict(device_cache="force")}


def _imgs(n=40, size=8, c=3, seed=0):
    return np.random.RandomState(seed).randint(0, 256, size=(n, size, size, c), dtype=np.uint8)


def _flipping(base):
    """An array dataset of ``base``'s package that augments as UkiyoE does:
    flips drawn once per batch from its own RNG, applied by the host paths
    and, through ``flip_flags``, by the cache."""

    class Flipping(base):
        def __init__(self, imgs, flip_seed):
            super().__init__(imgs, np.arange(len(imgs))[:, None] * 1.5, resize=imgs.shape[1])
            self._flip_rng = np.random.RandomState(flip_seed)

        def flip_flags(self, n):
            return (self._flip_rng.rand(n) < 0.5).astype(np.uint8)

        def _flipped(self, arr):
            flags = self.flip_flags(len(arr)).astype(bool)
            arr = arr.copy()
            arr[flags] = arr[flags, :, ::-1, :]
            return arr

        def get_batch(self, indices):
            return self._flipped(super().get_batch(indices))

        def get_batch_raw(self, indices):
            return self._flipped(super().get_batch_raw(indices))

    return Flipping


_Flipping = _flipping(datasets._ArrayDataset)
_JFlipping = _flipping(jdatasets._ArrayDataset)


def _pair(kind):
    """(port dataset, JAX dataset, batch size) with the same bytes and the
    same flip stream."""
    if kind == "array":
        imgs = _imgs()
        lv = np.arange(len(imgs))[:, None] * 0.5
        return (datasets._ArrayDataset(imgs, lv, resize=8),
                jdatasets._ArrayDataset(imgs, lv, resize=8), 8)
    if kind == "flipping":
        imgs = _imgs(seed=1)
        return _Flipping(imgs, 11), _JFlipping(imgs, 11), 8
    ours, theirs = _ukiyo_pair(seed=5)
    return ours, theirs, 2


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).numpy()


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == "DeviceLoader-prefetch" and t.is_alive()]


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("kind", ["array", "flipping", "ukiyo"])
def test_batches_equal_jax(kind, path):
    """Two epochs of both packages' loaders at one seed: the same batches
    in the same order (uint8 where uint8 crosses), and their normalized
    float batches bit-equal."""
    ours_ds, theirs_ds, b = _pair(kind)
    ours = DeviceLoader(ours_ds, batch_size=b, device=CPU, seed=3, **PATHS[path])
    theirs = JDeviceLoader(theirs_ds, batch_size=b, seed=3, **PATHS[path])
    assert len(ours) == len(theirs)
    for _ in range(2):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == len(ours)
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert g.dtype == (torch.float32 if path == "float32" else torch.uint8)
            assert g.shape == (b, w.shape[3], w.shape[1], w.shape[2])
            np.testing.assert_array_equal(_nhwc(g), w)
            if path != "float32":
                np.testing.assert_array_equal(_nhwc(u8_to_unit_f32(g)),
                                              np.asarray(ju8_to_unit_f32(w)))
    assert (ours.cache is not None) == (path == "cache")


@pytest.mark.parametrize("kind", ["array", "flipping", "ukiyo"])
def test_three_paths_give_the_same_float_batches(kind):
    batches = {}
    for path, kw in PATHS.items():
        ds, _, b = _pair(kind)
        batches[path] = [normalize_input(x) for x in DeviceLoader(ds, b, CPU, seed=9, **kw)]
    for f, u, c in zip(batches["float32"], batches["uint8"], batches["cache"]):
        assert f.dtype == u.dtype == c.dtype == torch.float32
        torch.testing.assert_close(u, f, rtol=0, atol=0)
        torch.testing.assert_close(c, f, rtol=0, atol=0)


def test_table_equals_numpy_divide_for_every_value():
    u8 = torch.arange(256, dtype=torch.uint8).reshape(4, 1, 8, 8)
    np.testing.assert_array_equal(u8_to_unit_f32(u8).numpy().ravel(),
                                  np.arange(256, dtype=np.float32) / 255.0)
    assert normalize_input(u8).dtype == torch.float32
    x = torch.rand(2, 3)
    assert normalize_input(x) is x


# ---------------------------------------------------------------------------
# eligibility
# ---------------------------------------------------------------------------

def _u8_dataset():
    return datasets._ArrayDataset(_imgs(n=32), np.zeros((32, 1)), resize=8)


def test_auto_falls_back_without_raw_storage():
    ds = datasets.Synthetic(image_size=16, sizes=(2, 2, 2, 2))
    loader = DeviceLoader(ds, 4, CPU, transfer_dtype="auto", device_cache="auto")
    batches = list(loader)
    assert loader.cache is None
    assert {b.dtype for b in batches} == {torch.float32}


def test_auto_falls_back_over_budget():
    loader = DeviceLoader(_u8_dataset(), 8, CPU, device_cache="auto",
                          device_cache_budget_mb=0, transfer_dtype="auto")
    batches = list(loader)
    assert loader.cache is None and {b.dtype for b in batches} == {torch.uint8}


@pytest.mark.parametrize("ds,kw,why", [
    (datasets.Synthetic(image_size=16, sizes=(2, 2, 2, 2)), {}, "no bit-exact uint8 storage"),
    (_u8_dataset(), dict(device_cache_budget_mb=0), "device_cache_budget_mb=0"),
], ids=["no_raw_storage", "over_budget"])
def test_force_raises(ds, kw, why):
    loader = DeviceLoader(ds, 4, CPU, device_cache="force", **kw)
    with pytest.raises(ValueError, match=f"device_cache='force' but .*{why}"):
        list(loader)


def test_bool_aliases_and_bad_values():
    assert DeviceLoader(_u8_dataset(), 8, CPU, device_cache=True).device_cache == "force"
    assert DeviceLoader(_u8_dataset(), 8, CPU, device_cache=False).device_cache == "off"
    with pytest.raises(ValueError, match="device_cache: 'maybe'"):
        DeviceLoader(_u8_dataset(), 8, CPU, device_cache="maybe")
    with pytest.raises(ValueError, match="transfer_dtype: 'f16'"):
        DeviceLoader(_u8_dataset(), 8, CPU, transfer_dtype="f16")


def test_uint8_raises_without_raw_path_and_auto_settles_on_float():
    ds = datasets.Synthetic(image_size=16, sizes=(2, 2, 2, 2))
    with pytest.raises(ValueError, match="transfer_dtype='uint8' but the dataset"):
        list(DeviceLoader(ds, 4, CPU, transfer_dtype="uint8"))
    auto = DeviceLoader(ds, 4, CPU, transfer_dtype="auto")
    assert {b.dtype for b in auto} == {torch.float32}
    assert not auto._want_raw
    assert not _prefetch_threads()


# ---------------------------------------------------------------------------
# the producer thread
# ---------------------------------------------------------------------------

class _Counting:
    """A float dataset that counts its batches (and can fail at one)."""

    def __init__(self, n=80, fail_at=None):
        self.inner = datasets.Synthetic(image_size=8, sizes=(5, 2, 4, 4))  # 160
        self.n, self.fail_at, self.calls = n, fail_at, 0

    def __len__(self):
        return self.n

    def get_batch(self, idx):
        self.calls += 1
        if self.calls == self.fail_at:
            raise RuntimeError(f"bad batch {self.calls}")
        return self.inner.get_batch(idx)


def test_pre_process_runs_on_the_float_path_only():
    ds = datasets.Synthetic(image_size=16, sizes=(2, 2, 2, 2))
    b = next(iter(DeviceLoader(ds, 4, CPU, pre_process=lambda x: x * 0.5)))
    assert float(b.max()) <= 0.5
    u8 = list(DeviceLoader(_u8_dataset(), 8, CPU, shuffle=False, transfer_dtype="auto",
                           pre_process=lambda x: x * 0.0))
    np.testing.assert_array_equal(_nhwc(u8[0]), _u8_dataset().imgs[:8])


def test_a_producer_error_is_raised_on_the_consumer_side():
    ds = _Counting(fail_at=3)
    got = []
    with pytest.raises(RuntimeError, match="bad batch 3"):
        for b in DeviceLoader(ds, 8, CPU):
            got.append(b)
    assert len(got) == 2
    assert not _prefetch_threads()

    def boom(b):
        raise RuntimeError("bad pre_process")

    with pytest.raises(RuntimeError, match="bad pre_process"):
        list(DeviceLoader(ds, 8, CPU, pre_process=boom))
    assert not _prefetch_threads()


@pytest.mark.parametrize("prefetch", [1, 3])
def test_the_producer_stays_prefetch_ahead_and_stops_with_the_consumer(prefetch):
    """The producer makes at most ``prefetch`` batches ahead of the one
    consumed (plus the one in its hands); a consumer that leaves after one
    batch (a ``break``) leaves no producer thread."""
    ds = _Counting(n=160)
    loader = DeviceLoader(ds, 8, CPU, prefetch=prefetch)
    for b in loader:
        deadline = time.monotonic() + 5.0
        while ds.calls < 1 + prefetch and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.1)
        assert ds.calls <= 1 + prefetch + 1
        break
    assert not _prefetch_threads()
    it = iter(loader)
    next(it)
    it.close()
    assert not _prefetch_threads()
    assert len(list(loader)) == 20  # a new epoch after the early exits


def test_many_loaders_at_once_keep_their_order():
    """16 loaders consumed at once by 16 threads, with a short switch
    interval: each yields its own seed's batches, in order."""
    ds = datasets.Synthetic(image_size=8, sizes=(4, 2, 4, 4))
    want = {s: [b.clone() for b in DeviceLoader(ds, 8, CPU, seed=s)] for s in range(16)}
    got, errors = {}, []

    def consume(seed):
        try:
            got[seed] = list(DeviceLoader(ds, 8, CPU, seed=seed, prefetch=1))
        except Exception as e:  # reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=consume, args=(s,)) for s in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors
    for s in range(16):
        assert len(got[s]) == len(want[s]) == 16
        for g, w in zip(got[s], want[s]):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert not _prefetch_threads()


def test_stats_count_batches_and_no_copy_on_the_cpu():
    loader = DeviceLoader(_u8_dataset(), 8, CPU, transfer_dtype="uint8")
    list(loader)
    assert loader.stats.batches == 4 and loader.stats.h2d_bytes == 0
    assert loader.stats.host_s > 0


# ---------------------------------------------------------------------------
# labels, WrappedDataLoader, the trainer's wiring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("kind", ["array", "ukiyo"])
def test_labels_equal_jax(kind, path):
    ours_ds, theirs_ds, b = _pair(kind)
    ours = DeviceLoader(ours_ds, b, CPU, seed=4, include_labels=True, **PATHS[path])
    theirs = JDeviceLoader(theirs_ds, b, seed=4, include_labels=True, **PATHS[path])
    pairs = list(zip(ours, theirs))
    assert len(pairs) == len(ours)
    for (g, gl), (w, wl) in pairs:
        np.testing.assert_array_equal(gl, np.asarray(wl))
        np.testing.assert_array_equal(_nhwc(g), np.asarray(w))


def test_wrapped_data_loader():
    inner = [np.ones((2, 2)), np.zeros((2, 2))]
    wrapped = WrappedDataLoader(inner, lambda b: b + 1)
    out = list(wrapped)
    assert len(wrapped) == 2
    np.testing.assert_allclose(out[0], 2 * np.ones((2, 2)))
    loader = DeviceLoader(_u8_dataset(), 8, CPU, shuffle=False, include_labels=True,
                          transfer_dtype="uint8")
    mapped = list(WrappedDataLoader(loader, lambda x, y: (normalize_input(x), y.shape)))
    assert len(mapped) == 4 and mapped[0][1] == (8, 1)
    assert mapped[0][0].dtype == torch.float32


@pytest.mark.parametrize("num_workers,prefetch", [(0, 1), (2, 2), (5, 5)])
def test_the_trainer_builds_the_loader_from_the_config(num_workers, prefetch):
    from intro_tc_vae_tpu_torch.train import setup

    config = load_config(update_dict=dict(
        solver="vae", dataset="synthetic_small", arch="conv", z_dim=8, batch_size=8,
        num_workers=num_workers, transfer_dtype="float32", device_cache="off",
        device_cache_budget_mb=7, seed=1))
    loader = setup(config, device=CPU).loader
    assert loader.prefetch == prefetch
    assert (loader.transfer_dtype, loader.device_cache) == ("float32", "off")
    assert loader.device_cache_budget_mb == 7


def test_two_gloo_ranks_transfer_their_rows_as_uint8(tmp_path):
    """Under data parallel ``auto`` declines the cache and ``force`` raises;
    each rank transfers its rows of every global batch as uint8, and the
    ranks' rows side by side are one process's batches."""
    imgs = _imgs(n=48, seed=6)
    ranks = workers.run_ranks(workers.loader_rows, 2, (imgs, 8, 2), tmp_path)
    ds = datasets._ArrayDataset(imgs, np.zeros((48, 1)), resize=8)
    one = list(DeviceLoader(ds, 8, CPU, seed=2, transfer_dtype="uint8"))
    assert [r["rows"] for r in ranks] == [(0, 4), (4, 8)]
    for r in ranks:
        assert not r["cache"]
        assert "data-parallel run" in r["force_error"]
        assert len(r["batches"]) == len(one) == 6
    for k, want in enumerate(one):
        got = torch.cat([r["batches"][k] for r in ranks])
        assert got.dtype == torch.uint8
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# end to end: the two trainers on a dSprites-small subset
# ---------------------------------------------------------------------------

def _dsprites_small_subset(module, root):
    """load_dataset replaced as the JAX schema test replaces it: 64 rows of
    dSprites-small, targeted at their stored 8x8 (so the uint8 path
    exists), widths [8, 16]."""
    real = module.load_dataset

    def load(name, data_root=None):
        ds, _, _, cdim = real("dsprites_small", data_root=root)
        ds.imgs, ds.latents_values = ds.imgs[:64], ds.latents_values[:64]
        ds.resize = 8
        return ds, 8, [8, 16], cdim

    return load


E2E = dict(solver="tc", dataset="dsprites_small", arch="conv", num_epochs=1, batch_size=16,
           z_dim=8, lr=1e-3, seed=5, test_iter=10**6, save_interval=10**6,
           use_tensorboard=False, device_cache="off")


@pytest.fixture(scope="module")
def port_arms(dsprites_root, tmp_path_factory):
    """The port's trainer in the float32 and uint8 arms: the batches each
    step saw and the history."""
    from intro_tc_vae_tpu_torch import train
    from intro_tc_vae_tpu_torch.solvers.base import VAESolver

    runs = {}
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(train, "load_dataset", _dsprites_small_subset(train, dsprites_root))
        step = VAESolver.train_step
        for arm in ("float32", "uint8"):
            seen = []

            def spy(self, state, batch, noise=None, seen=seen):
                seen.append(batch.clone())
                return step(self, state, batch, noise)

            mp.setattr(VAESolver, "train_step", spy)
            tmp = tmp_path_factory.mktemp(f"port_{arm}")
            config = load_config(update_dict=dict(E2E, transfer_dtype=arm,
                                                  checkpoint_dir=str(tmp / "saves")))
            state = train.train_soft_intro_vae(config, device=CPU)
            runs[arm] = (seen, state.history)
    finally:
        mp.undo()
    return runs


@pytest.mark.parametrize("arm", ["float32", "uint8"])
def test_trainer_steps_on_the_jax_trainers_batches(arm, port_arms, dsprites_root, tmp_path,
                                                   monkeypatch):
    import intro_tc_vae_tpu.train as T
    from intro_tc_vae_tpu.config import load_config as jload_config

    seen = []

    class Spy(JDeviceLoader):
        def __iter__(self):
            for b in super().__iter__():
                seen.append(np.asarray(ju8_to_unit_f32(b) if b.dtype == np.uint8 else b))
                yield b

    monkeypatch.setattr(T, "DeviceLoader", Spy)
    monkeypatch.setattr(T, "load_dataset", _dsprites_small_subset(jdatasets, dsprites_root))
    config = jload_config(update_dict=dict(E2E, transfer_dtype=arm, data_parallel=1,
                                           log_dir=str(tmp_path / "tb"),
                                           checkpoint_dir=str(tmp_path / "ckpt")))
    jstate = T.train_soft_intro_vae(config)
    assert int(jstate.step) == 4
    batches, history = port_arms[arm]
    assert len(batches) == len(seen) == len(history) == 4
    for ours, theirs in zip(batches, seen):
        assert ours.dtype == torch.float32 and ours.shape == (16, 1, 8, 8)
        np.testing.assert_array_equal(_nhwc(ours), theirs)
    assert all(np.isfinite(r[k]) for r in history for k in ("loss_enc", "loss_dec"))
    # the two arms step on the same floats, so the port's losses are equal
    other = port_arms["uint8" if arm == "float32" else "float32"][1]
    assert [r["loss_enc"] for r in history] == [r["loss_enc"] for r in other]
