"""PyTorch port: the trainer, the CLI, the loader and config surface, and
the package's import hygiene. CPU only: the trainer runs here only
because the tests pass ``device=torch.device("cpu")`` explicitly. Every
run writes its checkpoints and traces under the test's ``tmp_path``."""

import dataclasses
import glob
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from intro_tc_vae_tpu.config import load_config as jload_config
from intro_tc_vae_tpu.data import DeviceLoader as JDeviceLoader
from intro_tc_vae_tpu.data import Synthetic as JSynthetic
from intro_tc_vae_tpu_torch import main
from intro_tc_vae_tpu_torch.config import load_config
from intro_tc_vae_tpu_torch.data import DeviceLoader, Synthetic, load_dataset
from intro_tc_vae_tpu_torch.train import train_soft_intro_vae
from tests._torch_threads import one_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "configs", "intro_tc_ukiyo64.json")
SMALL_RUN = dict(dataset="synthetic_small", tc_impl="pallas", num_epochs=1,
                 use_tensorboard=False, batch_size=8, z_dim=8)
CPU = torch.device("cpu")


def small_config(tmp_path, path=FLAGSHIP, **update):
    """``path`` at the synthetic_small size, saving under ``tmp_path``."""
    return load_config(path, {**SMALL_RUN, "checkpoint_dir": str(tmp_path / "saves"),
                              "log_dir": str(tmp_path / "runs"), **update})


def test_train_one_epoch_on_cpu(tmp_path):
    """The flagship recipe (bf16 compute, paired, tc_impl 'pallas') at the
    synthetic_small size: 64 images / batch 8 = 8 steps, finite losses, in
    step order; after the epoch, an eval-mode decode of one batch of noise
    and the final checkpoint, named as the JAX package names it."""
    config = small_config(tmp_path)
    state = train_soft_intro_vae(config, device=CPU)
    assert state.step == len(state.history) == 8
    assert [r["step"] for r in state.history] == list(range(1, 9))
    for record in state.history:
        assert all(math.isfinite(record[k]) for k in ("lossE", "lossD", "loss_kl",
                                                      "loss_rec", "expelbo_r"))
        assert record["epoch"] == 0 and record["seconds"] > 0
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert state.samples.shape == (8, 3, 32, 32)
    assert 0.0 <= float(state.samples.min()) <= float(state.samples.max()) <= 1.0
    assert os.listdir(tmp_path / "saves") == [f"{config.fingerprint()}model_epoch_0_iter_8"]


def test_cli_requires_cuda(monkeypatch):
    """No CPU fallback: without CUDA the entry point refuses to run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main.cli(["-f", FLAGSHIP, "-u", '{"dataset": "synthetic", "tc_impl": "pallas", '
                  '"num_epochs": 1, "use_tensorboard": false}'])


def test_train_model_parallel_on_two_cpu_ranks(tmp_path):
    """``model_parallel: 2`` (the one option that once raised) on two gloo
    ranks of one data index, with the writer on (test_iter 4: the image
    grids and scores of steps 0 and 4 run on a whole copy the two ranks
    gather) and ``min_dim`` lowered to 8, so the small model is cut: 8
    finite steps equal on both ranks, the single-device TC route (5 calls a
    step), replicated leaves and the gathered state bit-equal, one final
    checkpoint and one TensorBoard run, both from rank 0."""
    from tests import _torch_dp_workers, _torch_tp_workers

    update = {**SMALL_RUN, "model_parallel": 2, "use_tensorboard": True, "test_iter": 4,
              "checkpoint_dir": str(tmp_path / "saves"), "log_dir": str(tmp_path / "runs")}
    a, b = _torch_dp_workers.run_ranks(_torch_tp_workers.train_tp, 2, (FLAGSHIP, update),
                                       tmp_path / "ranks")
    for out in (a, b):
        assert [r["step"] for r in out["history"]] == list(range(1, 9))
        assert all(math.isfinite(r[k]) for r in out["history"] for k in ("lossE", "lossD"))
        assert out["routes"] == {"gathered": 0, "single": 40}
        assert out["sharded"]
    assert [{k: v for k, v in r.items() if k != "seconds"} for r in a["history"]] == \
        [{k: v for k, v in r.items() if k != "seconds"} for r in b["history"]]
    assert a["replicated"] == b["replicated"] and a["whole"] == b["whole"]
    config = load_config(FLAGSHIP, update)
    assert os.listdir(tmp_path / "saves") == [f"{config.fingerprint()}model_epoch_0_iter_8"]
    assert len(glob.glob(str(tmp_path / "runs*"))) == 1  # log_dir + run_comment()


@pytest.mark.parametrize("update", [
    dict(conv_impl="pallas"), dict(arch="res"), dict(solver="vae"),
    dict(resume="auto"), dict(profile=True), dict(anomaly_detection=True),
    dict(optimizer="sgd"), dict(optimizer="lamb"), dict(async_checkpoint=True),
    dict(save_interval=0), dict(use_tensorboard=True, test_iter=4),
    dict(scan_steps=2), dict(remat="pass"), dict(tc_sampling="weighted", tc_impl="xla"),
    dict(arch="inception"), dict(kl_kind="tc_full"), dict(pack_predict=2), dict(tile_rows=16),
], ids=lambda u: ",".join(f"{k}={v}" for k, v in u.items()))
def test_options_that_once_raised_train(tmp_path, update):
    """The flagship recipe with each option at the synthetic_small size:
    8 finite steps (at this width no conv routes to the kernels; the
    routed widths are tests/test_torch_conv.py's and _models.py's).
    ``resume: "auto"`` finds no checkpoint and starts fresh; ``profile``
    stops at the epoch's end, before iteration 50, without a final save;
    ``anomaly_detection`` is on at every optimizer call and off after;
    ``use_tensorboard`` writes one run under ``log_dir`` (the tags are
    tests/test_torch_writer.py's); ``scan_steps: 2`` makes the 8 steps in
    4 calls; ``pack_predict: 2`` and ``tile_rows: 16`` build their modules
    (the options held to the JAX package are
    tests/test_torch_solver_surface.py's and tests/test_torch_options.py's)."""
    from torch.optim.optimizer import register_optimizer_step_pre_hook

    config = small_config(tmp_path, **update)
    anomaly = set()
    handle = register_optimizer_step_pre_hook(lambda *a: anomaly.add(torch.is_anomaly_enabled()))
    try:
        state = train_soft_intro_vae(config, device=CPU)
    finally:
        handle.remove()
    assert anomaly == {config.anomaly_detection}
    assert not torch.is_anomaly_enabled()
    assert state.step == len(state.history) == 8
    assert all(math.isfinite(r[k]) for r in state.history for k in ("loss_enc", "loss_dec"))
    saves = sorted(os.listdir(tmp_path / "saves")) if (tmp_path / "saves").exists() else []
    assert saves == ([] if config.profile
                     else [f"{config.fingerprint()}model_epoch_0_iter_8"])
    predict = type(state.model.decoder.main["predict"]).__name__
    assert predict == {2: "PackedPredictConv"}.get(
        config.pack_predict, "StripTiledConv" if config.tile_rows > 0 else "Conv2d")
    runs = sorted(os.listdir(tmp_path)) if config.use_tensorboard else []
    assert runs == (["runs" + config.run_comment(), "saves"] if config.use_tensorboard
                    else [])


UKIYO_FIXTURE = os.path.join(REPO, "tests", "test_data")


@pytest.mark.parametrize("update,path", [
    (dict(device_cache="force"), "cache"),
    (dict(transfer_dtype="uint8", device_cache="off"), "uint8"),
    (dict(), "cache"),  # the defaults, auto / auto: the cache engages
    (dict(device_cache="off"), "uint8"),  # auto transfer: uint8, the cache decoded
    (dict(transfer_dtype="float32", device_cache="off"), "float32"),
], ids=["device_cache=force", "transfer_dtype=uint8", "defaults", "device_cache=off",
        "transfer_dtype=float32"])
def test_options_that_once_raised_train_on_the_ukiyo_fixture(tmp_path, monkeypatch, capsys,
                                                              update, path):
    """The flagship config on its own dataset, ukiyo_e64, read from the
    fixture (5 images, tests/test_data), with each data path: 2 epochs of
    one step of 4 images, finite losses; the batches the loop steps on are
    float32 in [0, 1] whichever dtype crossed, and the cache reports itself
    where it engages. Widths cut to [8, 16], as the JAX test does."""
    from intro_tc_vae_tpu_torch import train

    def load(name, data_root=None):
        ds, size, _, cdim = load_dataset(name, data_root)
        return ds, size, [8, 16], cdim

    monkeypatch.setattr(train, "load_dataset", load)
    runs, stepped = _capture_run(monkeypatch), _capture_steps(monkeypatch)
    config = small_config(tmp_path, dataset="ukiyo_e64", data_root=UKIYO_FIXTURE,
                          batch_size=4, num_epochs=2, **update)
    state = train_soft_intro_vae(config, device=CPU)
    assert state.step == len(state.history) == 2
    assert all(math.isfinite(r[k]) for r in state.history for k in ("loss_enc", "loss_dec"))
    loader = runs[0].loader
    assert (loader.cache is not None) == (path == "cache")
    assert ("device cache: 0 MB dataset resident" in capsys.readouterr().out) == (path == "cache")
    assert {b.dtype for b in stepped} == {torch.float32}
    assert all(0.0 <= float(b.min()) and float(b.max()) <= 1.0 for b in stepped)
    assert loader.stats.batches == 2


def _capture_steps(monkeypatch) -> list:
    """Every batch the solvers step on from now on, as the step sees it:
    ``train_step`` takes the batch as it crossed (uint8 on the uint8 and
    cache paths) and normalizes it on the device, as the JAX step does."""
    from intro_tc_vae_tpu_torch.solvers.base import VAESolver, normalize_input

    stepped, step = [], VAESolver.train_step

    def spy(self, state, batch, noise=None):
        stepped.append(normalize_input(batch))
        return step(self, state, batch, noise)

    monkeypatch.setattr(VAESolver, "train_step", spy)
    return stepped


@pytest.mark.parametrize("path,update", [
    ("vae_synthetic.json", {"conv_impl": "pallas"}),
    ("tc_dsprites.json", {"tc_impl": "pallas", "conv_impl": "hybrid"}),
], ids=["vae_synthetic", "tc_dsprites"])
def test_elbo_configs_train_on_cpu(tmp_path, path, update):
    """configs/vae_synthetic.json (res arch, vae solver) and
    configs/tc_dsprites.json on the synthetic dataset (conv arch, tc
    solver), both fp32, at the synthetic_small size: 8 finite steps, the
    metric names of the JAX ELBO step, and the parameters moved."""
    config = small_config(tmp_path, os.path.join(REPO, "configs", path),
                          **update, dataset="synthetic_small")
    torch.manual_seed(config.seed)
    state = train_soft_intro_vae(config, device=CPU)
    assert state.step == len(state.history) == 8
    for record in state.history:
        assert {"loss_enc", "loss_dec", "loss_kl", "loss_rec", "kl_loss_unscaled",
                "r_loss_unscaled", "fc_grad_norm"} <= set(record)
        assert all(math.isfinite(v) for v in record.values())
        assert record["loss_enc"] == record["loss_dec"]
    assert state.history[-1]["loss_enc"] != state.history[0]["loss_enc"]


def _tf32_flags():
    return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)


@pytest.fixture
def tf32_on():
    """Both TF32 switches on for the test, then back as they were."""
    saved = _tf32_flags()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("precision,during", [("fp32", (False, False)),
                                              ("bf16", (True, True))])
def test_precision_fp32_turns_tf32_off_for_the_run(tmp_path, tf32_on, precision, during):
    """precision "fp32" computes in fp32 proper: both TF32 switches are off
    at every optimizer call of the run and back on after it; a bf16 run
    leaves them as they were."""
    from torch.optim.optimizer import register_optimizer_step_pre_hook

    seen = []
    handle = register_optimizer_step_pre_hook(lambda *a: seen.append(_tf32_flags()))
    try:
        config = small_config(tmp_path, precision=precision)
        state = train_soft_intro_vae(config, device=CPU)
    finally:
        handle.remove()
    assert len(seen) == 2 * state.step == 16  # the encoder's and the decoder's, 8 steps
    assert set(seen) == {during}
    assert _tf32_flags() == (True, True)


def test_precision_fp32_restores_tf32_when_the_run_raises(tmp_path, tf32_on):
    from torch.optim.optimizer import register_optimizer_step_pre_hook

    def fail(*args):
        assert _tf32_flags() == (False, False)
        raise FloatingPointError("stop")

    handle = register_optimizer_step_pre_hook(fail)
    try:
        with pytest.raises(FloatingPointError, match="stop"):
            train_soft_intro_vae(small_config(tmp_path, precision="fp32"), device=CPU)
    finally:
        handle.remove()
    assert _tf32_flags() == (True, True)


def test_every_config_loads_like_jax():
    paths = sorted(glob.glob(os.path.join(REPO, "configs", "*.json")))
    assert paths
    for path in paths:
        assert (dataclasses.asdict(load_config(path))
                == dataclasses.asdict(jload_config(path))), path


def test_loader_matches_jax_order():
    """Same seed, same shuffled drop_last epochs, as NCHW float32."""
    ds, _, _, _ = load_dataset("synthetic_small")
    jds = JSynthetic(image_size=32, cdim=3, sizes=(2, 2, 4, 4))
    ours = DeviceLoader(ds, batch_size=24, device=CPU, seed=5)
    ref = JDeviceLoader(jds, batch_size=24, seed=5)
    assert len(ours) == len(ref) == 2
    for _ in range(2):  # two epochs: the order is reshuffled, identically
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g.shape == (24, 3, 32, 32) and g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy().transpose(0, 2, 3, 1), np.asarray(w))


def test_synthetic_matches_jax():
    ours, theirs = Synthetic(), JSynthetic()
    idx = np.arange(0, len(ours), 37)
    assert len(ours) == len(theirs) == 1280
    np.testing.assert_array_equal(ours.get_batch(idx), theirs.get_batch(idx))
    np.testing.assert_array_equal(ours.latents_values, theirs.latents_values)


def test_port_imports_no_jax():
    """Importing the port and every module in it loads no jax, flax,
    optax, triton or JAX-package module."""
    code = """
import importlib, pkgutil, sys
import intro_tc_vae_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "triton",
                                    "intro_tc_vae_tpu"))
print(len([n for n in sys.modules if n.startswith("intro_tc_vae_tpu_torch")]), bad)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.split(" ", 1)
    assert int(n_modules) >= 20
    assert bad.strip() == "[]"


# ---------------------------------------------------------------------------
# the loop's modes: profile, anomaly detection, the metric ring
# ---------------------------------------------------------------------------

class _Scaled:
    """A dataset whose batches are the wrapped one's times ``factor`` from
    batch index ``start`` on (NaN: every value NaN)."""

    def __init__(self, dataset, factor: float, start: int = 0):
        self.dataset, self.factor, self.start = dataset, factor, start
        self.calls = 0

    def __len__(self):
        return len(self.dataset)

    def get_batch(self, idx):
        x = self.dataset.get_batch(idx)
        self.calls += 1
        return x * self.factor if self.calls > self.start else x


def _patch_dataset(monkeypatch, factor: float, start: int = 0) -> None:
    from intro_tc_vae_tpu_torch import train

    def load(name, data_root=None):
        ds, size, channels, cdim = load_dataset(name, data_root)
        return _Scaled(ds, factor, start), size, channels, cdim

    monkeypatch.setattr(train, "load_dataset", load)


def _capture_run(monkeypatch) -> list:
    """The ``train.Run`` of the next run, appended to the returned list."""
    from intro_tc_vae_tpu_torch import train

    runs, setup = [], train.setup

    def capture(*args, **kwargs):
        runs.append(setup(*args, **kwargs))
        return runs[-1]

    monkeypatch.setattr(train, "setup", capture)
    return runs


def test_profile_stops_at_iteration_50_and_writes_a_trace(tmp_path, capsys):
    """profile: true traces the first epoch and stops after the step at
    iteration 50 (JAX train.py:297-315): 51 steps of the 64 an epoch of
    batch 1 has, the flight recorder's summary printed (its spans and
    device phases a step), a Chrome trace written that carries the
    recorder's spans as ``itcvae::`` ranges, no final checkpoint."""
    config = small_config(tmp_path, solver="vae", batch_size=1, profile=True, num_epochs=2)
    state = train_soft_intro_vae(config, device=CPU)
    assert state.step == len(state.history) == 51
    assert [r["step"] for r in state.history] == list(range(1, 52))
    traces = glob.glob(str(tmp_path / "runs" / "profile" / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("conv2d" in e.get("name", "") for e in events)
    assert {"itcvae::step", "itcvae::step.eager"} <= {e.get("name") for e in events}
    out = capsys.readouterr().out
    assert "profile: {'units': 51" in out and "profiler trace written to" in out
    summary = out[out.index("profile: {"):].splitlines()[0]
    assert all(f"'{name}'" in summary for name in ("step", "step.push", "ring.drain",
                                                   "fwd", "bwd", "opt"))
    assert not (tmp_path / "saves").exists()


def test_anomaly_detection_raises_on_an_out_of_range_batch(tmp_path, monkeypatch):
    """Every batch is checked to lie in [0, 1] (JAX train.py:166-169); the
    anomaly switch is off again after the run raises."""
    _patch_dataset(monkeypatch, factor=2.0, start=3)
    runs = _capture_run(monkeypatch)
    with pytest.raises(ValueError, match=r"outside \[0, 1\]"):
        train_soft_intro_vae(small_config(tmp_path, anomaly_detection=True), device=CPU)
    assert not torch.is_anomaly_enabled()
    assert runs[0].state.step == 3  # the fourth batch was refused before its step
    assert len(runs[0].solver.metric_ring) == 0


class _NanBackward(torch.autograd.Function):
    """Identity forward, NaN gradient."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * float("nan")


def test_anomaly_detection_raises_on_a_nan_made_in_backward(tmp_path, monkeypatch):
    """With anomaly_detection the first backward function that returns a
    NaN raises at once; the anomaly switch is off again afterwards. The
    same NaN without it raises only when the ring reads the non-finite loss
    of a later step."""
    from intro_tc_vae_tpu_torch import ops

    reparameterize = ops.reparameterize
    monkeypatch.setattr(ops, "reparameterize",
                        lambda mu, logvar, eps: _NanBackward.apply(reparameterize(mu, logvar, eps)))
    runs = _capture_run(monkeypatch)
    with pytest.raises(RuntimeError, match="returned nan values"):
        train_soft_intro_vae(small_config(tmp_path, anomaly_detection=True), device=CPU)
    assert not torch.is_anomaly_enabled()
    assert runs[0].state.step == 0
    # without it: phase D of step 1 already runs the encoder the NaN updated
    with pytest.raises(RuntimeError, match="non-finite loss_dec: nan"):
        train_soft_intro_vae(small_config(tmp_path), device=CPU)
    assert not torch.is_anomaly_enabled()
    assert runs[1].state.step == 8  # read at the epoch's end


def test_nan_loss_raises_from_the_ring_and_the_finally_drains(tmp_path, monkeypatch):
    """A NaN batch at step 1 (16 steps an epoch): the loop reads the ring
    once ring_depth + 2 steps are queued, keeping the newest 2, so the
    non-finite loss raises after step ring_depth + 2, ring_depth + 1 steps
    after the one that made it (JAX train.py:294-295). The drain that
    raised and the ``finally``'s drain of the newest 2 are both recorded,
    unchecked past the raise: the history holds every queued step, the
    blow-up included, as JAX writes them all to TensorBoard."""
    from intro_tc_vae_tpu_torch.solvers.base import RING_DEPTH

    _patch_dataset(monkeypatch, factor=float("nan"))
    runs = _capture_run(monkeypatch)
    with pytest.raises(RuntimeError, match="non-finite loss_enc: nan"):
        train_soft_intro_vae(small_config(tmp_path, batch_size=4), device=CPU)
    run = runs[0]
    assert RING_DEPTH == 8
    assert run.state.step == RING_DEPTH + 2
    assert len(run.solver.metric_ring) == 0
    history = run.state.history
    assert [r["step"] for r in history] == list(range(1, RING_DEPTH + 3))
    assert all(r["epoch"] == 0 and r["seconds"] > 0 for r in history)
    assert math.isnan(history[0]["loss_enc"])
    assert not (tmp_path / "saves").exists()


def test_metric_ring_reads_in_step_order_behind_the_newest():
    from intro_tc_vae_tpu_torch.solvers.base import MetricRing

    ring = MetricRing()
    for step in range(1, 11):
        ring.push({"a": torch.tensor(step * 1.5), "b": torch.tensor(-step, dtype=torch.int64)},
                  step)
    assert len(ring) == 10
    first = ring.drain(keep_tail=2)
    assert [s for _, s in first] == list(range(1, 9))
    assert first[0][0] == {"a": 1.5, "b": -1.0}
    assert len(ring) == 2 and ring.drain(keep_tail=2) == []
    assert [m["a"] for m, _ in ring.drain()] == [13.5, 15.0]
    assert len(ring) == 0


def test_eval_mode_encode_and_decode_restore_the_mode():
    """encode/decode with train=False: eval mode (running statistics, which
    stay as they were) under no_grad, and the module's mode back after."""
    from intro_tc_vae_tpu_torch.models import Decoder, Encoder
    from intro_tc_vae_tpu_torch.solvers.base import decode, encode

    small = dict(arch="conv", cdim=3, zdim=8, channels=(16, 32), image_size=32)
    torch.manual_seed(0)
    enc, dec = Encoder(**small), Decoder(**small)
    x = torch.rand(4, 3, 32, 32)
    enc(x)  # a train-mode pass: running statistics move off their init
    stats = {k: v.clone() for k, v in enc.state_dict().items()}
    for module, fn, arg in ((enc, encode, x), (dec, decode, torch.randn(4, 8))):
        for training in (True, False):
            module.train(training)
            out = fn(module, arg, train=False)
            assert module.training is training
            module.eval()
            want = module(arg)
            module.train(training)
            outs = out if isinstance(out, tuple) else (out,)
            wants = want if isinstance(want, tuple) else (want,)
            for o, w in zip(outs, wants):
                assert not o.requires_grad
                torch.testing.assert_close(o, w.detach(), rtol=0, atol=0)
    for k, v in enc.state_dict().items():
        assert torch.equal(v, stats[k]), k


def test_check_non_finite_gradients_names_the_parameters(capsys):
    from intro_tc_vae_tpu_torch.utils import check_non_finite_gradients, check_non_finite_gradints

    net = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    assert check_non_finite_gradints is check_non_finite_gradients
    assert check_non_finite_gradients(net.named_parameters()) == []  # no gradients yet
    for p in net.parameters():
        p.grad = torch.zeros_like(p)
    net[0].weight.grad[1, 2] = float("nan")
    net[1].bias.grad[0] = float("inf")
    net[1].bias.grad[1] = float("-inf")
    assert check_non_finite_gradients(net.named_parameters()) == ["0.weight", "1.bias"]
    out = capsys.readouterr().out
    assert "Non-finite gradients in 0.weight: 1 values" in out
    assert "Non-finite gradients in 1.bias: 2 values" in out


def test_loss_dict_matches_jax():
    from intro_tc_vae_tpu.utils.lossdict import LossDict as JLossDict
    from intro_tc_vae_tpu_torch.utils import LossDict

    a, b = dict(loss_enc=1.5, kl=2.0), dict(kl=0.25, rec=4.0)
    got = (LossDict(a) + LossDict(b)) / 2
    want = (JLossDict(a) + JLossDict(b)) / 2
    assert isinstance(got, LossDict) and got == want == dict(kl=1.125, loss_enc=0.75, rec=2.0)
    assert list(got) == list(want)
