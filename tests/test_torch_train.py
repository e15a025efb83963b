"""PyTorch port: the trainer, the CLI, the loader and config surface, and
the package's import hygiene. CPU only: the trainer runs here only
because the tests pass ``device=torch.device("cpu")`` explicitly."""

import dataclasses
import glob
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "configs", "intro_tc_ukiyo64.json")
SMALL_RUN = dict(dataset="synthetic_small", tc_impl="pallas", num_epochs=1,
                 use_tensorboard=False, batch_size=8, z_dim=8)
CPU = torch.device("cpu")


def test_train_one_epoch_on_cpu():
    """The flagship recipe (bf16 compute, paired, tc_impl 'pallas') at the
    synthetic_small size: 64 images / batch 8 = 8 steps, finite losses."""
    config = load_config(FLAGSHIP, SMALL_RUN)
    state = train_soft_intro_vae(config, device=CPU)
    assert state.step == len(state.history) == 8
    for record in state.history:
        assert all(math.isfinite(record[k]) for k in ("lossE", "lossD", "loss_kl",
                                                      "loss_rec", "expelbo_r"))
    assert all(p.dtype == torch.float32 for p in state.model.parameters())


def test_cli_requires_cuda(monkeypatch):
    """No CPU fallback: without CUDA the entry point refuses to run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main.cli(["-f", FLAGSHIP, "-u", '{"dataset": "synthetic", "tc_impl": "pallas", '
                  '"num_epochs": 1, "use_tensorboard": false}'])


@pytest.mark.parametrize("update", [
    dict(use_tensorboard=True), dict(resume="auto"), dict(profile=True),
    dict(anomaly_detection=True), dict(data_parallel=2), dict(model_parallel=2),
    dict(scan_steps=2), dict(remat="pass"), dict(pack_predict=2),
    dict(device_cache="force"), dict(transfer_dtype="uint8"),
    dict(tc_sampling="weighted", tc_impl="xla"), dict(tile_rows=16),
    dict(arch="inception"), dict(optimizer="sgd"), dict(dataset="ukiyo_e64"),
    dict(kl_kind="tc_full"),
], ids=lambda u: ",".join(f"{k}={v}" for k, v in u.items()))
def test_unported_options_raise(update):
    config = load_config(FLAGSHIP, {**SMALL_RUN, **update})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_soft_intro_vae(config, device=CPU)


@pytest.mark.parametrize("update", [
    dict(conv_impl="pallas"), dict(arch="res"), dict(solver="vae"),
], ids=lambda u: ",".join(f"{k}={v}" for k, v in u.items()))
def test_options_that_once_raised_train(update):
    """The flagship recipe with each option at the synthetic_small size:
    8 finite steps (at this width no conv routes to the kernels; the
    routed widths are tests/test_torch_conv.py's and _models.py's)."""
    config = load_config(FLAGSHIP, {**SMALL_RUN, **update})
    state = train_soft_intro_vae(config, device=CPU)
    assert state.step == len(state.history) == 8
    assert all(math.isfinite(r[k]) for r in state.history for k in ("loss_enc", "loss_dec"))


@pytest.mark.parametrize("path,update", [
    ("vae_synthetic.json", {"conv_impl": "pallas"}),
    ("tc_dsprites.json", {"tc_impl": "pallas", "conv_impl": "hybrid"}),
], ids=["vae_synthetic", "tc_dsprites"])
def test_elbo_configs_train_on_cpu(path, update):
    """configs/vae_synthetic.json (res arch, vae solver) and
    configs/tc_dsprites.json on the synthetic dataset (conv arch, tc
    solver), both fp32, at the synthetic_small size: 8 finite steps, the
    metric names of the JAX ELBO step, and the parameters moved."""
    config = load_config(os.path.join(REPO, "configs", path),
                         {**SMALL_RUN, **update, "dataset": "synthetic_small"})
    torch.manual_seed(config.seed)
    state = train_soft_intro_vae(config, device=CPU)
    assert state.step == len(state.history) == 8
    for record in state.history:
        assert {"loss_enc", "loss_dec", "loss_kl", "loss_rec", "kl_loss_unscaled",
                "r_loss_unscaled", "fc_grad_norm"} <= set(record)
        assert all(math.isfinite(v) for v in record.values())
        assert record["loss_enc"] == record["loss_dec"]
    assert state.history[-1]["loss_enc"] != state.history[0]["loss_enc"]


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
