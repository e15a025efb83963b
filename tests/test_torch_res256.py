"""PyTorch port: the 256 px residual Intro-TC-VAE configuration
(``configs/intro_tc_ukiyo256_res.json``: IntroVAE / Soft-IntroVAE widths,
``res`` blocks, z 512) and the stock-route counters of ``models/blocks.py``
(``STOCK_CALLS``) with the stock resamples of ``ops/batchnorm_cuda.py``
(``RESAMPLES``).

On the CPU: the configuration loads, and its model has the leaves of the
benchmark's plain reference (``perfbench/reference/model.py``) by name,
shape and order; three ``intro_tc`` steps with its own settings, cut to
32 px, follow the reference in float32 through the benchmark's own set-up,
feed and comparison; the four counters count what their names say, under
a launch tally as eagerly, and at full width only the 256 px model sends a
64 -> 64 conv to the stock route.

On the card (marker ``cuda``, skipped without one): under the graphed
step's replays each step adds the counters an eager step adds. This file
imports no JAX, so it runs there with ``python -m pytest --noconftest -q
-m cuda tests/test_torch_res256.py``.
"""

import copy
import os

import pytest
import torch
import torch.nn.functional as F

from intro_tc_vae_tpu_torch.config import load_config
from intro_tc_vae_tpu_torch.data.datasets import _TABLE
from intro_tc_vae_tpu_torch.models import Decoder, Encoder, blocks
from intro_tc_vae_tpu_torch.models.vae import SoftIntroVAE, num_params
from intro_tc_vae_tpu_torch.ops import batchnorm_cuda, launch_counts
from tests._torch_threads import one_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "intro_tc_ukiyo256_res.json")
ROUTES = ("conv_stock_size", "conv_stock_channels", "residual_tail", "conv_expand")
STOCK_RESAMPLES = ("pool_stock", "up_stock")  # kept in batchnorm_cuda.RESAMPLES
COUNTERS = ROUTES + STOCK_RESAMPLES
# the benchmark's 64 and 128 px cells and this configuration, by dataset
MODELS = {"itc64": "ukiyo_e64", "itc128": "ukiyo_e128", "itc256res": "ukiyo_e256"}


def model_kwargs(config) -> dict:
    image_size, channels, cdim = _TABLE[config.dataset]
    return dict(arch=config.arch, cdim=cdim, zdim=config.z_dim, channels=tuple(channels),
                image_size=image_size, conv_impl="pallas")


def stock_counts() -> dict:
    """``COUNTERS``, each read where it is kept."""
    return {**{k: blocks.STOCK_CALLS[k] for k in ROUTES},
            **{k: batchnorm_cuda.RESAMPLES[k] for k in STOCK_RESAMPLES}}


def zero_counts() -> None:
    blocks.STOCK_CALLS.update(dict.fromkeys(ROUTES, 0))
    batchnorm_cuda.RESAMPLES.update(dict.fromkeys(STOCK_RESAMPLES, 0))


@pytest.fixture
def counts():
    """``STOCK_CALLS`` (yielded) and the stock resamples from zero; put
    back as they were afterwards."""
    saved, saved_resamples = dict(blocks.STOCK_CALLS), dict(batchnorm_cuda.RESAMPLES)
    zero_counts()
    yield blocks.STOCK_CALLS
    blocks.STOCK_CALLS.update(saved)
    batchnorm_cuda.RESAMPLES.update(saved_resamples)


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------

def test_the_config_loads_with_the_published_widths():
    from perfbench.reference import model as ref

    config = load_config(CONFIG)
    assert (config.solver, config.dataset, config.arch) == ("intro_tc", "ukiyo_e256", "res")
    assert (config.z_dim, config.batch_size, config.lr, config.num_epochs) == (512, 32, 2e-4, 250)
    assert (config.beta_kl, config.beta_rec, config.beta_neg, config.gamma_r) == \
        (0.5, 1.0, 1024.0, 1e-8)
    assert (config.precision, config.optimizer, config.recon_loss_type) == ("bf16", "adam", "mse")
    assert _TABLE[config.dataset] == (256, [64, 128, 256, 512, 512, 512], 3)
    kw = model_kwargs(config)
    with torch.device("meta"):
        model = SoftIntroVAE(Encoder(**kw), Decoder(**kw))
    arch = ref.Arch(kw["image_size"], kw["channels"], kw["cdim"], kw["zdim"], kw["arch"])
    leaves = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    assert leaves == [(n, shape) for n, shape, _, _ in ref.leaf_specs(arch)]
    assert len(leaves) == 93 and num_params(model) == 48_316_419


def test_the_benchmark_runs_the_repo_config():
    """The benchmark's configuration is this file with only the keys its
    ``reduced`` lists changed, and the model it describes is this one."""
    import json

    from perfbench.core import spec

    cell = spec.cell("itc256res.train")
    source = json.load(open(CONFIG))
    run = cell.config["config"]
    changed = {k for k in set(source) | set(run) if source.get(k) != run.get(k)}
    assert changed <= set(cell.config["reduced"]), changed
    image_size, channels, cdim = _TABLE[source["dataset"]]
    assert cell.config["model"] == {"image_size": image_size, "channels": channels,
                                    "cdim": cdim}
    assert cell.chips == 1 and cell.mode == "train"


# The step test's seeds and limits: the ``res`` limits of
# ``perfbench/tests/test_pb_reference.py``, four consecutive seeds, every
# one held. This configuration's settings (beta_rec 1.0, beta_neg 1024) at
# 32 px, channels 16-32, z 16, batch 8, float32, read over 12 seeds
# (2**33 + 1 to + 12, the largest over both stages): loss_gap 1.7e-4,
# grad_gap 2.7e-3, median_grad_gap 5.9e-6, change_gap 9.4e-3.
STEP_SEEDS = [2**33 + k for k in range(7, 11)]
STEP_LIMITS = {"loss_gap": 5e-4, "grad_gap": 0.02, "median_grad_gap": 5e-5, "change_gap": 0.1}


def small_cell():
    """``itc256res.train`` cut to 32 px (channels 16-32: blocks with a
    ``conv_expand`` 16 -> 32 and 32 -> 16, and identity blocks), z 16,
    batch 8, float32; its betas, eps and blocks as they are."""
    from perfbench.core import spec

    cell = copy.deepcopy(spec.cell("itc256res.train"))
    cell.config["model"] = {"image_size": 32, "channels": [16, 32], "cdim": 3}
    cell.config["config"].update(batch_size=8, precision="fp32", z_dim=16)
    cell.traffic.update(corpus_images=64, warmup_steps=1)
    return cell


def test_three_steps_follow_the_reference():
    from perfbench.modes import train as train_mode
    from perfbench.reference import model as ref

    for seed in STEP_SEEDS:
        cell = small_cell()
        s = train_mode.build(cell, seed, "cpu")
        assert s.arch.block == "res"
        assert (s.hyper.beta_rec, s.hyper.beta_neg) == (1.0, 1024.0)
        assert train_mode.window(s, 0.2, trace=False).steps >= 1
        train_mode.free(s)
        got = train_mode.check(s)
        for stage in train_mode.STAGES:
            for number, limit in STEP_LIMITS.items():
                assert got[f"{stage}.{number}"] < limit, (seed, stage, number, got)
            assert got[f"{stage}.leaves"] == len(ref.leaf_specs(s.arch))


# ---------------------------------------------------------------------------
# the counters
# ---------------------------------------------------------------------------

def test_counters_are_registered_launch_counts():
    keys = [k for c in launch_counts.snapshot() for k in c]
    assert all(keys.count(k) == 1 for k in COUNTERS)


@pytest.mark.parametrize("impl", ["pallas", "hybrid"])
def test_a_conv_counts_its_stock_route(counts, impl):
    conv64 = blocks.PallasConv3x3(64, 64, impl=impl)
    with torch.no_grad():
        conv64(torch.zeros(1, 64, 256, 256, device="meta"))  # H * W > 128^2: refused
        assert stock_counts() == dict.fromkeys(COUNTERS, 0) | {"conv_stock_size": 1}
        conv64(torch.randn(1, 64, 128, 128))  # routed (the CPU's plain version)
        conv64(torch.zeros(2, 64, 24, 32, device="meta"))  # H % 16: refused
        assert counts["conv_stock_size"] == 2 and counts["conv_stock_channels"] == 0
        blocks.PallasConv3x3(64, 128, impl=impl)(torch.zeros(1, 64, 128, 128, device="meta"))
        blocks.PallasConv3x3(3, 64, impl=impl)(torch.zeros(1, 3, 64, 64, device="meta"))
    assert stock_counts() == {"conv_stock_size": 2, "conv_stock_channels": 2,
                              "residual_tail": 0, "conv_expand": 0, "pool_stock": 0,
                              "up_stock": 0}


def test_a_stock_conv_module_counts_nothing(counts):
    """``conv_impl`` 'xla' builds plain ``Conv2d``s: no routing decision."""
    conv = blocks.conv(64, 64, 3, impl="xla")
    assert type(conv) is blocks.Conv2d
    with torch.no_grad():
        conv(torch.zeros(1, 64, 256, 256, device="meta"))
    assert not any(counts.values())


def test_a_residual_block_counts_its_tail_and_projection(counts):
    x = torch.randn(2, 16, 32, 32)
    with torch.no_grad():
        blocks.ResidualBlock(16, 32, conv_impl="pallas")(x)
        assert stock_counts() == {"conv_stock_size": 0, "conv_stock_channels": 2,
                                  "residual_tail": 1, "conv_expand": 1, "pool_stock": 0,
                                  "up_stock": 0}
        blocks.ResidualBlock(16, 16, conv_impl="pallas")(x)
        blocks.ConvolutionalBlock(16, 16, conv_impl="pallas")(x)
    assert stock_counts() == {"conv_stock_size": 0, "conv_stock_channels": 6,
                              "residual_tail": 2, "conv_expand": 1, "pool_stock": 0,
                              "up_stock": 0}


def test_a_tally_adds_what_the_capture_counted(counts):
    """A captured region's counts are its tally (``launch_counts.
    recording``): the counters are put back, and each replay adds them."""
    block = blocks.ResidualBlock(16, 32, conv_impl="pallas")
    x = torch.randn(2, 16, 32, 32)
    with torch.no_grad():
        block(x)
        eager = stock_counts()
        with launch_counts.recording() as tally:
            block(x)
    assert stock_counts() == eager
    assert {k: v for k, v in tally.launches().items() if k in COUNTERS} == \
        {k: v for k, v in eager.items() if v}
    tally.add(3)
    assert stock_counts() == {k: 4 * v for k, v in eager.items()}


def _forward_counts(dataset: str) -> dict:
    """``COUNTERS`` of one encoder and one decoder pass of the
    configuration's model at full width, eval mode, on the meta device (the
    routed convs through a meta-device stand-in of the kernels)."""
    config = load_config(CONFIG, {"dataset": dataset,
                                  "arch": "res" if dataset == "ukiyo_e256" else "conv"})
    kw = model_kwargs(config)
    with torch.device("meta"):
        enc, dec = Encoder(**kw).eval(), Decoder(**kw).eval()
    out = {}
    for name, fn, inp in (("encoder", enc, (1, kw["cdim"], kw["image_size"], kw["image_size"])),
                          ("decoder", dec, (1, kw["zdim"]))):
        zero_counts()
        with torch.no_grad():
            fn(torch.zeros(inp, device="meta"))
        out[name] = stock_counts()
    return out


def test_only_the_256px_model_sends_a_64_64_conv_to_the_stock_route(counts, monkeypatch):
    routed = []

    def stand_in(x, w):
        routed.append(tuple(x.shape))
        return F.conv2d(x, w, padding=1)

    monkeypatch.setattr(blocks, "conv3x3_pallas", stand_in)
    got = {model: _forward_counts(dataset) for model, dataset in MODELS.items()}
    for model in ("itc64", "itc128"):
        assert got[model]["encoder"]["conv_stock_size"] == 0
        assert got[model]["decoder"]["conv_stock_size"] == 0
        assert got[model]["encoder"]["residual_tail"] == 0
    res = got["itc256res"]
    # the decoder's last block, res_in_256: two 64 -> 64 convs at 256 x 256;
    # the encoder has no 64 -> 64 conv (its first block is 64 -> 128). In
    # eval mode every stage's resample is a stock pass: the stem's and five
    # blocks' pools, six upsamples
    assert res["encoder"] == {"conv_stock_size": 0, "conv_stock_channels": 12,
                              "residual_tail": 6, "conv_expand": 3, "pool_stock": 6,
                              "up_stock": 0}
    assert res["decoder"] == {"conv_stock_size": 2, "conv_stock_channels": 11,
                              "residual_tail": 7, "conv_expand": 3, "pool_stock": 0,
                              "up_stock": 6}
    # what is routed at 256 px: the decoder's res_in_128 conv2, 64 -> 64 at 128 x 128
    assert routed[-1:] == [(1, 64, 128, 128)]


# ---------------------------------------------------------------------------
# the benchmark's two readers of the stock conv route
# ---------------------------------------------------------------------------

def _reader(name: str):
    from perfbench.core import spec

    return spec.metric_reader(name)


def test_the_calls_reader_reads_the_counters_a_step(counts, monkeypatch):
    from intro_tc_vae_tpu_torch.solvers.graph import GraphedStep
    from intro_tc_vae_tpu_torch.utils import tracing

    read = _reader("stock_conv3x3_calls.train")
    monkeypatch.setattr(tracing, "RECORDER", tracing.Recorder(capacity=64, phase_capacity=8))
    assert read(None) is None  # no graphed step
    graphed = GraphedStep(lambda *a: {}, (), 1)
    graphed.eager, graphed.replays = 3, 5
    counts.update(conv_stock_size=16, conv_stock_channels=88, residual_tail=104)
    assert read(None) == pytest.approx((16 + 88) / 8)
    counts.update(conv_stock_size=0, conv_stock_channels=24)
    assert read(None) == pytest.approx(24 / 8)
    counts.update(conv_stock_size=0, conv_stock_channels=0)
    assert read(None) is None  # neither counter in the launches, as in a program without them


def test_the_ms_reader_takes_library_convs_and_their_transposes():
    from perfbench.core.readings import Readings
    from perfbench.core.spans import Spans
    from perfbench.core.trace import Trace
    from perfbench.reference.model import Arch

    kernels = [("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", 0.0, 0.004),
               ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16>", 0.004, 0.005),
               ("void cutlass_cudnn::Kernel<cutlass_tensorop_bf16_s16816wgrad>", 0.005, 0.007),
               ("conv3x3_fwd_wgmma", 0.007, 0.010), ("bn_apply", 0.010, 0.011),
               ("tc_fwd", 0.011, 0.012)]
    trace = Trace(device=kernels, ranges=[], lo=0.0, hi=0.012)
    r = Readings(cell=None, arch=Arch(256, (64,), 3, 512, "res"), batch=32, units=10, lo=0.0,
                 hi=1.0, spans=Spans(), trace=trace, trace_units=2)
    assert _reader("stock_conv_ms.train")(r) == pytest.approx(1e3 * 0.007 / 2)
    assert _reader("stock_conv_ms.train")(Readings(**{**r.__dict__, "trace": None})) is None


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("model", list(MODELS))
def test_replays_add_an_eager_steps_counts(model):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph is captured and replayed")
    from intro_tc_vae_tpu_torch import bench
    from intro_tc_vae_tpu_torch.utils import tracing

    config = load_config(CONFIG, {"dataset": MODELS[model],
                                  "arch": "res" if model == "itc256res" else "conv",
                                  "z_dim": 512 if model == "itc256res" else 128})
    kw = model_kwargs(config)
    dev = torch.device("cuda", 0)
    solver, state, x = bench.build_solver(
        "intro_tc", 4, kw["image_size"], dev, arch=kw["arch"], zdim=kw["zdim"],
        channels=kw["channels"], graph=True, tc_impl="pallas", conv_impl="pallas",
        beta_kl=config.beta_kl, beta_rec=config.beta_rec, beta_neg=config.beta_neg)
    graphed = solver.graphed
    deltas = []
    for _ in range(graphed.warmup + 4):
        before = stock_counts()
        solver.train_step(state, x)
        deltas.append({k: n - before[k] for k, n in stock_counts().items()})
    solver.drain_metrics()
    assert graphed.captures == 1 and graphed.replays == 4 and graphed.eager == graphed.warmup
    assert all(d == deltas[0] for d in deltas), deltas
    if model == "itc256res":
        assert deltas[0]["conv_stock_size"] > 0 and deltas[0]["residual_tail"] > 0
        launches = tracing.RECORDER.counters()["launches"]
        assert all(launches[k] > 0 for k in COUNTERS)
    else:
        assert deltas[0]["conv_stock_size"] == 0 and deltas[0]["residual_tail"] == 0
