"""The reference against the port at synthetic_small widths in float32 on
the CPU, in each of the three block archs: the passes one by one, and
three train steps through the harness's own set-up, feed and comparison.
At these widths (32 px, channels 16-32) the ``res`` and ``inception``
models hold blocks with a ``conv_expand`` (16 -> 32, 32 -> 16) and blocks
with an identity (32 -> 32, 16 -> 16)."""

import math

import pytest
import torch

from perfbench.modes import sample as sample_mode
from perfbench.modes import train as train_mode
from perfbench.reference import model as ref

ARCH = ref.Arch(32, (16, 32), 3, 16)
BLOCKS = ["conv", "res", "inception"]


def port_models(weights, stats=None, block="conv"):
    from intro_tc_vae_tpu_torch.models import Decoder, Encoder
    from intro_tc_vae_tpu_torch.models.vae import SoftIntroVAE

    kw = dict(arch=block, cdim=3, zdim=ARCH.zdim, channels=ARCH.channels,
              image_size=ARCH.image_size, conv_impl="pallas")
    model = SoftIntroVAE(Encoder(**kw), Decoder(**kw))
    train_mode.copy_weights(model, weights)
    if stats is not None:
        model.decoder.load_state_dict(
            {**{k[len("decoder."):]: v for k, v in weights.items() if k.startswith("decoder.")},
             **{k[len("decoder."):]: v for k, v in stats.items()}})
    return model


@pytest.mark.parametrize("block", BLOCKS)
def test_passes_match_the_port(block):
    arch = ref.Arch(32, (16, 32), 3, 16, block)
    torch.manual_seed(0)
    weights = ref.make_weights(arch, 5, "cpu")
    model = port_models(weights, block=block).train()
    x = torch.rand(6, 3, 32, 32)
    z = torch.randn(6, arch.zdim)
    with torch.no_grad():
        for got, want in zip(model.encoder(x), ref.encoder(weights, arch, x)):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(model.decoder(z), ref.decoder(weights, arch, z),
                                   rtol=1e-5, atol=1e-5)
        stats = ref.calibrated_stats(weights, arch, torch.randn(16, arch.zdim))
        model = port_models(weights, stats, block).eval()
        torch.testing.assert_close(model.decoder(z), ref.decoder(weights, arch, z, stats=stats),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("block", BLOCKS)
def test_leaves_are_the_ports_at_full_width(block):
    """Soft-IntroVAE's 256 px widths (channels 64-128-256-512-512-512, z
    512): every leaf named, shaped and ordered as the program's
    ``named_parameters``, built on the meta device."""
    from intro_tc_vae_tpu_torch.models import Decoder, Encoder
    from intro_tc_vae_tpu_torch.models.vae import SoftIntroVAE

    arch = ref.Arch(256, (64, 128, 256, 512, 512, 512), 3, 512, block)
    kw = dict(arch=block, cdim=3, zdim=arch.zdim, channels=arch.channels,
              image_size=arch.image_size)
    with torch.device("meta"):
        model = SoftIntroVAE(Encoder(**kw), Decoder(**kw))
    assert [(n, tuple(p.shape)) for n, p in model.named_parameters()] == \
        [(n, shape) for n, shape, _, _ in ref.leaf_specs(arch)]


def test_tc_matches_the_port():
    from intro_tc_vae_tpu_torch import ops

    g = torch.Generator().manual_seed(3)
    z, mu, logvar = (torch.randn(12, 8, generator=g, dtype=torch.float64) for _ in range(3))
    got = ops.total_correlation(z, mu, logvar, 500, reduce="none", impl="xla")
    torch.testing.assert_close(ref.total_correlation(z, mu, logvar, 500), got,
                               rtol=1e-12, atol=1e-12)


# The step test's seeds and limits per arch. ``conv``: one seed, the
# limits it always had. ``res`` and ``inception``: four consecutive seeds,
# every one held, with limits set from 12 seeds' readings (2**33 + 1 to
# + 11 and 41, float32, the largest over both stages):
#
#              loss_gap  grad_gap  median_grad_gap  change_gap
#   res        7.9e-5    2.6e-3    3.5e-6           1.1e-2
#   inception  2.3e-6    1.8e-3    1.8e-5           3.5e-2
#
# The worst leaf's gaps swing from seed to seed: where a pre-activation
# lies within rounding of 0, the two sides' LeakyReLU masks differ there,
# which moves that leaf's gradient (with both models' layers in float64
# such tails remain). The median leaf's gap is steady, and catches a fault
# that the worst leaf's cannot: with the ``res`` BatchNorm eps at 1e-4 in
# the reference, ``median_grad_gap`` read 1.5e-4 to 7.2e-4 on each of
# those 12 seeds.
STEP_SEEDS = {"conv": [2**33 + 7],
              "res": [2**33 + k for k in range(7, 11)],
              "inception": [2**33 + k for k in range(7, 11)]}
STEP_LIMITS = {"conv": {"loss_gap": 1e-4, "grad_gap": 1e-4, "median_grad_gap": 1e-5,
                        "change_gap": 0.02},
               "res": {"loss_gap": 5e-4, "grad_gap": 0.02, "median_grad_gap": 5e-5,
                       "change_gap": 0.1},
               "inception": {"loss_gap": 5e-4, "grad_gap": 0.02, "median_grad_gap": 5e-5,
                             "change_gap": 0.1}}


@pytest.mark.parametrize("block", BLOCKS)
def test_three_steps_match_the_port(small, block):
    limits = STEP_LIMITS[block]
    for seed in STEP_SEEDS[block]:
        cell = small("itc64.train")
        cell.config["config"]["arch"] = block
        s = train_mode.build(cell, seed, "cpu")
        assert s.arch.block == block
        win = train_mode.window(s, 0.2, trace=False)
        assert win.steps >= 1
        train_mode.free(s)
        got = train_mode.check(s)
        for stage in train_mode.STAGES:
            for number, limit in limits.items():
                assert got[f"{stage}.{number}"] < limit, (seed, stage, number, got)
            assert got[f"{stage}.leaves"] == len(ref.leaf_specs(s.arch))


def test_the_program_steps_under_its_precisions_tf32_switches(small, monkeypatch):
    """Every step the harness drives, in set-up and in the window, runs
    under ``train.true_fp32`` for the configuration's precision, as
    ``train.py`` runs it: TF32 off for "fp32", the switches untouched for
    "bf16"; and they are put back afterwards."""
    seen = []
    step = train_mode._step

    def recording(s, keep_noise=None):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        step(s, keep_noise)

    monkeypatch.setattr(train_mode, "_step", recording)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    cell = small("itc64.train")
    assert cell.config["config"]["precision"] == "fp32"
    s = train_mode.build(cell, 5, "cpu")
    train_mode.window(s, 0.1, trace=False)
    assert len(seen) > 2 * train_mode.CHECKED_STEPS and set(seen) == {(False, False)}
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    cell.config["config"]["precision"] = "bf16"
    with train_mode.program_precision(cell):
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("block", ["res", "inception"])
def test_stand_ins_read_on_the_block(small, block):
    """The control and the half-batch fault, in the program's place, give
    a finite number for every check of a cell of this arch."""
    cell = small("itc64.train")
    cell.config["config"]["arch"] = block
    s = train_mode.build(cell, 41, "cpu")
    train_mode.free(s)
    sound = train_mode.check(s)
    names = [k for k, v in sound.items() if isinstance(v, float)]
    wanted = {f"{st}.{n}" for st in train_mode.STAGES for n in ("grad_gap", "change_gap")}
    assert wanted <= set(names)
    for stand_in in ("fp8", "half_batch"):
        got = train_mode.check(s, stand_in)
        assert all(math.isfinite(got[k]) for k in names), (stand_in, got)
        assert got["start.grad_gap"] > sound["start.grad_gap"], (stand_in, got)


def test_decodes_match_the_port(small):
    cell = small("itc64.sample")
    s = sample_mode.build(cell, 11, "cpu")
    win = sample_mode.window(s, 0.2, trace=False)
    assert win.requests >= 3 and len(s.kept) == 3
    sample_mode.free(s)
    got = sample_mode.check(s)
    assert got == {"image_gap": 0.0, "pixel_gap": 0, "requests_checked": 3}


def test_same_seed_same_inputs():
    from perfbench.core import data

    a = data.make_corpus(6, 16, 3, 9, "cpu")
    assert (a == data.make_corpus(6, 16, 3, 9, "cpu")).all()
    assert not (a == data.make_corpus(6, 16, 3, 10, "cpu")).all()
    assert data.sub_seeds(2**40 + 1) == data.sub_seeds(2**40 + 1)
    assert all(0 <= v < 2**31 for v in data.sub_seeds(2**40 + 1).values())
    w1, w2 = ref.make_weights(ARCH, 4, "cpu"), ref.make_weights(ARCH, 4, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
