"""The reference against the port at synthetic_small widths in float32 on
the CPU: the passes one by one, and three train steps through the
harness's own set-up, feed and comparison."""

import torch

from perfbench.modes import sample as sample_mode
from perfbench.modes import train as train_mode
from perfbench.reference import model as ref

ARCH = ref.Arch(32, (16, 32), 3, 16)


def port_models(weights, stats=None):
    from intro_tc_vae_tpu_torch.models import Decoder, Encoder
    from intro_tc_vae_tpu_torch.models.vae import SoftIntroVAE

    kw = dict(arch="conv", cdim=3, zdim=ARCH.zdim, channels=ARCH.channels,
              image_size=ARCH.image_size, conv_impl="pallas")
    model = SoftIntroVAE(Encoder(**kw), Decoder(**kw))
    train_mode.copy_weights(model, weights)
    if stats is not None:
        model.decoder.load_state_dict(
            {**{k[len("decoder."):]: v for k, v in weights.items() if k.startswith("decoder.")},
             **{k[len("decoder."):]: v for k, v in stats.items()}})
    return model


def test_passes_match_the_port():
    torch.manual_seed(0)
    weights = ref.make_weights(ARCH, 5, "cpu")
    model = port_models(weights).train()
    x = torch.rand(6, 3, 32, 32)
    z = torch.randn(6, ARCH.zdim)
    with torch.no_grad():
        for got, want in zip(model.encoder(x), ref.encoder(weights, ARCH, x)):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(model.decoder(z), ref.decoder(weights, ARCH, z),
                                   rtol=1e-5, atol=1e-5)
        stats = ref.calibrated_stats(weights, ARCH, torch.randn(16, ARCH.zdim))
        model = port_models(weights, stats).eval()
        torch.testing.assert_close(model.decoder(z), ref.decoder(weights, ARCH, z, stats=stats),
                                   rtol=1e-5, atol=1e-5)


def test_tc_matches_the_port():
    from intro_tc_vae_tpu_torch import ops

    g = torch.Generator().manual_seed(3)
    z, mu, logvar = (torch.randn(12, 8, generator=g, dtype=torch.float64) for _ in range(3))
    got = ops.total_correlation(z, mu, logvar, 500, reduce="none", impl="xla")
    torch.testing.assert_close(ref.total_correlation(z, mu, logvar, 500), got,
                               rtol=1e-12, atol=1e-12)


def test_three_steps_match_the_port(small):
    cell = small("itc64.train")
    s = train_mode.build(cell, 2**33 + 7, "cpu")
    win = train_mode.window(s, 0.2, trace=False)
    assert win.steps >= 1
    train_mode.free(s)
    got = train_mode.check(s)
    for stage in train_mode.STAGES:
        assert got[f"{stage}.loss_gap"] < 1e-4 and got[f"{stage}.grad_gap"] < 1e-4
        assert got[f"{stage}.median_grad_gap"] < 1e-5 and got[f"{stage}.change_gap"] < 0.02
        assert got[f"{stage}.leaves"] == len(ref.leaf_specs(s.arch))


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
