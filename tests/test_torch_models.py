"""PyTorch port vs JAX package: the 'conv' arch encoder/decoder and the
weight bridge.

JAX ``init`` params (with BatchNorm scale/bias and running statistics
randomized so no layer is trivial) go through the bridge
(``intro_tc_vae_tpu_torch.utils.flax_to_port``) into the port; the same
seeded numpy batch goes through both. Tolerance in fp32: rtol 1e-4 /
atol 1e-5 — two conv stacks whose sums run in different orders (XLA
NHWC vs oneDNN NCHW); running statistics are means of those outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intro_tc_vae_tpu.models import Decoder as JDecoder
from intro_tc_vae_tpu.models import Encoder as JEncoder
from intro_tc_vae_tpu.utils.transplant import torch_state_dict_to_flax
from intro_tc_vae_tpu_torch.models import (
    Decoder,
    Encoder,
    SoftIntroVAE,
    conv_output_size,
)
from intro_tc_vae_tpu_torch.utils import flax_to_port

SMALL = dict(arch="conv", cdim=3, zdim=8, channels=(16, 32), image_size=32)
COS = conv_output_size(32, (16, 32))
TOL = dict(rtol=1e-4, atol=1e-5)


def _randomize(tree, rng):
    """BatchNorm scale/bias and running mean/var drawn at random in place
    of flax's ones/zeros, so no normalization is an identity."""
    def u(lo, hi, like):
        return jnp.asarray(rng.uniform(lo, hi, np.shape(like)).astype(np.float32))

    def visit(node):
        if "scale" in node:
            return {"scale": u(0.5, 1.5, node["scale"]), "bias": u(-0.5, 0.5, node["bias"])}
        if "mean" in node:
            return {"mean": u(-0.5, 0.5, node["mean"]), "var": u(0.5, 2.0, node["var"])}
        if "kernel" in node:
            return node
        return {k: visit(v) for k, v in node.items()}
    return visit(tree)


@pytest.fixture(scope="module")
def jax_model():
    rng = np.random.RandomState(1)
    enc, dec = JEncoder(**SMALL), JDecoder(**SMALL)
    ev = enc.init(jax.random.key(1), jnp.zeros((1, 32, 32, 3)), True)
    dv = dec.init(jax.random.key(2), jnp.zeros((1, 8)), True)
    params = _randomize({"encoder": ev["params"], "decoder": dv["params"]}, rng)
    stats = _randomize({"encoder": ev["batch_stats"], "decoder": dv["batch_stats"]}, rng)
    return enc, dec, params, stats


def _port(params, stats):
    model = SoftIntroVAE(Encoder(**SMALL), Decoder(**SMALL))
    model.load_state_dict(flax_to_port(params, stats, "conv", COS))
    return model


def _assert_stats_match(model, params, new_stats):
    want = flax_to_port(params, new_stats, "conv", COS)
    got = model.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=k, **TOL)


@pytest.mark.parametrize("train,groups", [(True, 1), (True, 2), (False, 1)])
def test_encoder_matches_jax(jax_model, rng, train, groups):
    enc, _, params, stats = jax_model
    x = rng.rand(8, 32, 32, 3).astype(np.float32)
    (mu_ref, lv_ref), upd = enc.apply(
        {"params": params["encoder"], "batch_stats": stats["encoder"]},
        jnp.asarray(x), train, groups, mutable=["batch_stats"])

    model = _port(params, stats)
    model.train(train)
    with torch.no_grad():
        mu, lv = model.encoder(torch.from_numpy(x.transpose(0, 3, 1, 2)), groups)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_ref), **TOL)
    np.testing.assert_allclose(lv.numpy(), np.asarray(lv_ref), **TOL)
    _assert_stats_match(model, params,
                        {"encoder": upd["batch_stats"], "decoder": stats["decoder"]})


@pytest.mark.parametrize("train,groups", [(True, 1), (True, 2), (False, 1)])
def test_decoder_matches_jax(jax_model, rng, train, groups):
    _, dec, params, stats = jax_model
    z = rng.randn(8, 8).astype(np.float32)
    y_ref, upd = dec.apply(
        {"params": params["decoder"], "batch_stats": stats["decoder"]},
        jnp.asarray(z), train, groups, mutable=["batch_stats"])

    model = _port(params, stats)
    model.train(train)
    with torch.no_grad():
        y = model.decoder(torch.from_numpy(z), groups)
    np.testing.assert_allclose(y.numpy().transpose(0, 2, 3, 1), np.asarray(y_ref), **TOL)
    _assert_stats_match(model, params,
                        {"encoder": stats["encoder"], "decoder": upd["batch_stats"]})


def test_grouped_batchnorm_equals_sequential_passes(rng):
    """groups=2 on a concatenated batch == two sequential batch-B passes,
    outputs and the composed running statistics."""
    x = torch.from_numpy(rng.randn(8, 3, 32, 32).astype(np.float32))
    torch.manual_seed(0)
    a = Encoder(**SMALL)
    b = Encoder(**SMALL)
    b.load_state_dict(a.state_dict())
    with torch.no_grad():
        mu_g, _ = a(x, groups=2)
        mu_1, _ = b(x[:4])
        mu_2, _ = b(x[4:])
    np.testing.assert_allclose(mu_g.numpy(), torch.cat([mu_1, mu_2]).numpy(), **TOL)
    for k, v in a.state_dict().items():
        np.testing.assert_allclose(v.numpy(), b.state_dict()[k].numpy(), err_msg=k, **TOL)


def test_state_dict_roundtrips_through_jax_transplant(jax_model):
    """The JAX package's torch_state_dict_to_flax reads the port's
    state_dict as it is and gives back the JAX trees exactly."""
    _, _, params, stats = jax_model
    model = _port(params, stats)
    p2, s2 = torch_state_dict_to_flax(model.state_dict(), "conv", COS)
    for want, got in ((params, p2), (stats, s2)):
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
        assert len(flat_w) == len(flat_g)
        for path, leaf in flat_w:
            np.testing.assert_array_equal(np.asarray(flat_g[path]), np.asarray(leaf),
                                          err_msg=str(path))


def test_bf16_compute_keeps_fp32_params_and_heads(rng):
    enc = Encoder(**SMALL, compute_dtype=torch.bfloat16)
    dec = Decoder(**SMALL, compute_dtype=torch.bfloat16)
    x = torch.from_numpy(rng.rand(4, 3, 32, 32).astype(np.float32))
    mu, logvar = enc(x)
    y = dec(mu)
    assert mu.dtype == logvar.dtype == y.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in enc.parameters())
    assert all(b.dtype == torch.float32 for b in dec.buffers())
    # BN outputs the compute dtype
    assert enc.main["1"](enc.main["0"](x)).dtype == torch.bfloat16


@pytest.mark.parametrize("kwargs", [
    dict(conv_impl="pallas"), dict(conv_impl="hybrid"), dict(tile_rows=16),
    dict(arch="res"), dict(arch="inception"),
])
def test_unported_model_options_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Encoder(**{**SMALL, **kwargs})
