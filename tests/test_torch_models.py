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
from tests._torch_bf16 import assert_close_bf16, rounded_layers

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


@pytest.mark.parametrize("side", ["encoder", "decoder"])
@pytest.mark.parametrize("train,groups", [(True, 1), (True, 2), (False, 1)])
def test_bf16_models_match_jax(jax_model, rng, side, train, groups):
    """``compute_dtype=torch.bfloat16`` (what ``precision: "bf16"`` builds)
    against the JAX modules with ``dtype=jnp.bfloat16`` on the same float32
    weights: outputs and BatchNorm running statistics, train and eval mode.

    Tolerance (tests/_torch_bf16.py): L layers round to bf16, 18 in this
    encoder and 21 in this decoder, so every entry within L * 2^-8 of the
    largest and the whole within sqrt(L) * 2^-8 in the 2-norm. A running
    statistic moves by 1 - 0.9^groups of a batch statistic, a mean over the
    batch and the pixels: within that share of sqrt(L) * 2^-8 of its largest
    entry. In eval mode the statistics must not move at all."""
    _, _, params, stats = jax_model
    kw = dict(SMALL, dtype=jnp.bfloat16)
    module = JEncoder(**kw) if side == "encoder" else JDecoder(**kw)
    inp = (rng.rand(8, 32, 32, 3) if side == "encoder" else rng.randn(8, 8)).astype(np.float32)
    ref, upd = module.apply({"params": params[side], "batch_stats": stats[side]},
                            jnp.asarray(inp), train, groups, mutable=["batch_stats"])
    refs = ref if side == "encoder" else (ref,)
    assert all(r.dtype == jnp.float32 for r in refs)  # the heads are fp32 in both

    kw = dict(SMALL, compute_dtype=torch.bfloat16)
    model = SoftIntroVAE(Encoder(**kw), Decoder(**kw))
    model.load_state_dict(flax_to_port(params, stats, "conv", COS))
    model.train(train)
    net = getattr(model, side)
    layers = rounded_layers(net)
    assert layers == (18 if side == "encoder" else 21)
    with torch.no_grad():
        if side == "encoder":
            outs = net(torch.from_numpy(inp.transpose(0, 3, 1, 2).copy()), groups)
        else:
            outs = (net(torch.from_numpy(inp), groups).permute(0, 2, 3, 1),)
    for o, r in zip(outs, refs):
        assert o.dtype == torch.float32
        assert_close_bf16(o.numpy(), np.asarray(r), layers, side)

    want = flax_to_port(params, dict(stats, **{side: upd.get("batch_stats", stats[side])}),
                        "conv", COS)
    got = model.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        if not train or not k.startswith(side):
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
            continue
        assert got[k].dtype == torch.float32
        moved = float(np.abs(got[k].numpy() - want[k].numpy()).max())
        bound = (1 - 0.9 ** groups) * np.sqrt(layers) * 2.0 ** -8 * float(want[k].abs().max())
        assert moved <= bound, f"{k}: {moved:.3g} > {bound:.3g}"


@pytest.mark.parametrize("kwargs", [
    dict(conv_impl="pallas"), dict(conv_impl="hybrid"), dict(arch="res"),
    dict(arch="inception"), dict(tile_rows=16),
])
def test_model_options_compute_the_stock_function(kwargs):
    """The options that once raised: the same weights give the stock conv
    arch's output (at SMALL no conv routes; tile_rows 16 runs the stem's
    32 rows in two strips, the same taps summed in another order: to
    rtol 1e-4 / atol 1e-5) or, for 'res' and 'inception', a model whose
    state_dict the JAX transplant reads (checked in full below and in
    tests/test_torch_solver_surface.py; tile_rows against JAX in
    tests/test_torch_options.py)."""
    torch.manual_seed(0)
    stock = SoftIntroVAE(Encoder(**SMALL), Decoder(**SMALL))
    model = SoftIntroVAE(Encoder(**{**SMALL, **kwargs}), Decoder(**{**SMALL, **kwargs}))
    x = torch.rand(4, 3, 32, 32)
    if "arch" in kwargs:
        block = model.encoder.main["res_in_16"]
        assert "encoder.main.res_in_16.conv_expand.weight" in model.state_dict()
        if kwargs["arch"] == "res":
            assert block.bn1.eps == 1e-5
        else:
            assert block.branch_1[1].batch_norm.eps == 1e-4
        mu, logvar = model.encoder(x)
        assert torch.isfinite(model.decoder(mu)).all()
        return
    model.load_state_dict(stock.state_dict())
    for a, b in zip(stock.encoder(x), model.encoder(x)):
        if "tile_rows" in kwargs:
            np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), **TOL)
        else:
            assert torch.equal(a, b)


# channels (64,) at 32 px: every 3x3 conv routes to the kernels (16x16 and
# 32x32, 64 -> 64 channels); on the CPU they run the plain versions
SMALL64 = dict(cdim=3, zdim=8, channels=(64,), image_size=32)
COS64 = conv_output_size(32, (64,))
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)  # atol relative to the tensor's largest entry


@pytest.fixture(scope="module", params=["conv", "res"])
def jax_model64(request):
    arch = request.param
    rng = np.random.RandomState(2)
    enc, dec = JEncoder(arch=arch, **SMALL64), JDecoder(arch=arch, **SMALL64)
    ev = enc.init(jax.random.key(3), jnp.zeros((1, 32, 32, 3)), True)
    dv = dec.init(jax.random.key(4), jnp.zeros((1, 8)), True)
    params = _randomize({"encoder": ev["params"], "decoder": dv["params"]}, rng)
    stats = _randomize({"encoder": ev["batch_stats"], "decoder": dv["batch_stats"]}, rng)
    return arch, enc, dec, params, stats


@pytest.mark.parametrize("side", ["encoder", "decoder"])
@pytest.mark.parametrize("train,groups", [(True, 1), (True, 2), (False, 1)])
def test_pallas_models_match_jax(jax_model64, rng, side, train, groups):
    """conv_impl 'pallas' in the port against the JAX modules with 'xla'
    (the JAX 'pallas' model cannot run on a CPU: ROADMAP, notes on the
    reference): outputs, running statistics and every parameter gradient
    of a random linear functional of the outputs.

    Both run in float64 (JAX in x64 mode, the port with float64 compute),
    keeping the models' fp32 casts of mu/logvar and of the pre-sigmoid
    output: in float32 the two gradients through the batch statistics of
    4-sample groups differed by up to 1e-2 of the largest entry (stem
    conv, batch 8, groups 2), far more than the 1e-4 held here."""
    arch, enc, dec, params, stats = jax_model64
    module = enc if side == "encoder" else dec
    if side == "encoder":
        inp = rng.rand(4, 32, 32, 3)
        cot = [rng.randn(4, 8) for _ in range(2)]
    else:
        inp = rng.randn(4, 8)
        cot = [rng.randn(4, 32, 32, 3)]
    f64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), (params, stats))

    with jax.enable_x64(True):
        p64, s64 = jax.tree_util.tree_map(jnp.asarray, f64)

        def jloss(p):
            out, upd = module.apply({"params": p, "batch_stats": s64[side]},
                                    jnp.asarray(inp), train, groups, mutable=["batch_stats"])
            outs = out if side == "encoder" else (out,)
            return sum(jnp.vdot(o, jnp.asarray(c)) for o, c in zip(outs, cot)), (outs, upd)

        (_, (outs_ref, upd)), jgrads = jax.value_and_grad(jloss, has_aux=True)(p64[side])
        outs_ref = [np.asarray(o) for o in outs_ref]
        new_stats = dict(f64[1], **{side: jax.tree_util.tree_map(np.asarray,
                                                                 upd["batch_stats"])})
        jgrads = jax.tree_util.tree_map(np.asarray, jgrads)

    kw = dict(arch=arch, conv_impl="pallas", compute_dtype=torch.float64, **SMALL64)
    model = SoftIntroVAE(Encoder(**kw), Decoder(**kw)).double()
    model.load_state_dict(flax_to_port(*f64, arch, COS64))
    model.train(train)
    net = getattr(model, side)
    x = torch.from_numpy(inp.transpose(0, 3, 1, 2).copy() if side == "encoder" else inp)
    outs = net(x, groups)
    outs = outs if side == "encoder" else (outs,)
    loss = sum((o * torch.from_numpy(c if side == "encoder" else c.transpose(0, 3, 1, 2).copy())
                ).sum() for o, c in zip(outs, cot))
    names = [n for n, _ in net.named_parameters()]
    grads = torch.autograd.grad(loss, list(net.parameters()))

    for o, ref in zip(outs, outs_ref):
        got = o.detach().numpy()
        np.testing.assert_allclose(got if side == "encoder" else got.transpose(0, 2, 3, 1),
                                   ref, **TOL)
    want = flax_to_port(f64[0], new_stats, arch, COS64)
    got = model.state_dict()
    for k in want:
        if k.startswith(side) and k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=k, **TOL)
    zeros = jax.tree_util.tree_map(np.zeros_like, f64[0])
    want_g = flax_to_port(dict(zeros, **{side: jgrads}), None, arch, COS64)
    for n, g in zip(names, grads):
        ref = want_g[f"{side}.{n}"].numpy()
        np.testing.assert_allclose(g.numpy(), ref, err_msg=n, rtol=GRAD_TOL["rtol"],
                                   atol=GRAD_TOL["atol"] * float(np.abs(ref).max()))


def test_res_state_dict_roundtrips_through_jax_transplant(jax_model64):
    """flax_to_port for 'res' ('conv_expand' included where inc != outc),
    read back by the JAX package's torch_state_dict_to_flax exactly."""
    arch, _, _, params, stats = jax_model64
    model = SoftIntroVAE(Encoder(arch=arch, **SMALL64), Decoder(arch=arch, **SMALL64))
    model.load_state_dict(flax_to_port(params, stats, arch, COS64))
    p2, s2 = torch_state_dict_to_flax(model.state_dict(), arch, COS64)
    for want, got in ((params, p2), (stats, s2)):
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
        assert len(flat_w) == len(flat_g)
        for path, leaf in flat_w:
            np.testing.assert_array_equal(np.asarray(flat_g[path]), np.asarray(leaf),
                                          err_msg=str(path))
