"""PyTorch port vs JAX package: the model options ``tile_rows``
(``StripTiledConv``) and ``pack_predict`` / ``--pack``
(``PackedPredictConv``), and the reference-checkpoint loader
``utils.load_torch_checkpoint``.

Weights come from the JAX package's init (BatchNorm parameters and
statistics randomized) through the weight bridge; inputs are seeded numpy.
Tolerances are stated where they are used: the strip-tiled and packed
forms sum the plain conv's products in another order, so in float32 they
agree with it to rounding, in float64 to ~1e-15.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from intro_tc_vae_tpu.models import Decoder as JDecoder
from intro_tc_vae_tpu.models import Encoder as JEncoder
from intro_tc_vae_tpu.models.blocks import PackedPredictConv as JPackedPredictConv
from intro_tc_vae_tpu.models.blocks import StripTiledConv as JStripTiledConv
from intro_tc_vae_tpu.solvers import make_optimizer as jmake_optimizer
from intro_tc_vae_tpu.solvers import make_solver as jmake_solver
from intro_tc_vae_tpu.solvers.base import decode as jdecode
from intro_tc_vae_tpu.solvers.base import unit_f32_to_u8 as junit_f32_to_u8
from intro_tc_vae_tpu.solvers.intro import build_intro_step as jbuild_intro_step
from intro_tc_vae_tpu.utils.transplant import load_torch_checkpoint as jload_torch_checkpoint
from intro_tc_vae_tpu_torch import evaluate, sample
from intro_tc_vae_tpu_torch.config import load_config
from intro_tc_vae_tpu_torch.data import Synthetic
from intro_tc_vae_tpu_torch.models import (
    Decoder,
    Encoder,
    PallasConv3x3,
    SoftIntroVAE,
    StripTiledConv,
    conv_output_size,
    resolve_tile_rows,
)
from intro_tc_vae_tpu_torch.models.blocks import (
    Conv2d,
    GroupedBatchNorm,
    PackedPredictConv,
    conv,
)
from intro_tc_vae_tpu_torch.ops import conv_cuda
from intro_tc_vae_tpu_torch.solvers import make_optimizer, make_solver
from intro_tc_vae_tpu_torch.train import train_soft_intro_vae
from intro_tc_vae_tpu_torch.utils import flax_to_port, load_torch_checkpoint, save_checkpoint
from tests._torch_bf16 import assert_close_bf16, rounded_layers
from tests._torch_threads import one_thread  # noqa: F401  (autouse)
from tests.test_torch_models import _randomize
from tests.test_torch_step import (
    B,
    HYPER,
    METRICS,
    _assert_step_matches,
    _batches,
    _dataset,
    _jax_step,
)

CPU = torch.device("cpu")
SMALL = dict(arch="conv", cdim=3, zdim=8, channels=(16, 32), image_size=32)
COS = conv_output_size(32, (16, 32))
TOL = dict(rtol=1e-4, atol=1e-5)  # fp32 models, as tests/test_torch_models.py


def _conv_sd(node: dict) -> dict:
    """A flax conv's {kernel [k, k, in, out], bias} as a Conv2d state_dict."""
    sd = {"weight": torch.from_numpy(np.asarray(node["kernel"]).transpose(3, 2, 0, 1).copy())}
    if "bias" in node:
        sd["bias"] = torch.from_numpy(np.asarray(node["bias"]).copy())
    return sd


def _grads(module, x: torch.Tensor, cot: torch.Tensor) -> list:
    """Gradients of sum(module(x) * cot) for the input and every parameter."""
    x = x.detach().clone().requires_grad_()
    return torch.autograd.grad((module(x) * cot).sum(), [x, *module.parameters()])


def _assert_grads_close(got: list, want: list, rtol: float, atol: float) -> None:
    """Every entry within rtol of itself plus atol of its tensor's largest
    entry (a sum of many products, reordered, rounds by about the largest)."""
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=rtol,
                                   atol=atol * float(w.abs().max()))


# ---------------------------------------------------------------------------
# StripTiledConv
# ---------------------------------------------------------------------------

# kernel, bias, H, tile_rows, strips (1: the plain conv inside the module)
STRIP_CASES = [
    (3, False, 16, 8, 2),
    (3, False, 32, 8, 4),
    (5, True, 32, 8, 4),     # the predict conv's shape
    (3, False, 24, 16, 1),   # H < 2 * tile_rows
    (3, False, 50, 16, 1),   # H % (H // tile_rows) != 0
]


@pytest.mark.parametrize("kernel,bias,h,tile_rows,strips", STRIP_CASES)
def test_strip_tiled_conv_matches_jax(kernel, bias, h, tile_rows, strips, monkeypatch):
    """8 -> 16 channels, batch 2, float32: the output against JAX's
    StripTiledConv (rtol 1e-5, atol 1e-6); the input, weight and bias
    gradients against the port's plain conv on the same weights (rtol
    1e-5, atol 1e-6 of the tensor's largest entry). With t >= 2 strips
    and 16 channels, a reassembly that interleaves channels and strips
    (NCHW is not JAX's NHWC) would show here; the conv runs on N * t
    stacked strips."""
    rng = np.random.RandomState(kernel * h + tile_rows)
    x = rng.randn(2, h, h, 8).astype(np.float32)
    jm = JStripTiledConv(features=16, kernel=kernel, tile_rows=tile_rows, use_bias=bias,
                         in_ch=8)
    v = jm.init(jax.random.key(0), jnp.asarray(x))
    want = np.asarray(jm.apply(v, jnp.asarray(x)))

    m = conv(8, 16, kernel, tile_rows=tile_rows, bias=bias)
    assert type(m) is StripTiledConv
    m.load_state_dict(_conv_sd(v["params"]))
    plain = Conv2d(8, 16, kernel, bias=bias)
    plain.load_state_dict(m.state_dict())
    assert list(m.state_dict()) == list(plain.state_dict())

    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    batches, conv2d = [], F.conv2d
    monkeypatch.setattr(F, "conv2d", lambda inp, *a, **k: (batches.append(inp.shape[0]),
                                                            conv2d(inp, *a, **k))[1])
    with torch.no_grad():
        y = m(xt)
    monkeypatch.undo()
    assert batches == [2 * strips]
    np.testing.assert_allclose(y.numpy().transpose(0, 2, 3, 1), want, rtol=1e-5, atol=1e-6)
    cot = torch.from_numpy(rng.randn(*y.shape).astype(np.float32))
    _assert_grads_close(_grads(m, xt, cot), _grads(plain, xt, cot), 1e-5, 1e-6)


# ---------------------------------------------------------------------------
# PackedPredictConv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("block", [2, 4])
def test_packed_predict_conv_matches_jax(block, dtype):
    """The 5x5 conv 8 -> 3 channels with bias at 16x16, batch 2: the
    output against JAX's PackedPredictConv (JAX in x64 mode for float64);
    the gradients of the input, ``weight`` and ``bias`` against the plain
    5x5 conv's: float64 rtol 1e-9 (atol 1e-12 of the largest entry),
    float32 rtol 1e-5 (atol 1e-6 of the largest entry). The parameters
    are the plain conv's (same keys and shapes); the one-hot table is a
    buffer outside the state_dict."""
    rng = np.random.RandomState(block)
    x = rng.randn(2, 16, 16, 8)
    f64 = dtype == torch.float64
    jm = JPackedPredictConv(cdim=3, in_ch=8, block=block)
    with jax.enable_x64(f64):
        xj = jnp.asarray(x, jnp.float64 if f64 else jnp.float32)
        v = jm.init(jax.random.key(0), xj)
        v = jax.tree_util.tree_map(lambda a: a.astype(xj.dtype), v)
        want = np.asarray(jm.apply(v, xj))

    m = PackedPredictConv(8, 3, block, compute_dtype=dtype).to(dtype)
    m.load_state_dict(_conv_sd(v["params"]))
    plain = Conv2d(8, 3, 5, bias=True, compute_dtype=dtype).to(dtype)
    assert list(m.state_dict()) == list(plain.state_dict()) == ["weight", "bias"]
    assert "onehot" in dict(m.named_buffers())
    plain.load_state_dict(m.state_dict())

    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(dtype)
    rtol, atol = (1e-9, 1e-12) if f64 else (1e-5, 1e-6)
    with torch.no_grad():
        y = m(xt)
    np.testing.assert_allclose(y.numpy().transpose(0, 2, 3, 1), want, rtol=rtol,
                               atol=atol * float(np.abs(want).max()))
    cot = torch.from_numpy(rng.randn(*y.shape)).to(dtype)
    _assert_grads_close(_grads(m, xt, cot), _grads(plain, xt, cot), rtol, atol)


def test_decoder_packs_only_a_multiple_of_the_block():
    """pack_predict > 1 dividing the image size: PackedPredictConv;
    0, 1 or an indivisible block: the plain conv (JAX vae.py:187), and
    with tile_rows the strip-tiled one. resolve_tile_rows: -1 -> 0."""
    def predict(**kw):
        return type(Decoder(**SMALL, **kw).main["predict"])

    assert predict(pack_predict=2) is predict(pack_predict=4) is PackedPredictConv
    assert predict() is predict(pack_predict=1) is predict(pack_predict=3) is Conv2d
    assert predict(pack_predict=3, tile_rows=8) is StripTiledConv
    assert predict(pack_predict=2, tile_rows=8) is PackedPredictConv
    assert resolve_tile_rows(-1, 256) == 0 and resolve_tile_rows(16, 64) == 16


# ---------------------------------------------------------------------------
# the full models, against the JAX models with the same option
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    rng = np.random.RandomState(1)
    ev = JEncoder(**SMALL).init(jax.random.key(1), jnp.zeros((1, 32, 32, 3)), True)
    dv = JDecoder(**SMALL).init(jax.random.key(2), jnp.zeros((1, 8)), True)
    params = _randomize({"encoder": ev["params"], "decoder": dv["params"]}, rng)
    stats = _randomize({"encoder": ev["batch_stats"], "decoder": dv["batch_stats"]}, rng)
    return params, stats


MODEL_CASES = {"encoder tile_rows 8": ("encoder", dict(tile_rows=8)),
               "decoder tile_rows 8": ("decoder", dict(tile_rows=8)),
               "decoder pack 2": ("decoder", dict(pack_predict=2)),
               "decoder pack 4": ("decoder", dict(pack_predict=4))}


def _modules(side: str, option: dict, dtype=torch.float32):
    """(JAX module, port module) of ``side`` with ``option``."""
    jcls, cls = (JEncoder, Encoder) if side == "encoder" else (JDecoder, Decoder)
    jkw = dict(SMALL, dtype=jnp.bfloat16) if dtype == torch.bfloat16 else SMALL
    return jcls(**jkw, **option), cls(**SMALL, **option, compute_dtype=dtype)


def _inputs(side: str, rng) -> np.ndarray:
    return (rng.rand(8, 32, 32, 3) if side == "encoder" else rng.randn(8, 8)).astype(np.float32)


def _nchw(side: str, a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.transpose(0, 3, 1, 2).copy() if side == "encoder" else a)


@pytest.mark.parametrize("train,groups", [(True, 1), (True, 2), (False, 1)])
@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_models_with_options_match_jax(jax_params, rng, case, train, groups):
    """The encoder with tile_rows 8 (the stem in 4 strips, res_in_16 in 2,
    res_in_8 plain) and the decoder with tile_rows 8 or pack_predict 2 or
    4, against the JAX modules with the same option on the same weights:
    outputs and BatchNorm running statistics at rtol 1e-4 / atol 1e-5."""
    side, option = MODEL_CASES[case]
    params, stats = jax_params
    jmod, net = _modules(side, option)
    inp = _inputs(side, rng)
    ref, upd = jmod.apply({"params": params[side], "batch_stats": stats[side]},
                          jnp.asarray(inp), train, groups, mutable=["batch_stats"])
    refs = ref if side == "encoder" else (ref,)

    net.load_state_dict({k[len(side) + 1:]: v for k, v in
                         flax_to_port(params, stats, "conv", COS).items()
                         if k.startswith(side)})
    net.train(train)
    with torch.no_grad():
        outs = net(_nchw(side, inp), groups)
    outs = outs if side == "encoder" else (outs.permute(0, 2, 3, 1),)
    for o, r in zip(outs, refs):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)
    new = flax_to_port(params, dict(stats, **{side: upd.get("batch_stats", stats[side])}),
                       "conv", COS)
    got = net.state_dict()
    for k, want in new.items():
        if k.startswith(side) and k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k[len(side) + 1:]].numpy(), want.numpy(),
                                       err_msg=k, **TOL)


@pytest.mark.parametrize("side", ["encoder", "decoder"])
def test_bf16_models_with_options_match_jax(jax_params, rng, side):
    """precision bf16 (float32 weights, bf16 compute) with tile_rows 8, and
    for the decoder pack_predict 2 as well, against the JAX modules with
    dtype bf16, train mode: within tests/_torch_bf16.py's bound for L
    rounded layers (18 and 21, as without the options: each form rounds
    its conv's output once)."""
    params, stats = jax_params
    option = dict(tile_rows=8, **({} if side == "encoder" else dict(pack_predict=2)))
    jmod, net = _modules(side, option, torch.bfloat16)
    inp = _inputs(side, rng)
    ref, _ = jmod.apply({"params": params[side], "batch_stats": stats[side]},
                        jnp.asarray(inp), True, 1, mutable=["batch_stats"])
    refs = ref if side == "encoder" else (ref,)
    net.load_state_dict({k[len(side) + 1:]: v for k, v in
                         flax_to_port(params, stats, "conv", COS).items()
                         if k.startswith(side)})
    layers = rounded_layers(net)
    assert layers == (18 if side == "encoder" else 21)
    with torch.no_grad():
        outs = net(_nchw(side, inp))
    outs = outs if side == "encoder" else (outs.permute(0, 2, 3, 1),)
    for o, r in zip(outs, refs):
        assert o.dtype == torch.float32
        assert_close_bf16(o.numpy(), np.asarray(r), layers, side)


# ---------------------------------------------------------------------------
# one intro_tc step with both options, against the JAX step
# ---------------------------------------------------------------------------

TILE = dict(tile_rows=8)  # with pack_predict 2 on the decoder


@pytest.fixture(scope="module")
def option_step():
    """One paired intro_tc step with tile_rows 8 and pack_predict 2 in both
    packages, float64 (JAX in x64 mode, as tests/test_torch_step.py runs
    it): JAX's record and the port's metrics, state and Adam moments."""
    jenc, jdec = JEncoder(**SMALL, **TILE), JDecoder(**SMALL, **TILE, pack_predict=2)
    solver = jmake_solver("intro_tc", dataset=_dataset(), encoder=jenc, decoder=jdec,
                          batch_size=B, optimizer_e=jmake_optimizer("adam", 2e-4),
                          optimizer_d=jmake_optimizer("adam", 2e-4), tc_impl="xla", **HYPER)
    batch = _batches()[0].astype(np.float64)
    state = solver.init_state(jax.random.key(0), jnp.asarray(batch, jnp.float32))
    init = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                  (state.params, state.batch_stats))
    with jax.enable_x64(True):
        params, stats = jax.tree_util.tree_map(jnp.asarray, init)
        state = state.replace(params=params, batch_stats=stats,
                              opt_state_e=solver.optimizer_e.init(params["encoder"]),
                              opt_state_d=solver.optimizer_d.init(params["decoder"]))
        step = jax.jit(jbuild_intro_step(solver.hyper, solver.encoder, solver.decoder,
                                         solver.optimizer_e, solver.optimizer_d, paired=True))
        _, want = _jax_step(step, state, batch)

    enc = Encoder(**SMALL, **TILE, compute_dtype=torch.float64)
    dec = Decoder(**SMALL, **TILE, pack_predict=2, compute_dtype=torch.float64)
    model = SoftIntroVAE(enc, dec).double()
    model.load_state_dict(flax_to_port(*init, "conv", COS))
    port = make_solver("intro_tc", dataset=Synthetic(image_size=32, cdim=3, sizes=(2, 2, 4, 4)),
                       encoder=enc, decoder=dec, batch_size=B,
                       optimizer_e=make_optimizer("adam", 2e-4),
                       optimizer_d=make_optimizer("adam", 2e-4), tc_impl="pallas",
                       fuse_passes=True, **HYPER)
    pstate, metrics = port.train_step(
        port.init_state(0), torch.from_numpy(batch.transpose(0, 3, 1, 2).copy()),
        noise={k: torch.tensor(v) for k, v in want["noise"].items()})
    mu, nu = {}, {}
    for side, opt in (("encoder", pstate.opt_e), ("decoder", pstate.opt_d)):
        for n, p in getattr(model, side).named_parameters():
            mu[f"{side}.{n}"] = opt.state[p]["exp_avg"]
            nu[f"{side}.{n}"] = opt.state[p]["exp_avg_sq"]
    got = dict(metrics={k: float(metrics[k]) for k in METRICS}, state=model.state_dict(),
               mu=mu, nu=nu)
    return want, got, model


def test_intro_tc_step_with_options_matches_jax(option_step):
    """Metrics, updated parameters, BatchNorm statistics and both Adam
    moments at tests/test_torch_step.py's tolerance (rtol 1e-4, atol
    1e-5, float64 in both packages)."""
    want, got, model = option_step
    assert isinstance(model.decoder.main["predict"], PackedPredictConv)
    assert isinstance(model.encoder.main["0"], StripTiledConv)
    _assert_step_matches(want, got, METRICS)


# ---------------------------------------------------------------------------
# routing: tile_rows takes the 3x3 convs off the conv kernels
# ---------------------------------------------------------------------------

SMALL64 = dict(arch="conv", cdim=3, zdim=8, channels=(64,), image_size=32)


@pytest.mark.parametrize("tile_rows,calls", [(0, {"fwd": 44, "dw": 12}),
                                             (8, {"fwd": 0, "dw": 0})])
def test_tile_rows_routes_no_conv_to_the_kernels(monkeypatch, tile_rows, calls):
    """conv_impl 'pallas' at channels (64,), 32 px, where every 3x3 conv is
    one the kernels take (tests/test_torch_conv.py counts 44 forward and 12
    dW calls for one paired intro_tc step): with tile_rows 8 no
    PallasConv3x3 is built and the step makes no kernel wrapper call, as
    JAX's conv() routes to PallasConv3x3 only with tile_rows 0."""
    counted = {"fwd": 0, "dw": 0}
    fwd, dw = conv_cuda.conv3x3_fwd, conv_cuda.conv3x3_dw

    def count_fwd(x, w, rot=False):
        counted["fwd"] += 1
        return fwd(x, w, rot)

    def count_dw(x, gy):
        counted["dw"] += 1
        return dw(x, gy)

    monkeypatch.setattr(conv_cuda, "conv3x3_fwd", count_fwd)
    monkeypatch.setattr(conv_cuda, "conv3x3_dw", count_dw)
    torch.manual_seed(0)
    kw = dict(SMALL64, conv_impl="pallas", tile_rows=tile_rows)
    enc, dec = Encoder(**kw), Decoder(**kw)
    routed = [m for m in (*enc.modules(), *dec.modules()) if isinstance(m, PallasConv3x3)]
    assert len(routed) == (0 if tile_rows else 6)
    solver = make_solver("intro_tc", dataset=Synthetic(image_size=32, cdim=3, sizes=(2, 2, 4, 4)),
                         encoder=enc, decoder=dec, batch_size=4,
                         optimizer_e=make_optimizer("adam", 2e-4),
                         optimizer_d=make_optimizer("adam", 2e-4), tc_impl="pallas")
    batch = torch.from_numpy(solver.dataset.get_batch(np.arange(4)).transpose(0, 3, 1, 2).copy())
    _, metrics = solver.train_step(solver.init_state(0), batch)
    solver.check_finite(metrics)
    assert counted == calls


# ---------------------------------------------------------------------------
# the trainer, the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("update", [dict(pack_predict=2), dict(tile_rows=8),
                                    dict(pack_predict=-1, tile_rows=-1)],
                         ids=lambda u: ",".join(f"{k}={v}" for k, v in u.items()))
def test_vae_trainer_with_options(tmp_path, update):
    """The single-phase trainer (configs/vae_synthetic.json's solver and
    arch, at the synthetic_small size; the intro_tc trainer runs the same
    options in tests/test_torch_train.py): 4 finite steps, the options'
    modules built, and auto (-1) resolved to off as in JAX."""
    config = load_config(os.path.join(os.path.dirname(__file__), "..", "configs",
                                      "vae_synthetic.json"),
                         dict(dataset="synthetic_small", num_epochs=1, batch_size=16,
                              z_dim=8, checkpoint_dir=str(tmp_path), **update))
    state = train_soft_intro_vae(config, device=CPU)
    assert state.step == len(state.history) == 4
    assert all(math.isfinite(r["loss_enc"]) for r in state.history)
    predict = type(state.model.decoder.main["predict"])
    stem = type(state.model.encoder.main["0"])
    assert predict is {2: PackedPredictConv}.get(config.pack_predict,
                                                StripTiledConv if config.tile_rows > 0 else Conv2d)
    assert stem is (StripTiledConv if config.tile_rows > 0 else Conv2d)


def _checkpoint(tmp_path) -> tuple:
    """A checkpoint of the small model after one train-mode pass, its
    predict conv scaled so that the images spread over [0, 1]."""
    torch.manual_seed(0)
    model = SoftIntroVAE(Encoder(**SMALL), Decoder(**SMALL))
    with torch.no_grad():
        model.decoder.main["predict"].weight.mul_(200.0)
    model.decoder(torch.randn(16, 8))
    model.encoder(torch.rand(16, 3, 32, 32))
    state = type("State", (), {})()
    state.model, state.step = model, 0
    state.opt_e = make_optimizer("adam", 1e-3)(model.encoder.parameters())
    state.opt_d = make_optimizer("adam", 1e-3)(model.decoder.parameters())
    return save_checkpoint(state, 0, 0, checkpoint_dir=str(tmp_path)), model


ARGV = ["--dataset", "synthetic_small", "--arch", "conv", "--z-dim", "8"]


def test_sample_cli_pack_matches_jax(tmp_path):
    """``sample --pack 2`` writes the grid JAX's Decoder(pack_predict=2)
    decodes from the same weights and latents (the JAX CLI draws its
    latents with jax.random, so the latents are the port's): u8 levels
    equal except where the float lies within 1e-5 of a level boundary.
    ``--pack 1`` runs the plain conv, bit-equal to ``--pack 0``."""
    path, model = _checkpoint(tmp_path)
    grids = {p: sample.main(["--checkpoint", path, *ARGV, "--num", "16", "--seed", "3",
                             "--pack", str(p), "--out", str(tmp_path / f"p{p}.png")],
                            device=CPU) for p in (0, 1, 2)}
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "p2.png")), grids[2])
    np.testing.assert_array_equal(grids[1], grids[0])

    from intro_tc_vae_tpu.utils.transplant import torch_state_dict_to_flax

    params, stats = torch_state_dict_to_flax(model.state_dict(), "conv", COS)
    z = torch.randn((16, 8), generator=torch.Generator(device=CPU).manual_seed(3))
    want_f, _ = jdecode(JDecoder(**SMALL, pack_predict=2), params["decoder"],
                        stats["decoder"], jnp.asarray(z.numpy()), train=False)
    want = sample.sample_grid(np.asarray(junit_f32_to_u8(want_f)))
    scaled = np.clip(sample.sample_grid(np.asarray(want_f)), 0, 1) * 255
    near = np.abs(scaled - np.round(scaled)) < 1e-5 * 255
    differ = grids[2] != want
    assert not (differ & ~near).any()
    assert len(np.unique(grids[2])) > 100


def test_evaluate_cli_pack(tmp_path, monkeypatch):
    """``evaluate --pack 2 --fid``: the packed decoder makes the FID's
    fakes, within float32 rounding (1e-6) of ``--pack 0``'s; ``--pack 1``
    makes them bit-equal to ``--pack 0``. The FID keys are the same (the
    disentanglement scores are not compared: they draw their factors
    unseeded, as in JAX, so a degenerate draw may record an error)."""
    from intro_tc_vae_tpu_torch.evaluation import fid

    fakes, encoder_fid = [], fid.encoder_fid
    monkeypatch.setattr(fid, "encoder_fid", lambda solver, state, real, fake, **kw: (
        fakes.append(fake), encoder_fid(solver, state, real, fake, **kw))[1])
    path, _ = _checkpoint(tmp_path)
    argv = ["--checkpoint", path, *ARGV, "--batch", "16", "--num-samples", "32", "--fid",
            "--fid-samples", "32"]
    out = {p: evaluate.main([*argv, "--pack", str(p), "--out", str(tmp_path / f"{p}.json")],
                            device=CPU) for p in (0, 1, 2)}
    assert json.load(open(tmp_path / "2.json")) == out[2]
    fid_keys = [{k for k in out[p] if k.startswith("fid")} for p in (0, 1, 2)]
    assert fid_keys[0] == fid_keys[1] == fid_keys[2] == {"fid_inception_pool3",
                                                         "fid_encoder_features"}
    assert math.isfinite(out[2]["fid_encoder_features"])
    assert len(fakes) == 3 and fakes[0].shape == (32, 32, 32, 3)
    np.testing.assert_array_equal(fakes[1], fakes[0])
    np.testing.assert_allclose(fakes[2], fakes[0], rtol=0, atol=1e-6)
    assert np.std(fakes[0]) > 0.1  # the images spread over [0, 1]


# ---------------------------------------------------------------------------
# the reference-checkpoint loader
# ---------------------------------------------------------------------------

def _reference_payload(model: SoftIntroVAE, arch: str) -> dict:
    """What the reference writes for this model (reference utils.py:26-36):
    its state_dict with every BatchNorm's ``num_batches_tracked`` and, for
    the conv arch, the dead ``conv_expand`` of each block whose widths
    differ, under "model"."""
    sd = dict(model.state_dict())
    for name, m in model.named_modules():
        if isinstance(m, GroupedBatchNorm):
            sd[f"{name}.num_batches_tracked"] = torch.tensor(7)
        if arch == "conv" and name.count(".") == 2 and ".res_in_" in name:
            conv1 = m.conv1.weight
            if conv1.shape[0] != conv1.shape[1]:
                sd[f"{name}.conv_expand.weight"] = torch.randn(conv1.shape[0], conv1.shape[1],
                                                               1, 1)
    return {"epoch": 3, "model": sd}


@pytest.mark.parametrize("arch", ["conv", "res", "inception"])
def test_load_torch_checkpoint_matches_jax(tmp_path, rng, arch):
    """A reference-format .pth of a random model, read by the port's
    load_torch_checkpoint and by the JAX package's: eval-mode encoder and
    decoder outputs agree at rtol 1e-4 / atol 1e-5. A file with a key
    removed, and one with an unknown key, raise naming the key."""
    torch.manual_seed(1)
    kw = dict(SMALL, arch=arch)
    src = SoftIntroVAE(Encoder(**kw), Decoder(**kw))
    src.train()
    src.decoder(torch.randn(8, 8))  # BatchNorm statistics off their init
    src.encoder(torch.rand(8, 3, 32, 32))
    payload = _reference_payload(src, arch)
    assert any(k.endswith("num_batches_tracked") for k in payload["model"])
    assert arch != "conv" or any(".conv_expand." in k for k in payload["model"])
    path = str(tmp_path / "ref.pth")
    torch.save(payload, path)

    torch.manual_seed(2)
    model = load_torch_checkpoint(path, SoftIntroVAE(Encoder(**kw), Decoder(**kw))).eval()
    for k, v in src.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    params, stats = jload_torch_checkpoint(path, arch, COS)
    x = rng.rand(4, 32, 32, 3).astype(np.float32)
    z = rng.randn(4, 8).astype(np.float32)
    (mu, lv), _ = JEncoder(**kw).apply({"params": params["encoder"],
                                        "batch_stats": stats["encoder"]},
                                       jnp.asarray(x), False, mutable=["batch_stats"])
    y, _ = JDecoder(**kw).apply({"params": params["decoder"], "batch_stats": stats["decoder"]},
                                jnp.asarray(z), False, mutable=["batch_stats"])
    with torch.no_grad():
        got_mu, got_lv = model.encoder(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
        got_y = model.decoder(torch.from_numpy(z)).permute(0, 2, 3, 1)
    for got, want in ((got_mu, mu), (got_lv, lv), (got_y, y)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    fresh = SoftIntroVAE(Encoder(**kw), Decoder(**kw))
    gone = dict(payload["model"])
    del gone["decoder.main.predict.bias"]
    torch.save({"model": gone}, tmp_path / "gone.pth")
    with pytest.raises(RuntimeError, match="decoder.main.predict.bias"):
        load_torch_checkpoint(str(tmp_path / "gone.pth"), fresh)
    torch.save(dict(payload["model"], **{"encoder.extra.weight": torch.zeros(1)}),
               tmp_path / "extra.pth")  # no "model": the payload is the state_dict
    with pytest.raises(RuntimeError, match="encoder.extra.weight"):
        load_torch_checkpoint(str(tmp_path / "extra.pth"), fresh)
