"""PyTorch port vs JAX package: the flagship intro_tc train step, and the
single-phase vae / tc steps.

One and two steps, paired and unpaired, on the same weights (JAX init
through the weight bridge), the same batches and the same noise: the
JAX step draws its six normals from its 7-way key split
(solvers/intro.py:81-85); the test reproduces those draws outside the
step from the same keys, shapes and dtypes and hands them to the port.

JAX runs tc_impl='xla' (its plain reference); the port runs
tc_impl='pallas', which on CPU tensors takes the kernels' plain version.
Compared: the step metrics, the updated parameters, the BatchNorm running
statistics and both Adam moments, at rtol 1e-4 / atol 1e-5.

Both packages run this comparison in float64 (JAX in x64 mode, the port
with float64 parameters and compute), keeping the models' own fp32 casts
of mu/logvar and of the pre-sigmoid output. In float32 the JAX step is
not accurate enough to be the oracle here: the encoder pass over the
decoder's outputs normalizes with batch statistics E[x²]-E[x]² of 8
samples, and XLA's fp32 gradient through them is off from the float64
value by up to 2e-2 of the largest entry (res_in_8.conv1), where the
port's fp32 gradient is within 1e-6; Adam then turns those errors into
sign flips of whole updates. In float64 the two steps agree to ~2e-5 of
the metrics and ~5e-6 absolute in the parameters — the residue of the
fp32 heads — which the tolerance above bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intro_tc_vae_tpu.data import Synthetic as JSynthetic
from intro_tc_vae_tpu.models import Decoder as JDecoder
from intro_tc_vae_tpu.models import Encoder as JEncoder
from intro_tc_vae_tpu.solvers import make_optimizer as jmake_optimizer
from intro_tc_vae_tpu.solvers import make_solver as jmake_solver
from intro_tc_vae_tpu.solvers.intro import build_intro_step as jbuild_intro_step
from intro_tc_vae_tpu.solvers.vae import build_vae_step as jbuild_vae_step
from intro_tc_vae_tpu_torch.data import Synthetic
from intro_tc_vae_tpu_torch.models import Decoder, Encoder, SoftIntroVAE, conv_output_size
from intro_tc_vae_tpu_torch.solvers import NOISE_KEYS, make_optimizer, make_solver
from intro_tc_vae_tpu_torch.utils import flax_to_port
from tests._torch_bf16 import U as BF16_U
from tests._torch_bf16 import rounded_layers

SMALL = dict(arch="conv", cdim=3, zdim=8, channels=(16, 32), image_size=32)
COS = conv_output_size(32, (16, 32))
B = 8
HYPER = dict(recon_loss_type="mse", beta_kl=0.5, beta_rec=0.75, beta_neg=512.0,
             gamma_r=1e-8)
TOL = dict(rtol=1e-4, atol=1e-5)
METRICS = ("lossE", "lossD", "loss_kl", "loss_rec", "kl_loss_unscaled",
           "r_loss_unscaled", "expelbo_r", "expelbo_f", "diff_kl", "fc_grad_norm")


def _dataset():
    return JSynthetic(image_size=32, cdim=3, sizes=(2, 2, 4, 4))  # N = 64


def _batches():
    ds = _dataset()
    return [ds.get_batch(np.arange(k * B, (k + 1) * B)) for k in range(2)]


def _jax_noise(rng_key):
    """The step's own draws: split 7 ways, keys 1..6 -> N(0, I) [B, z]; the
    prior in the default float type, the reparameterization noise in
    float32, the dtype of mu/logvar (ops.reparameterize)."""
    keys = jax.random.split(rng_key, 7)
    shape = (B, SMALL["zdim"])
    return {name: np.asarray(jax.random.normal(
                keys[i + 1], shape, **({} if name == "prior" else {"dtype": jnp.float32})))
            for i, name in enumerate(NOISE_KEYS)}


def _moments(opt_state, field):
    return {"encoder": getattr(opt_state[0][0], field),
            "decoder": getattr(opt_state[1][0], field)}


def _run_jax(paired):
    """Two JAX steps in float64 (x64 mode): params, BN statistics, batch,
    noise and Adam state in f64; the models' fp32 casts of mu/logvar and
    of the pre-sigmoid output stay as they are."""
    solver = jmake_solver(
        "intro_tc", dataset=_dataset(), encoder=JEncoder(**SMALL),
        decoder=JDecoder(**SMALL), batch_size=B,
        optimizer_e=jmake_optimizer("adam", 2e-4),
        optimizer_d=jmake_optimizer("adam", 2e-4), tc_impl="xla", **HYPER)
    batches = [b.astype(np.float64) for b in _batches()]
    state = solver.init_state(jax.random.key(0), jnp.asarray(batches[0], jnp.float32))
    init = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                  (state.params, state.batch_stats))
    with jax.enable_x64(True):
        params, stats = jax.tree_util.tree_map(jnp.asarray, init)
        state = state.replace(
            params=params, batch_stats=stats,
            opt_state_e=solver.optimizer_e.init(params["encoder"]),
            opt_state_d=solver.optimizer_d.init(params["decoder"]))
        step = jax.jit(jbuild_intro_step(solver.hyper, solver.encoder, solver.decoder,
                                         solver.optimizer_e, solver.optimizer_d,
                                         paired=paired))
        out = []
        for batch in batches:
            state, record = _jax_step(step, state, batch)
            out.append(record)
    return init, batches, out


def _jax_step(step, state, batch):
    noise = _jax_noise(state.rng)
    state, metrics = step(state, jnp.asarray(batch))
    return state, dict(
        noise=noise,
        metrics={k: float(metrics[k]) for k in METRICS},
        state=flax_to_port(state.params, state.batch_stats, "conv", COS),
        mu=flax_to_port(_moments((state.opt_state_e, state.opt_state_d), "mu"),
                        None, "conv", COS),
        nu=flax_to_port(_moments((state.opt_state_e, state.opt_state_d), "nu"),
                        None, "conv", COS),
    )


def _port_solver(paired, init, dtype=torch.float32, name="intro_tc", arch="conv",
                 clip=None):
    small = dict(SMALL, arch=arch)
    enc = Encoder(**small, compute_dtype=dtype)
    dec = Decoder(**small, compute_dtype=dtype)
    model = SoftIntroVAE(enc, dec).to(dtype)
    if init is not None:
        model.load_state_dict(flax_to_port(*init, arch, COS))
    solver = make_solver(
        name, dataset=Synthetic(image_size=32, cdim=3, sizes=(2, 2, 4, 4)),
        encoder=enc, decoder=dec, batch_size=B,
        optimizer_e=make_optimizer("adam", 2e-4),
        optimizer_d=make_optimizer("adam", 2e-4), tc_impl="pallas",
        fuse_passes=paired, clip=clip, **HYPER)
    return solver, model


def _run_port(paired, init, batches, noises, metric_names=METRICS, **solver_kw):
    solver, model = _port_solver(paired, init, torch.float64, **solver_kw)
    state = solver.init_state(0)
    out = []
    for batch, noise in zip(batches, noises):
        x = torch.from_numpy(batch.transpose(0, 3, 1, 2).copy())
        state, metrics = solver.train_step(
            state, x, noise={k: torch.tensor(v) for k, v in noise.items()})
        mu, nu = {}, {}
        for side, opt in (("encoder", state.opt_e), ("decoder", state.opt_d)):
            for n, p in getattr(model, side).named_parameters():
                mu[f"{side}.{n}"] = opt.state[p]["exp_avg"].clone()
                nu[f"{side}.{n}"] = opt.state[p]["exp_avg_sq"].clone()
        out.append(dict(
            metrics={k: float(metrics[k]) for k in metric_names},
            state={k: v.clone() for k, v in model.state_dict().items()},
            mu=mu,
            nu=nu,
        ))
    return out


@pytest.fixture(scope="module", params=[True, False], ids=["paired", "unpaired"])
def runs(request):
    init, batches, jax_out = _run_jax(request.param)
    port_out = _run_port(request.param, init, batches, [o["noise"] for o in jax_out])
    return jax_out, port_out


def _assert_step_matches(want, got, metric_names):
    for name in metric_names:
        np.testing.assert_allclose(got["metrics"][name], want["metrics"][name],
                                   err_msg=name, **TOL)
    for part in ("state", "mu", "nu"):
        assert set(got[part]) >= set(want[part])
        for key, ref in want[part].items():
            np.testing.assert_allclose(got[part][key].numpy(), ref.numpy(),
                                       err_msg=f"{part} {key}", **TOL)


@pytest.mark.parametrize("k", [1, 2])
def test_intro_tc_step_matches_jax(runs, k):
    jax_out, port_out = runs
    _assert_step_matches(jax_out[k - 1], port_out[k - 1], METRICS)


@pytest.mark.parametrize("paired", [True, False], ids=["paired", "unpaired"])
def test_bf16_intro_tc_step_matches_jax(paired):
    """One ``precision: "bf16"`` step (float32 parameters, bf16 compute,
    the flagship recipe's precision) in both packages on the same weights,
    batch and noise: the step's metrics and the BatchNorm running statistics
    it leaves.

    Tolerance (tests/_torch_bf16.py): a metric is a mean over the batch and
    the pixels or latents of values that passed L = 18 + 21 rounded layers
    (one encoder and one decoder pass; the deeper chains of the fake passes
    are renormalized by every BatchNorm on the way), so the two packages'
    independent roundings leave it within sqrt(L) * 2^-8 = 2.4 %. A running
    statistic is an average of such batch means: within the same share of
    its tensor's largest entry. The updated parameters are not compared:
    Adam's first update is lr * sign(g) and bf16 flips the sign of small
    gradients."""
    kw = dict(SMALL, dtype=jnp.bfloat16)
    solver = jmake_solver(
        "intro_tc", dataset=_dataset(), encoder=JEncoder(**kw), decoder=JDecoder(**kw),
        batch_size=B, optimizer_e=jmake_optimizer("adam", 2e-4),
        optimizer_d=jmake_optimizer("adam", 2e-4), tc_impl="xla", **HYPER)
    batch = _batches()[0]
    state = solver.init_state(jax.random.key(0), jnp.asarray(batch))
    init = jax.tree_util.tree_map(np.asarray, (state.params, state.batch_stats))
    step = jax.jit(jbuild_intro_step(solver.hyper, solver.encoder, solver.decoder,
                                     solver.optimizer_e, solver.optimizer_d, paired=paired))
    state, want = _jax_step(step, state, batch)

    enc = Encoder(**SMALL, compute_dtype=torch.bfloat16)
    dec = Decoder(**SMALL, compute_dtype=torch.bfloat16)
    model = SoftIntroVAE(enc, dec)
    model.load_state_dict(flax_to_port(*init, "conv", COS))
    port = make_solver(
        "intro_tc", dataset=Synthetic(image_size=32, cdim=3, sizes=(2, 2, 4, 4)),
        encoder=enc, decoder=dec, batch_size=B, optimizer_e=make_optimizer("adam", 2e-4),
        optimizer_d=make_optimizer("adam", 2e-4), tc_impl="pallas", fuse_passes=paired,
        **HYPER)
    _, metrics = port.train_step(
        port.init_state(0), torch.from_numpy(batch.transpose(0, 3, 1, 2).copy()),
        noise={k: torch.tensor(v) for k, v in want["noise"].items()})

    assert all(p.dtype == torch.float32 for p in model.parameters())
    layers = rounded_layers(enc) + rounded_layers(dec)
    assert layers == 39
    tol = np.sqrt(layers) * BF16_U
    for name in METRICS:
        assert np.isfinite(float(metrics[name])), name
        np.testing.assert_allclose(float(metrics[name]), want["metrics"][name], rtol=tol,
                                   err_msg=name)
    got = model.state_dict()
    keys = [k for k in want["state"] if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        ref = want["state"][k].numpy()
        np.testing.assert_allclose(got[k].numpy(), ref, rtol=0, err_msg=k,
                                   atol=tol * float(np.abs(ref).max()))


# the single-phase ELBO step: 'vae' on the res arch (configs/vae_synthetic.json),
# 'tc' on the conv arch with the global-norm clip (configs/tc_dsprites.json's
# solver and arch); conv_impl 'xla' in both packages
ELBO_CASES = {"vae": dict(arch="res", clip=None), "tc": dict(arch="conv", clip=0.5)}
ELBO_METRICS = ("loss_enc", "loss_dec", "loss_kl", "loss_rec", "kl_loss_unscaled",
                "r_loss_unscaled", "fc_grad_norm")


def _run_jax_elbo(name, arch, clip):
    """Two JAX ELBO steps in float64, as _run_jax does for the intro step;
    the one reparameterization draw is the step's own (vae.py:31)."""
    small = dict(SMALL, arch=arch)
    solver = jmake_solver(
        name, dataset=_dataset(), encoder=JEncoder(**small), decoder=JDecoder(**small),
        batch_size=B, optimizer_e=jmake_optimizer("adam", 2e-4),
        optimizer_d=jmake_optimizer("adam", 2e-4), tc_impl="xla", clip=clip, **HYPER)
    batches = [b.astype(np.float64) for b in _batches()]
    state = solver.init_state(jax.random.key(0), jnp.asarray(batches[0], jnp.float32))
    init = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                  (state.params, state.batch_stats))
    metric_names = ELBO_METRICS + (("total_norm", "L2") if clip else ())
    out = []
    with jax.enable_x64(True):
        params, stats = jax.tree_util.tree_map(jnp.asarray, init)
        state = state.replace(
            params=params, batch_stats=stats,
            opt_state_e=solver.optimizer_e.init(params["encoder"]),
            opt_state_d=solver.optimizer_d.init(params["decoder"]))
        step = jax.jit(jbuild_vae_step(solver.hyper, solver.encoder, solver.decoder,
                                       solver.optimizer_e, solver.optimizer_d))
        for batch in batches:
            eps = jax.random.normal(jax.random.split(state.rng)[1],
                                    (B, SMALL["zdim"]), dtype=jnp.float32)
            state, metrics = step(state, jnp.asarray(batch))
            moments = (state.opt_state_e, state.opt_state_d)
            out.append(dict(
                noise={"real": np.asarray(eps)},
                metrics={k: float(metrics[k]) for k in metric_names},
                state=flax_to_port(state.params, state.batch_stats, arch, COS),
                mu=flax_to_port(_moments(moments, "mu"), None, arch, COS),
                nu=flax_to_port(_moments(moments, "nu"), None, arch, COS),
            ))
    return init, batches, out, metric_names


@pytest.fixture(scope="module", params=sorted(ELBO_CASES))
def elbo_runs(request):
    case = ELBO_CASES[request.param]
    init, batches, jax_out, metric_names = _run_jax_elbo(request.param, **case)
    port_out = _run_port(True, init, batches, [o["noise"] for o in jax_out], metric_names,
                         name=request.param, **case)
    return jax_out, port_out, metric_names


@pytest.mark.parametrize("k", [1, 2])
def test_elbo_step_matches_jax(elbo_runs, k):
    """One and two vae / tc steps: metrics, updated parameters, BatchNorm
    statistics and both Adam moments, float64 in both packages."""
    jax_out, port_out, metric_names = elbo_runs
    _assert_step_matches(jax_out[k - 1], port_out[k - 1], metric_names)


def test_step_draws_its_own_noise_deterministically():
    """Without injected noise the step draws from the solver's seeded
    generator (fp32): the same seed gives the same step, and the paired
    step equals the unpaired one — metrics and gradients (Adam's first
    moments; the updates themselves amplify round-off where a gradient
    is ~0, so they are not compared)."""
    batch = torch.from_numpy(_batches()[0].transpose(0, 3, 1, 2).copy())
    results = []
    for paired in (True, True, False):
        torch.manual_seed(3)
        solver, model = _port_solver(paired, None)
        state = solver.init_state(7)
        state, metrics = solver.train_step(state, batch)
        solver.check_finite(metrics)
        assert state.step == 1
        grads = [state.opt_e.state[p]["exp_avg"] for p in model.encoder.parameters()]
        grads += [state.opt_d.state[p]["exp_avg"] for p in model.decoder.parameters()]
        results.append((metrics, grads))
    (m0, g0), (m1, g1), (m2, g2) = results
    for name in METRICS:
        assert float(m0[name]) == float(m1[name])
        np.testing.assert_allclose(float(m2[name]), float(m0[name]), err_msg=name, **TOL)
    for a, b, c in zip(g0, g1, g2):
        assert torch.equal(a, b)
        np.testing.assert_allclose(c.numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(a.abs().max()))


def test_non_finite_loss_raises():
    solver, _ = _port_solver(True, None)
    with pytest.raises(RuntimeError, match="non-finite loss_enc"):
        solver.check_finite({"loss_enc": torch.tensor(float("nan")),
                             "loss_dec": torch.tensor(0.0)})
