"""PyTorch port vs JAX package: the rest of the solver surface.

The 'inception' arch (``models/blocks.py::InceptionResnetBlock``), the
minibatch-weighted TC (``tc_sampling: "weighted"``), the full ELBO
decomposition (``kl_kind: "tc_full"``, ``ops/tc.py::tc_decomposition``
and the ``tc_decomp/{mi,tc,kl}`` tags), activation recompute (``remat``
true / "block" / "pass", ``torch.utils.checkpoint``) and K steps a call
(``scan_steps``), each held to its JAX counterpart on the CPU:

* models and steps on the same weights (JAX init through the weight
  bridge), batches and noise, as tests/test_torch_models.py and
  tests/test_torch_step.py hold the conv arch: float64 in both packages
  at rtol 1e-4 / atol 1e-5 (the residue of the models' fp32 heads), bf16
  at tests/_torch_bf16.py's bound;
* the TC terms in float64 at rtol 1e-9 (the same formulas in the same
  precision; only the summation order differs);
* recompute against the same port step without it, bit-equal in float64,
  BatchNorm statistics included (so they update once a forward);
* K steps a call against K calls of one step, bit-equal, and the trainer
  against the JAX trainer: the batches of each call, every TensorBoard
  entry at its step, the iterations the heavy metrics run at;
* tc_full and weighted on 2 gloo ranks against one process.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intro_tc_vae_tpu import ops as jops
from intro_tc_vae_tpu.data import datasets as jdatasets
from intro_tc_vae_tpu.models import Decoder as JDecoder
from intro_tc_vae_tpu.models import Encoder as JEncoder
from intro_tc_vae_tpu.solvers import make_optimizer as jmake_optimizer
from intro_tc_vae_tpu.solvers import make_solver as jmake_solver
from intro_tc_vae_tpu.solvers.base import SolverHyper as JSolverHyper
from intro_tc_vae_tpu.solvers.base import _scan_steps as jscan_steps
from intro_tc_vae_tpu.solvers.base import kl_term as jkl_term
from intro_tc_vae_tpu.solvers.intro import build_intro_step as jbuild_intro_step
from intro_tc_vae_tpu.solvers.vae import build_vae_step as jbuild_vae_step
from intro_tc_vae_tpu.utils.transplant import torch_state_dict_to_flax
from intro_tc_vae_tpu_torch import ops as tops
from intro_tc_vae_tpu_torch.config import load_config
from intro_tc_vae_tpu_torch.data import Synthetic
from intro_tc_vae_tpu_torch.models import Decoder, Encoder, SoftIntroVAE, conv_output_size
from intro_tc_vae_tpu_torch.ops import conv_cuda
from intro_tc_vae_tpu_torch.solvers import make_optimizer, make_solver
from intro_tc_vae_tpu_torch.solvers.base import SolverHyper, kl_term
from intro_tc_vae_tpu_torch.utils import flax_to_port
from tests import _torch_dp_workers as workers
from tests._torch_bf16 import assert_close_bf16, rounded_layers
from tests._torch_threads import one_thread  # noqa: F401  (autouse)
from tests.test_torch_data import dsprites_root  # noqa: F401  (fixture)
from tests.test_torch_loader import E2E, _dsprites_small_subset
from tests.test_torch_models import _randomize
from tests.test_torch_step import (
    ELBO_METRICS,
    HYPER,
    METRICS,
    _assert_step_matches,
    _dataset,
    _jax_noise,
    _moments,
)
from tests.test_torch_writer import _events

SMALL = dict(cdim=3, zdim=8, channels=(16, 32), image_size=32)
INCEPTION = dict(SMALL, arch="inception")
COS = conv_output_size(32, (16, 32))
B, N = 8, 64
TOL = dict(rtol=1e-4, atol=1e-5)
F64 = dict(rtol=1e-9, atol=1e-12)
CPU = torch.device("cpu")
DECOMP = ("tc_decomp/mi", "tc_decomp/tc", "tc_decomp/kl")


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, -3)))


# ---------------------------------------------------------------------------
# the inception arch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def inception_model():
    """JAX init of the inception encoder and decoder, BatchNorm parameters
    and statistics drawn at random (tests/test_torch_models.py)."""
    rng = np.random.RandomState(2)
    enc, dec = JEncoder(**INCEPTION), JDecoder(**INCEPTION)
    ev = enc.init(jax.random.key(3), jnp.zeros((1, 32, 32, 3)), True)
    dv = dec.init(jax.random.key(4), jnp.zeros((1, 8)), True)
    params = _randomize({"encoder": ev["params"], "decoder": dv["params"]}, rng)
    stats = _randomize({"encoder": ev["batch_stats"], "decoder": dv["batch_stats"]}, rng)
    return params, stats


def _port_model(params, stats, dtype, param_dtype=None):
    """The port's inception model on the JAX weights: parameters in
    ``param_dtype`` (default ``dtype``), computing in ``dtype``."""
    model = SoftIntroVAE(Encoder(**INCEPTION, compute_dtype=dtype),
                         Decoder(**INCEPTION, compute_dtype=dtype)).to(param_dtype or dtype)
    model.load_state_dict(flax_to_port(params, stats, "inception", COS))
    return model


def _side_input(side, rng):
    return (rng.rand(8, 32, 32, 3) if side == "encoder" else rng.randn(8, 8)).astype(np.float64)


def _running_stats(model, params, stats, side, new):
    """(port, JAX) running statistics of ``side`` after the passes."""
    want = flax_to_port(params, dict(stats, **{side: new}), "inception", COS)
    got = model.state_dict()
    keys = [k for k in want if k.startswith(side) and k.endswith(("running_mean",
                                                                   "running_var"))]
    assert keys
    return [(k, got[k].double().numpy(), want[k].double().numpy()) for k in keys]


@pytest.mark.parametrize("side", ["encoder", "decoder"])
@pytest.mark.parametrize("train,groups", [(True, 1), (True, 2), (False, 1)])
def test_inception_models_match_jax(inception_model, rng, side, train, groups):
    """float64 in both packages (JAX in x64): outputs (the fp32 heads) and
    the running statistics the pass leaves."""
    params, stats = inception_model
    inp = _side_input(side, rng)
    with jax.enable_x64(True):
        p64, s64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                          (params, stats))
        module = JEncoder(**INCEPTION) if side == "encoder" else JDecoder(**INCEPTION)
        ref, upd = module.apply({"params": p64[side], "batch_stats": s64[side]},
                                jnp.asarray(inp), train, groups, mutable=["batch_stats"])
        refs = [np.asarray(r) for r in (ref if side == "encoder" else (ref,))]
        new = jax.tree_util.tree_map(np.asarray, upd.get("batch_stats", s64[side]))
    model = _port_model(params, stats, torch.float64)
    model.train(train)
    net = getattr(model, side)
    with torch.no_grad():
        outs = net(_nchw(inp) if side == "encoder" else torch.from_numpy(inp), groups)
    outs = outs if side == "encoder" else (outs.permute(0, 2, 3, 1),)
    for o, r in zip(outs, refs):
        assert o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), r, **TOL)
    for k, got, want in _running_stats(model, params, stats, side, new):
        np.testing.assert_allclose(got, want, err_msg=k, **TOL)


@pytest.mark.parametrize("side", ["encoder", "decoder"])
@pytest.mark.parametrize("train,groups", [(True, 1), (True, 2), (False, 1)])
def test_bf16_inception_models_match_jax(inception_model, rng, side, train, groups):
    """bf16 compute on float32 weights against the JAX modules with
    ``dtype=jnp.bfloat16``, at tests/_torch_bf16.py's bound with L the
    rounded layers: ``rounded_layers`` and, per inception block, the
    residual add and the leaky ReLU after it."""
    params, stats = inception_model
    kw = dict(INCEPTION, dtype=jnp.bfloat16)
    module = JEncoder(**kw) if side == "encoder" else JDecoder(**kw)
    inp = _side_input(side, rng).astype(np.float32)
    ref, upd = module.apply({"params": params[side], "batch_stats": stats[side]},
                            jnp.asarray(inp), train, groups, mutable=["batch_stats"])
    refs = ref if side == "encoder" else (ref,)
    model = _port_model(params, stats, torch.bfloat16, torch.float32)
    model.train(train)
    net = getattr(model, side)
    layers = rounded_layers(net) + 2 * len(net.stages)
    with torch.no_grad():
        outs = net(_nchw(inp) if side == "encoder" else torch.from_numpy(inp), groups)
    outs = outs if side == "encoder" else (outs.permute(0, 2, 3, 1),)
    for o, r in zip(outs, refs):
        assert o.dtype == torch.float32
        assert_close_bf16(o.numpy(), np.asarray(r), layers, side)
    new = upd.get("batch_stats", stats[side])
    for k, got, want in _running_stats(model, params, stats, side, new):
        if not train:
            np.testing.assert_array_equal(got, want, err_msg=k)
            continue
        bound = (1 - 0.9 ** groups) * np.sqrt(layers) * 2.0 ** -8 * np.abs(want).max()
        assert np.abs(got - want).max() <= bound, k


def test_inception_state_dict_roundtrips_through_jax_transplant(inception_model):
    """The JAX package's torch_state_dict_to_flax reads the port's
    inception state_dict (the reference's module names: ``branch_0``,
    ``branch_1.0``, ``branch_1.1``, ``conv``, ``conv_expand``) and gives
    back the JAX trees exactly."""
    params, stats = inception_model
    model = _port_model(params, stats, torch.float32)
    assert "encoder.main.res_in_16.branch_1.1.batch_norm.running_var" in model.state_dict()
    assert model.encoder.main["res_in_16"].branch_0.batch_norm.eps == 1e-4
    p2, s2 = torch_state_dict_to_flax(model.state_dict(), "inception", COS)
    for want, got in ((params, p2), (stats, s2)):
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
        assert len(flat_w) == len(flat_g)
        for path, leaf in flat_w:
            np.testing.assert_array_equal(np.asarray(flat_g[path]), np.asarray(leaf),
                                          err_msg=str(path))


# ---------------------------------------------------------------------------
# the TC terms: tc_decomposition, weighted sampling, kl_term 'tc_full'
# ---------------------------------------------------------------------------

def _tc_inputs(rng, b=16, zdim=8):
    z = rng.randn(b, zdim)
    mu = rng.randn(b, zdim)
    logvar = rng.randn(b, zdim) * 1.5
    logvar[::3, ::2] = -12.0  # the variance floor of the nll density active
    return z, mu, logvar


def _grads_both(jfn, tfn, arrays):
    """Values and gradients of sum(cos(out)) over every output, float64."""
    with jax.enable_x64(True):
        def jloss(*a):
            return sum(jnp.sum(jnp.cos(o)) for o in jfn(*a))
        jargs = [jnp.asarray(a) for a in arrays]
        want = [np.asarray(o) for o in jax.jit(jfn)(*jargs)]
        gwant = [np.asarray(g) for g in jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(*jargs)]
    targs = [torch.tensor(a, requires_grad=True) for a in arrays]
    outs = tfn(*targs)
    sum(torch.cos(o).sum() for o in outs).backward()
    return want, gwant, [o.detach().numpy() for o in outs], [a.grad.numpy() for a in targs]


def test_tc_decomposition_matches_jax(rng):
    """mi, tc and kl per sample (the plain density, the variance indexed
    by i) and their gradients."""
    arrays = _tc_inputs(rng)
    want, gwant, got, ggot = _grads_both(
        lambda *a: jops.tc_decomposition(*a, N), lambda *a: tops.tc_decomposition(*a, N),
        arrays)
    for g, w in zip(got + ggot, want + gwant):
        np.testing.assert_allclose(g, w, **F64)


@pytest.mark.parametrize("reduce", ["mean", "none"])
def test_weighted_total_correlation_matches_jax(rng, reduce):
    arrays = _tc_inputs(rng)
    kw = dict(reduce=reduce, sampling="weighted")
    want, gwant, got, ggot = _grads_both(
        lambda *a: (jops.total_correlation(*a, N, impl="xla", **kw),),
        lambda *a: (tops.total_correlation(*a, N, impl="xla", **kw),), arrays)
    for g, w in zip(got + ggot, want + gwant):
        np.testing.assert_allclose(g, w, **F64)


@pytest.mark.parametrize("reduce", ["mean", "sum", "none"])
def test_kl_term_tc_full_matches_jax(rng, reduce):
    """mi + beta tc + kl and the unscaled mi + tc + kl, and gradients."""
    arrays = _tc_inputs(rng)
    hyper = dict(beta_kl=0.5, dataset_size=N, kl_kind="tc_full", zdim=8)
    want, gwant, got, ggot = _grads_both(
        lambda *a: jkl_term(JSolverHyper(**hyper), *a, reduce=reduce),
        lambda *a: kl_term(SolverHyper(**hyper), *a, reduce=reduce), arrays)
    for g, w in zip(got + ggot, want + gwant):
        np.testing.assert_allclose(g, w, **F64)


# ---------------------------------------------------------------------------
# steps against the JAX steps: inception, tc_full, remat, scan_steps
# ---------------------------------------------------------------------------

def _batches(n):
    ds = _dataset()
    return [ds.get_batch(np.arange(k * B, (k + 1) * B)).astype(np.float64) for k in range(n)]


def _metric_names(name, kl_kind):
    names = METRICS if name.startswith("intro") else ELBO_METRICS
    return names + (DECOMP if kl_kind == "tc_full" else ())


def _jax_steps(name, arch="conv", kl_kind=None, paired=True, remat=False,
               remat_passes=False, calls=2, scan=1):
    """``calls`` float64 calls of the JAX step (x64 mode), each of ``scan``
    steps (``_scan_steps``): the initial weights, the noise each step drew,
    and per step its metrics and, per call, the state and Adam moments as
    port state dicts."""
    small = dict(SMALL, arch=arch)
    solver = jmake_solver(
        name, dataset=_dataset(), encoder=JEncoder(**small, remat=remat),
        decoder=JDecoder(**small, remat=remat), batch_size=B,
        optimizer_e=jmake_optimizer("adam", 2e-4), optimizer_d=jmake_optimizer("adam", 2e-4),
        tc_impl="xla", kl_kind=kl_kind, **HYPER)
    batches = _batches(calls * scan)
    state = solver.init_state(jax.random.key(0), jnp.asarray(batches[0], jnp.float32))
    init = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                  (state.params, state.batch_stats))
    intro = name.startswith("intro")
    names = _metric_names(name, kl_kind)
    noises, metrics, states = [], [], []
    with jax.enable_x64(True):
        params, stats = jax.tree_util.tree_map(jnp.asarray, init)
        state = state.replace(params=params, batch_stats=stats,
                              opt_state_e=solver.optimizer_e.init(params["encoder"]),
                              opt_state_d=solver.optimizer_d.init(params["decoder"]))
        args = (solver.hyper, solver.encoder, solver.decoder, solver.optimizer_e,
                solver.optimizer_d)
        step = (jbuild_intro_step(*args, paired=paired, remat_passes=remat_passes) if intro
                else jbuild_vae_step(*args))
        step = jax.jit(jscan_steps(step, scan) if scan > 1 else step)
        for c in range(calls):
            rng = state.rng
            for _ in range(scan):  # each step splits the key it is handed
                if intro:
                    noises.append(_jax_noise(rng))
                    rng = jax.random.split(rng, 7)[0]
                else:
                    rng, k = jax.random.split(rng)
                    noises.append({"real": np.asarray(jax.random.normal(
                        k, (B, SMALL["zdim"]), dtype=jnp.float32))})
            group = batches[c * scan:(c + 1) * scan]
            state, m = step(state, jnp.asarray(np.stack(group) if scan > 1 else group[0]))
            for j in range(scan):
                metrics.append({k: float(np.asarray(m[k]).reshape(-1)[j]) for k in names})
            moments = (state.opt_state_e, state.opt_state_d)
            states.append(dict(
                state=flax_to_port(state.params, state.batch_stats, arch, COS),
                mu=flax_to_port(_moments(moments, "mu"), None, arch, COS),
                nu=flax_to_port(_moments(moments, "nu"), None, arch, COS)))
    return init, batches, noises, metrics, states


def _port_solver(name, init, arch="conv", kl_kind=None, paired=True, remat=False,
                 remat_passes=False, scan=1, dtype=torch.float64):
    small = dict(SMALL, arch=arch)
    enc = Encoder(**small, compute_dtype=dtype, remat=remat)
    dec = Decoder(**small, compute_dtype=dtype, remat=remat)
    model = SoftIntroVAE(enc, dec).to(dtype)
    if init is not None:
        model.load_state_dict(init)
    solver = make_solver(
        name, dataset=Synthetic(image_size=32, cdim=3, sizes=(2, 2, 4, 4)), encoder=enc,
        decoder=dec, batch_size=B, optimizer_e=make_optimizer("adam", 2e-4),
        optimizer_d=make_optimizer("adam", 2e-4), tc_impl="pallas", kl_kind=kl_kind,
        fuse_passes=paired, remat_passes=remat_passes, scan_steps=scan, **HYPER)
    return solver, model


def _port_steps(name, init, batches, noises, scan=1, **kw):
    """The port's calls on the same batches and noise: per step its
    metrics (drained from the ring), per call the state and Adam moments."""
    solver, model = _port_solver(name, init, scan=scan, **kw)
    state = solver.init_state(0)
    states = []
    for c in range(len(batches) // scan):
        group = [_nchw(b) for b in batches[c * scan:(c + 1) * scan]]
        noise = [{k: torch.tensor(v) for k, v in n.items()}
                 for n in noises[c * scan:(c + 1) * scan]]
        state, _ = solver.train_step(state, torch.stack(group) if scan > 1 else group[0],
                                     noise=noise if scan > 1 else noise[0])
        mu, nu = {}, {}
        for side, opt in (("encoder", state.opt_e), ("decoder", state.opt_d)):
            for n, p in getattr(model, side).named_parameters():
                mu[f"{side}.{n}"] = opt.state[p]["exp_avg"].clone()
                nu[f"{side}.{n}"] = opt.state[p]["exp_avg_sq"].clone()
        states.append(dict(state={k: v.clone() for k, v in model.state_dict().items()},
                           mu=mu, nu=nu))
    drained = solver.drain_metrics()
    assert [s for _, s in drained] == list(range(1, len(batches) + 1))
    return [m for m, _ in drained], states


STEP_CASES = {
    "intro_tc inception": dict(name="intro_tc", arch="inception"),
    "vae tc_full": dict(name="vae", kl_kind="tc_full", calls=1),
    "tc tc_full": dict(name="tc", kl_kind="tc_full", calls=1),
    "intro tc_full": dict(name="intro", kl_kind="tc_full", calls=1),
    "intro_tc remat pass": dict(name="intro_tc", remat_passes=True, calls=1),
    "tc remat block": dict(name="tc", remat=True, calls=1),
    "vae scan 2": dict(name="vae", scan=2, calls=1),
}


@pytest.fixture(scope="module", params=sorted(STEP_CASES))
def step_case(request):
    case = dict(STEP_CASES[request.param])
    init, batches, noises, metrics, states = _jax_steps(**case)
    case.pop("calls", None)
    name = case.pop("name")
    port_init = flax_to_port(*init, case.get("arch", "conv"), COS)
    got = _port_steps(name, port_init, batches, noises, **case)
    return _metric_names(name, case.get("kl_kind")), (metrics, states), got


def test_steps_match_jax(step_case):
    """Per step the metrics (the tc_decomp group with tc_full; each of a
    call's K steps, as the ring fans them out), per call the updated
    parameters, BatchNorm statistics and both Adam moments."""
    names, (want_m, want_s), (got_m, got_s) = step_case
    assert len(got_m) == len(want_m) and len(got_s) == len(want_s)
    for got, want in zip(got_m, want_m):
        for k in names:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    for got, want in zip(got_s, want_s):
        _assert_step_matches(dict(metrics={}, **want), dict(metrics={}, **got), ())


# ---------------------------------------------------------------------------
# remat and scan_steps against the port without them
# ---------------------------------------------------------------------------

_PLAIN_RUNS: dict = {}


def _run_port_plain(name, steps, scan=1, paired=True, **kw):
    """``steps`` float64 steps from one seeded init and generator (the step
    draws its own noise): metrics per step, the final state dict. Each
    case runs once per test process (the references the tests share)."""
    key = (name, steps, scan, paired, tuple(sorted(kw.items())))
    if key not in _PLAIN_RUNS:
        _PLAIN_RUNS[key] = _port_plain(name, steps, scan, paired, **kw)
    return _PLAIN_RUNS[key]


def _port_plain(name, steps, scan, paired, **kw):
    torch.manual_seed(11)
    solver, model = _port_solver(name, None, paired=paired, scan=scan, **kw)
    state = solver.init_state(5)
    batches = [_nchw(b) for b in _batches(steps)]
    for c in range(steps // scan):
        group = batches[c * scan:(c + 1) * scan]
        state, _ = solver.train_step(state, torch.stack(group) if scan > 1 else group[0])
    return [m for m, _ in solver.drain_metrics()], model.state_dict()


REMAT_CASES = {"intro_tc block": ("intro_tc", True, dict(remat=True)),
               "intro_tc pass": ("intro_tc", True, dict(remat_passes=True)),
               "intro_tc unpaired pass": ("intro_tc", False, dict(remat_passes=True)),
               "intro_tc inception block": ("intro_tc", True,
                                            dict(remat=True, arch="inception")),
               "tc block": ("tc", True, dict(remat=True))}


@pytest.mark.parametrize("label", sorted(REMAT_CASES))
def test_remat_equals_no_remat(label):
    """3 steps with recompute equal 3 without, bit for bit: metrics,
    parameters and BatchNorm running statistics, which a second update
    in the recompute would move."""
    name, paired, kw = REMAT_CASES[label]
    arch = {"arch": kw.pop("arch")} if "arch" in kw else {}
    want_m, want_sd = _run_port_plain(name, 3, paired=paired, **arch)
    got_m, got_sd = _run_port_plain(name, 3, paired=paired, **arch, **kw)
    assert got_m == want_m
    assert any(k.endswith("running_var") for k in want_sd)
    for k, v in want_sd.items():
        assert torch.equal(got_sd[k], v), k


@pytest.mark.parametrize("scan", [2, 4])
def test_scan_steps_equal_single_steps(scan):
    """One call of K steps (a [K, B, ...] batch) equals K calls of one."""
    want_m, want_sd = _run_port_plain("intro_tc", 4)
    got_m, got_sd = _run_port_plain("intro_tc", 4, scan=scan)
    assert got_m == want_m
    for k, v in want_sd.items():
        assert torch.equal(got_sd[k], v), k


ROUTED = dict(arch="conv", cdim=3, zdim=8, channels=(64,), image_size=32)


@pytest.mark.parametrize("remat", [False, "block", "pass"])
def test_remat_recomputes_each_routed_conv_once(monkeypatch, remat):
    """The conv kernels' forward calls in one paired intro_tc step with
    conv_impl 'pallas' (at channels (64,) every 3x3 conv routes: 2 in the
    encoder, 3 in the decoder): each routed conv's forward once per call
    (3 encoder and 4 decoder calls a step) and its input gradient once
    (every call is differentiated); with recompute, its forward once more
    in the backward, 'block' and 'pass' alike. ``chip_smoke.py`` phase 11
    holds the flagship's launches to the same count."""
    calls = {"fwd": 0, "dx": 0}
    real = conv_cuda.conv3x3_fwd

    def counted(x, w, rot=False):
        calls["dx" if rot else "fwd"] += 1
        return real(x, w, rot)

    monkeypatch.setattr(conv_cuda, "conv3x3_fwd", counted)
    enc = Encoder(**ROUTED, conv_impl="pallas", remat=remat == "block")
    dec = Decoder(**ROUTED, conv_impl="pallas", remat=remat == "block")
    solver = make_solver("intro_tc", dataset=Synthetic(image_size=32, cdim=3, sizes=(2, 2, 4, 4)),
                         encoder=enc, decoder=dec, batch_size=4,
                         optimizer_e=make_optimizer("adam", 2e-4),
                         optimizer_d=make_optimizer("adam", 2e-4), tc_impl="pallas",
                         remat_passes=remat == "pass", **HYPER)
    solver.train_step(solver.init_state(0), torch.rand(4, 3, 32, 32))
    per_step = 3 * 2 + 4 * 4  # calls x routed convs (encoder 2, decoder 4)
    assert calls == {"fwd": per_step * (2 if remat else 1), "dx": per_step}


def test_remat_pass_falls_back_to_block_for_single_phase_solvers(tmp_path, capsys):
    """remat 'pass' with the vae and tc solvers: JAX's message, and the
    models recompute per block (JAX train.py:70-77)."""
    from intro_tc_vae_tpu_torch.train import train_soft_intro_vae

    for solver in ("vae", "tc"):
        config = load_config(os.path.join(os.path.dirname(__file__), "..", "configs",
                                          "intro_tc_ukiyo64.json"),
                             dict(dataset="synthetic_small", solver=solver, remat="pass",
                                  num_epochs=1, batch_size=32, z_dim=8,
                                  use_tensorboard=False,
                                  checkpoint_dir=str(tmp_path / solver)))
        state = train_soft_intro_vae(config, device=CPU)
        assert state.model.encoder.remat and state.model.decoder.remat
        assert (f"remat='pass' has no pass structure in the '{solver}' solver; falling back "
                "to per-block rematerialization") in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the trainers with scan_steps and tc_full, TensorBoard on
# ---------------------------------------------------------------------------

SCAN_ARMS = {"scan 2 float32": (2, dict(transfer_dtype="float32")),
             "scan 4 cache": (4, dict(transfer_dtype="uint8", device_cache="force"))}
SCAN_RUN = dict(E2E, kl_kind="tc_full", num_epochs=2, test_iter=3, use_tensorboard=True)


def _trainer_run(module, train_mod, solver_cls, root, update, tmp, gather=None):
    """One trainer run with a spy on ``train_step`` (each call's first
    iteration and batch) and on the heavy metrics (the iterations they
    run at and their batch); the disentanglement scores are left out."""
    calls, heavy = [], []
    mp = pytest.MonkeyPatch()
    step, heavy_fn = solver_cls.train_step, solver_cls._write_heavy_metrics

    def spy_step(self, state, batch, *args):
        x = gather(batch) if gather else batch
        calls.append(np.asarray(x.float() if isinstance(x, torch.Tensor) else x))
        return step(self, state, batch, *args)

    def spy_heavy(self, state, batch, cur_iter):
        heavy.append(cur_iter)
        return heavy_fn(self, state, batch, cur_iter)

    try:
        mp.setattr(train_mod, "load_dataset", _dsprites_small_subset(module, root))
        mp.setattr(solver_cls, "train_step", spy_step)
        mp.setattr(solver_cls, "_write_heavy_metrics", spy_heavy)
        mp.setattr(solver_cls, "write_disentanglemnt_scores", lambda *a, **k: None)
        config = update(tmp)
        state = (train_mod.train_soft_intro_vae(config) if module is jdatasets
                 else train_mod.train_soft_intro_vae(config, device=CPU))
    finally:
        mp.undo()
    run, = [p for p in tmp.iterdir() if p.name.startswith("tb")]
    return state, calls, heavy, run


@pytest.fixture(scope="module", params=sorted(SCAN_ARMS))
def scan_runs(request, dsprites_root, tmp_path_factory):
    import intro_tc_vae_tpu.solvers.base as jbase
    import intro_tc_vae_tpu.train as T
    from intro_tc_vae_tpu.config import load_config as jload_config
    from intro_tc_vae_tpu.data.loader import CachedBatch, gather_cached
    from intro_tc_vae_tpu_torch import train
    from intro_tc_vae_tpu_torch.data import datasets
    from intro_tc_vae_tpu_torch.solvers.base import VAESolver
    from intro_tc_vae_tpu_torch.utils.writer import SingletonWriter

    k, arm = SCAN_ARMS[request.param]
    update = dict(SCAN_RUN, scan_steps=k, **arm)
    tmp = tmp_path_factory.mktemp(f"scan{k}")

    def port_config(d):
        return load_config(update_dict=dict(update, log_dir=str(d / "tb"),
                                            checkpoint_dir=str(d / "saves")))

    def jax_config(d):
        return jload_config(update_dict=dict(update, data_parallel=1, log_dir=str(d / "tb"),
                                             checkpoint_dir=str(d / "saves")))

    def jgather(b):
        return gather_cached(b, k) if isinstance(b, CachedBatch) else b

    try:
        port = _trainer_run(datasets, train, VAESolver, dsprites_root, port_config,
                            tmp / "port", lambda b: b.float().permute(0, 1, 3, 4, 2))
        jax_ = _trainer_run(jdatasets, T, jbase.VAESolver, dsprites_root, jax_config,
                            tmp / "jax", lambda b: jbase.u8_to_unit_f32(jgather(b))
                            if jgather(b).dtype == jnp.uint8 else jgather(b))
    finally:
        SingletonWriter().writer = None
    return k, port, jax_


def test_scan_trainer_matches_jax_trainer(scan_runs):
    """scan_steps K through both trainers (tc solver, kl_kind 'tc_full',
    the writer on, test_iter 3, 2 epochs of 4 steps): the same [K, B, ...]
    batches a call; every TensorBoard entry at the same steps, each step's
    scalars and the tc_decomp group at 0..7; the heavy metrics at the
    calls whose first iteration is a multiple of test_iter (JAX's gate:
    with K = 2 at 0 and 6, not 3; with K = 4 at 0 only); the step count
    and the final checkpoint."""
    k, (pstate, pcalls, pheavy, prun), (jstate, jcalls, jheavy, jrun) = scan_runs
    assert pstate.step == int(jstate.step) == 8
    assert [r["step"] for r in pstate.history] == list(range(1, 9))
    assert len(pcalls) == len(jcalls) == 8 // k
    for ours, theirs in zip(pcalls, jcalls):
        assert ours.shape == (k, 16, 8, 8, 1)
        np.testing.assert_array_equal(ours, theirs)
    assert pheavy == jheavy == [i for i in range(0, 8, k) if i % 3 == 0]
    got, want = _events(prun), _events(jrun)
    assert got == want
    for tag in ("mi", "tc", "kl"):
        assert got[(f"tc_decomp_{tag}", "scalars", "tc_decomp")] == list(range(8))
    assert all(np.isfinite(r[key]) for r in pstate.history for key in DECOMP)
    saves = sorted(os.listdir(prun.parent / "saves"))
    assert saves == sorted(os.listdir(jrun.parent / "saves"))


def test_tc_decomp_tags_read_back(scan_runs):
    """The port's tb_reader reads the tc_decomp group of the port's run,
    and its values are the history's."""
    from intro_tc_vae_tpu_torch.utils.tb_reader import TensorboardReader

    _, (pstate, _, _, prun), _ = scan_runs
    reader = TensorboardReader(str(prun.parent), prun.name)
    for tag, df in (("mi", reader.tc_decomp_mi), ("tc", reader.tc_decomp_tc),
                    ("kl", reader.tc_decomp_kl)):
        assert list(df["step"]) == list(range(8))
        np.testing.assert_allclose(
            list(df["value"]), [r[f"tc_decomp/{tag}"] for r in pstate.history], rtol=1e-6)


# ---------------------------------------------------------------------------
# data parallel: tc_full and weighted on 2 gloo ranks against one process
# ---------------------------------------------------------------------------

DP_CASES = {"intro_tc tc_full": ("intro_tc", True, dict(kl_kind="tc_full")),
            "tc weighted": ("tc", True, dict(tc_sampling="weighted"))}


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    batch = _batches(1)[0]
    gen = np.random.RandomState(7)
    noise = {k: gen.randn(B, SMALL["zdim"]).astype(np.float32)
             for k in ("prior", "real", "rec_e", "fake_e", "rec_d", "fake_d")}
    torch.manual_seed(0)
    init = SoftIntroVAE(Encoder(**dict(SMALL, arch="conv")),
                        Decoder(**dict(SMALL, arch="conv"))).double().state_dict()
    cases = {label: (name, paired, noise, dict(HYPER, **kw))
             for label, (name, paired, kw) in DP_CASES.items()}
    with pytest.MonkeyPatch.context() as mp:  # solver_steps counts the TC routes
        from intro_tc_vae_tpu_torch.ops import tc
        for fn in ("tc_logsumexp_cuda", "tc_logsumexp_cuda_gathered"):
            mp.setattr(tc, fn, getattr(tc, fn))
        one = workers.solver_steps(cases, init, batch)
    ranks = workers.run_ranks(workers.solver_steps, 2, (cases, init, batch),
                              tmp_path_factory.mktemp("dp"))
    return one, ranks


@pytest.mark.parametrize("label", sorted(DP_CASES))
def test_dp_tc_full_and_weighted_equal_one_process(dp_runs, label):
    """One float64 step on 2 ranks, each with its rows of the batch,
    against one process on the whole batch: the metrics (tc_decomp
    included) and the updated state, the same on both ranks, at
    tests/test_torch_parallel.py's tolerance for the data-parallel step
    (the models' fp32 heads round the sums of two orders apart)."""
    one, ranks = dp_runs
    want = one[label]
    assert ranks[0][label]["digest"] == ranks[1][label]["digest"]
    assert set(ranks[0][label]["metrics"]) == set(want["metrics"])
    for out in ranks:
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(out[label]["metrics"][k], v, err_msg=k, **TOL)
    for k, v in want["state"].items():
        np.testing.assert_allclose(ranks[0][label]["state"][k].numpy(), v.numpy(),
                                   err_msg=k, **TOL)
