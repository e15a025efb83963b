"""PyTorch port: checkpoints (``utils/checkpoint.py``) and resume.

* Round trip: save, then load into a fresh state built from other
  weights. Parameters, BatchNorm statistics, every optimizer's state and
  the step come back bit-equal, for each of the eight optimizers, with a
  synchronous and a background save.
* ``find_latest_checkpoint``: the cases of the JAX package's
  tests/test_utils.py:111-127, and a half-written file is never picked.
* Resume equals an uninterrupted run, bit for bit, in float64: N steps,
  save, load into a fresh model, M steps, against N + M steps in one run
  on the same batches and noise. ``resume: "auto"`` through the trainer
  continues the step count.
* Port against JAX: a port checkpoint carried into the JAX model
  (parameters and BatchNorm statistics through
  ``torch_state_dict_to_flax``, the Adam moments through the same layout
  map: ``exp_avg`` -> ``mu``, ``exp_avg_sq`` -> ``nu``, ``step`` ->
  ``count``) gives JAX's eval-mode ``encode`` and ``decode`` the port's
  outputs, and one more JAX step the port's resumed step, float64, on the
  same batch and noise.

Tolerances of the port-against-JAX comparisons: both packages run in
float64 but keep the models' float32 casts of mu/logvar and of the
pre-sigmoid output, so eval outputs agree to rtol 1e-6 / atol 1e-7 (one
float32 rounding; measured: mu and logvar equal, images at most 6e-8
apart) and a step to tests/test_torch_step.py's rtol 1e-4 / atol 1e-5
(that file says why; measured: metrics within 2e-7 relative).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intro_tc_vae_tpu.solvers.base import decode as jdecode
from intro_tc_vae_tpu.solvers.base import encode as jencode
from intro_tc_vae_tpu.solvers.intro import build_intro_step as jbuild_intro_step
from intro_tc_vae_tpu.utils.transplant import torch_state_dict_to_flax
from intro_tc_vae_tpu_torch.config import load_config
from intro_tc_vae_tpu_torch.solvers import NOISE_KEYS
from intro_tc_vae_tpu_torch.solvers.base import decode, encode
from intro_tc_vae_tpu_torch.train import train_soft_intro_vae
from intro_tc_vae_tpu_torch.utils import (
    find_latest_checkpoint,
    finalize_checkpoints,
    load_checkpoint,
    load_model,
    save_checkpoint,
)
from tests._torch_threads import one_thread  # noqa: F401  (autouse)
from tests.test_torch_step import (
    B,
    COS,
    METRICS,
    SMALL,
    TOL,
    _batches,
    _jax_noise,
    _port_solver,
)

CPU = torch.device("cpu")
OPTIMIZERS = ("adam", "adamw", "adagrad", "adadelta", "sgd", "rmsprop", "lamb", "lion")
EVAL_TOL = dict(rtol=1e-6, atol=1e-7)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "configs", "intro_tc_ukiyo64.json")


def _solver(optimizer="adam", dtype=torch.float32, seed=0, name="intro_tc"):
    """The small port model (seeded init) with ``optimizer`` for both nets."""
    from intro_tc_vae_tpu_torch.data import Synthetic
    from intro_tc_vae_tpu_torch.models import Decoder, Encoder, SoftIntroVAE
    from intro_tc_vae_tpu_torch.solvers import make_optimizer, make_solver

    torch.manual_seed(seed)
    enc = Encoder(**SMALL, compute_dtype=dtype)
    dec = Decoder(**SMALL, compute_dtype=dtype)
    SoftIntroVAE(enc, dec).to(dtype)
    solver = make_solver(
        name, dataset=Synthetic(image_size=32, cdim=3, sizes=(2, 2, 4, 4)),
        encoder=enc, decoder=dec, batch_size=B,
        optimizer_e=make_optimizer(optimizer, 2e-4),
        optimizer_d=make_optimizer(optimizer, 2e-4), tc_impl="pallas",
        beta_kl=0.5, beta_rec=0.75, beta_neg=512.0)
    return solver, solver.init_state(seed)


def _inputs(n: int, dtype=torch.float32, seed: int = 7):
    """n batches (NCHW) of the synthetic set and n draws of the step's noise."""
    from intro_tc_vae_tpu_torch.data import Synthetic

    ds = Synthetic(image_size=32, cdim=3, sizes=(2, 2, 4, 4))
    rng = np.random.default_rng(seed)
    batches = [torch.from_numpy(ds.get_batch(rng.permutation(len(ds))[:B])
                                .transpose(0, 3, 1, 2).copy()).to(dtype) for _ in range(n)]
    noises = [{k: torch.from_numpy(rng.standard_normal((B, SMALL["zdim"]))).to(dtype)
               for k in NOISE_KEYS} for _ in range(n)]
    return batches, noises


def assert_same(a, b, where="state"):
    """Equal values, dtypes and structure, tensors bit for bit."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def assert_states_equal(a, b):
    assert a.step == b.step
    assert_same(a.model.state_dict(), b.model.state_dict(), "model")
    assert_same(a.opt_e.state_dict(), b.opt_e.state_dict(), "opt_e")
    assert_same(a.opt_d.state_dict(), b.opt_d.state_dict(), "opt_d")


# ---------------------------------------------------------------------------
# round trip, names
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_round_trip_is_bit_equal(tmp_path, optimizer, async_save):
    solver, state = _solver(optimizer)
    batches, noises = _inputs(2)
    for x, noise in zip(batches, noises):
        solver.train_step(state, x, noise)
    # every optimizer but plain sgd holds state by now
    assert (optimizer == "sgd") == (not state.opt_e.state) == (not state.opt_d.state)
    path = save_checkpoint(state, epoch=3, iteration=17, prefix="t_",
                           checkpoint_dir=str(tmp_path), async_save=async_save)
    assert path == str(tmp_path / "t_model_epoch_3_iter_17")
    # the loop goes on updating in place: the save holds the state it was given
    saved = {k: v.clone() for k, v in state.model.state_dict().items()}
    solver.train_step(state, batches[0], noises[0])
    finalize_checkpoints()
    assert os.listdir(tmp_path) == ["t_model_epoch_3_iter_17"]

    _, fresh = _solver(optimizer, seed=1)
    assert not torch.equal(fresh.model.encoder.fc.weight, state.model.encoder.fc.weight)
    restored, epoch = load_checkpoint(path, fresh)
    assert restored is fresh and epoch == 3 and restored.step == 2
    assert_same(saved, restored.model.state_dict(), "model")

    # the optimizer states and step: a second run of the same two steps
    solver_b, state_b = _solver(optimizer)
    for x, noise in zip(batches, noises):
        solver_b.train_step(state_b, x, noise)
    assert_states_equal(state_b, restored)


def test_load_waits_for_the_save_in_flight(tmp_path):
    solver, state = _solver()
    batches, noises = _inputs(1)
    solver.train_step(state, batches[0], noises[0])
    path = save_checkpoint(state, 0, 1, checkpoint_dir=str(tmp_path), async_save=True)
    _, fresh = _solver(seed=1)
    load_checkpoint(path, fresh)  # no finalize first
    assert_states_equal(state, fresh)


def test_load_model_restores_parameters_and_statistics_only(tmp_path):
    solver, state = _solver()
    batches, noises = _inputs(1)
    solver.train_step(state, batches[0], noises[0])
    path = save_checkpoint(state, 0, 1, checkpoint_dir=str(tmp_path))
    _, fresh = _solver(seed=1)
    assert load_model(fresh, path) is fresh
    assert_same(state.model.state_dict(), fresh.model.state_dict(), "model")
    assert fresh.step == 0 and not fresh.opt_e.state and not fresh.opt_d.state
    model = _solver(seed=2)[1].model
    load_model(model, path)  # a bare SoftIntroVAE too
    assert_same(state.model.state_dict(), model.state_dict(), "model")


def test_find_latest_checkpoint(tmp_path):
    """JAX tests/test_utils.py:111-127, on the port's files."""
    _, state = _solver()
    for epoch, it, prefix in ((1, 10, "run_"), (5, 50, "run_"), (2, 99, "other_")):
        save_checkpoint(state, epoch, it, prefix, checkpoint_dir=str(tmp_path))
    assert find_latest_checkpoint(str(tmp_path), "run_").endswith("run_model_epoch_5_iter_50")
    assert find_latest_checkpoint(str(tmp_path), "nope_") is None
    assert find_latest_checkpoint(str(tmp_path / "missing")) is None
    # epoch outranks iter: a later epoch with a smaller iter (the post-resume
    # situation) wins over a stale pre-crash checkpoint
    save_checkpoint(state, 6, 10, "run_", checkpoint_dir=str(tmp_path))
    assert find_latest_checkpoint(str(tmp_path), "run_").endswith("run_model_epoch_6_iter_10")
    # a write cut short leaves its temporary name, which never ranks
    (tmp_path / "run_model_epoch_9_iter_90.tmp123").write_bytes(b"partial")
    assert find_latest_checkpoint(str(tmp_path), "run_").endswith("run_model_epoch_6_iter_10")


# ---------------------------------------------------------------------------
# resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,optimizer", [("intro_tc", "adam"), ("vae", "lion")])
def test_resume_equals_an_uninterrupted_run_float64(tmp_path, name, optimizer):
    """3 steps, save, load into a fresh model (other initial weights), 2
    steps, against 5 steps in one run: bit-equal parameters, statistics,
    optimizer states and step."""
    batches, noises = _inputs(5, torch.float64)
    solver_a, whole = _solver(optimizer, torch.float64, name=name)
    for x, noise in zip(batches, noises):
        solver_a.train_step(whole, x, noise)

    solver_b, first = _solver(optimizer, torch.float64, name=name)
    for x, noise in zip(batches[:3], noises[:3]):
        solver_b.train_step(first, x, noise)
    path = save_checkpoint(first, 0, first.step, checkpoint_dir=str(tmp_path))
    solver_c, resumed = _solver(optimizer, torch.float64, seed=3, name=name)
    load_checkpoint(path, resumed)
    for x, noise in zip(batches[3:], noises[3:]):
        solver_c.train_step(resumed, x, noise)
    assert whole.step == resumed.step == 5
    assert_states_equal(whole, resumed)


def test_resume_auto_continues_the_step_count(tmp_path):
    """resume: "auto" through the trainer: the newest checkpoint of the
    run's prefix is restored, the step count goes on from it, and the run's
    own final checkpoint is named with the total (JAX train.py:224-240).
    The final checkpoint names the epoch it ends, so the resumed run starts
    that epoch again (JAX semantics)."""
    update = dict(dataset="synthetic_small", tc_impl="pallas", num_epochs=1,
                  use_tensorboard=False, batch_size=8, z_dim=8,
                  checkpoint_dir=str(tmp_path))
    first = train_soft_intro_vae(load_config(FLAGSHIP, update), device=CPU)
    config = load_config(FLAGSHIP, {**update, "num_epochs": 2, "resume": "auto"})
    prefix = config.fingerprint()
    assert find_latest_checkpoint(str(tmp_path), prefix).endswith("epoch_0_iter_8")
    second = train_soft_intro_vae(config, device=CPU)
    assert first.step == 8 and second.step == 24
    assert [r["step"] for r in second.history] == list(range(9, 25))
    assert [r["epoch"] for r in second.history] == [0] * 8 + [1] * 8
    assert find_latest_checkpoint(str(tmp_path), prefix).endswith(
        f"{prefix}model_epoch_1_iter_24")
    assert sorted(os.listdir(tmp_path)) == [f"{prefix}model_epoch_0_iter_8",
                                            f"{prefix}model_epoch_1_iter_24"]


# ---------------------------------------------------------------------------
# a port checkpoint in the JAX package
# ---------------------------------------------------------------------------

def _carry_to_jax(payload: dict, model) -> tuple:
    """(params, batch_stats, {side: (count, mu, nu)}) of a port payload in
    the JAX package's layout."""
    sd = {f"{side}.{k}": v for side in ("encoder", "decoder") for k, v in payload[side].items()}
    params, stats = torch_state_dict_to_flax(sd, "conv", COS)
    adam = {}
    for side, opt in (("encoder", "opt_e"), ("decoder", "opt_d")):
        names = [f"{side}.{n}" for n, _ in getattr(model, side).named_parameters()]
        state = payload[opt]["state"]
        counts = {int(s["step"]) for s in state.values()}
        assert len(counts) == 1
        moments = {}
        for field in ("exp_avg", "exp_avg_sq"):
            m = {names[i]: s[field] for i, s in state.items()}
            # the running statistics have no moments: zeros fill their slots
            full = {k: m.get(k, torch.zeros_like(v)) for k, v in sd.items()}
            moments[field] = torch_state_dict_to_flax(full, "conv", COS)[0][side]
        adam[side] = (counts.pop(), moments["exp_avg"], moments["exp_avg_sq"])
    return params, stats, adam


def test_carried_checkpoint_matches_jax_eval_and_next_step(tmp_path):
    from intro_tc_vae_tpu.data import Synthetic as JSynthetic
    from intro_tc_vae_tpu.models import Decoder as JDecoder
    from intro_tc_vae_tpu.models import Encoder as JEncoder
    from intro_tc_vae_tpu.solvers import make_optimizer as jmake_optimizer
    from intro_tc_vae_tpu.solvers import make_solver as jmake_solver

    # one port step, float64, then the checkpoint
    batches = [b.astype(np.float64) for b in _batches()]
    solver, model = _port_solver(True, None, torch.float64)
    state = solver.init_state(0)
    _, noises = _inputs(1, torch.float64)
    solver.train_step(state, torch.from_numpy(batches[0].transpose(0, 3, 1, 2).copy()),
                      noises[0])
    path = save_checkpoint(state, 0, 1, checkpoint_dir=str(tmp_path))
    params, stats, adam = _carry_to_jax(load_checkpoint(path), model)

    jsolver = jmake_solver(
        "intro_tc", dataset=JSynthetic(image_size=32, cdim=3, sizes=(2, 2, 4, 4)),
        encoder=JEncoder(**SMALL), decoder=JDecoder(**SMALL), batch_size=B,
        optimizer_e=jmake_optimizer("adam", 2e-4), optimizer_d=jmake_optimizer("adam", 2e-4),
        tc_impl="xla", recon_loss_type="mse", beta_kl=0.5, beta_rec=0.75, beta_neg=512.0,
        gamma_r=1e-8)
    jstate = jsolver.init_state(jax.random.key(0), jnp.asarray(batches[0], jnp.float32))
    x1 = batches[1]
    z = np.random.default_rng(1).standard_normal((B, SMALL["zdim"]))
    with jax.enable_x64(True):
        p64, s64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), (params, stats))

        def opt_state(tx, side):
            count, mu, nu = adam[side]
            fresh = tx.init(p64[side])
            carried = fresh[0]._replace(
                count=jnp.asarray(count, jnp.int32),
                mu=jax.tree_util.tree_map(jnp.asarray, mu),
                nu=jax.tree_util.tree_map(jnp.asarray, nu))
            return (carried,) + tuple(fresh[1:])

        jstate = jstate.replace(step=jnp.asarray(1, jnp.int32), params=p64, batch_stats=s64,
                                opt_state_e=opt_state(jsolver.optimizer_e, "encoder"),
                                opt_state_d=opt_state(jsolver.optimizer_d, "decoder"))
        jmu, jlogvar, _ = jencode(jsolver.encoder, p64["encoder"], s64["encoder"],
                                  jnp.asarray(x1), train=False)
        jimg, _ = jdecode(jsolver.decoder, p64["decoder"], s64["decoder"], jnp.asarray(z),
                          train=False)
        step = jax.jit(jbuild_intro_step(jsolver.hyper, jsolver.encoder, jsolver.decoder,
                                         jsolver.optimizer_e, jsolver.optimizer_d,
                                         paired=True))
        jnoise = _jax_noise(jstate.rng)
        jstate, jmetrics = step(jstate, jnp.asarray(x1))
        jmetrics = {k: float(jmetrics[k]) for k in METRICS}
        jafter = jax.tree_util.tree_map(np.asarray, (jstate.params, jstate.batch_stats))

    # the port, restored into a fresh model (other initial weights)
    solver_r, model_r = _port_solver(True, None, torch.float64)
    with torch.no_grad():
        for p in model_r.parameters():
            p.add_(1.0)
    restored, _ = load_checkpoint(path, solver_r.init_state(0))
    xt = torch.from_numpy(x1.transpose(0, 3, 1, 2).copy())
    mu, logvar = encode(model_r.encoder, xt, train=False)
    img = decode(model_r.decoder, torch.from_numpy(z), train=False)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), **EVAL_TOL)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(jlogvar), **EVAL_TOL)
    np.testing.assert_allclose(img.numpy().transpose(0, 2, 3, 1), np.asarray(jimg), **EVAL_TOL)

    _, metrics = solver_r.train_step(restored, xt,
                                     {k: torch.tensor(v) for k, v in jnoise.items()})
    assert restored.step == 2 and int(jstate.step) == 2
    for name in METRICS:
        np.testing.assert_allclose(float(metrics[name]), jmetrics[name], err_msg=name, **TOL)
    want = torch_state_dict_to_flax(model_r.state_dict(), "conv", COS)
    for got_tree, want_tree in zip(want, jafter):
        got_leaves = jax.tree_util.tree_leaves(got_tree)
        want_leaves = jax.tree_util.tree_leaves(want_tree)
        assert len(got_leaves) == len(want_leaves) > 0
        for g, w in zip(got_leaves, want_leaves):
            np.testing.assert_allclose(g, w, **TOL)


def test_save_losses_writes_the_reference_pickle(tmp_path):
    import pickle

    from intro_tc_vae_tpu_torch.utils import save_losses

    save_losses(str(tmp_path), [1.0], [2.0], [3.0], [4.0, 5.0])
    with open(tmp_path / "soft_intro_train_graphs_data.pickle", "rb") as f:
        assert pickle.load(f) == {"kl_real": [1.0], "kl_fake": [2.0], "kl_rec": [3.0],
                                  "rec_err": [4.0, 5.0]}
