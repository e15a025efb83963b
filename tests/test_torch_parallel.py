"""PyTorch port, data parallel: R ranks against one process and against the
JAX package's sharded path.

The ranks are processes started with ``torch.multiprocessing`` (spawn)
that join a ``gloo`` group on the CPU through the port's own start-up;
their code is ``tests/_torch_dp_workers.py``, which imports no jax. Every
start of ranks has a hard timeout (120 s), so a rank stuck in a collective
fails the test instead of stalling the suite.

Cases:
(i)   the global-batch TC of the port (``total_correlation(mesh=...)``,
      impls 'xla', 'blockwise' and 'pallas', the last through the gathered
      kernels' plain version on the CPU) on 2 and 4 ranks against
      ``intro_tc_vae_tpu.ops.total_correlation_sharded`` on an 8-device mesh,
      impl 'pallas' (interpret mode) and 'blockwise': value, per-sample
      vector and the gradients of z, mu and logvar, at
      tests/test_tc_impls.py's tolerances, floor and clamp active;
(iii) the collectives, ``replicate_state`` and ``GroupedBatchNorm``
      (groups 1 and 2) on 2 ranks against one process on the whole batch;
(iv)  one intro_tc step (paired and unpaired) and one tc-solver step on 2
      ranks against the JAX step on ``make_mesh(2)``, same weights
      (``flax_to_port``), global batch and noise;
(v)   ``train_soft_intro_vae`` with ``data_parallel: 2`` (its final
      checkpoint under the test's temporary directory);
(vi)  the mesh-size checks;
(vii) checkpoints on 2 ranks: rank 0 writes, both ranks load equal
      state, and the resumed two-rank step equals the one-process step.
(ii), the row-block importance weights, is in tests/test_torch_ops.py.

(iv) runs both packages in float64, as tests/test_torch_step.py does, at
its tolerances (rtol 1e-4 / atol 1e-5). The JAX sharded step with
tc_impl 'pallas' cannot run in float64 on the CPU mesh (its interpret-mode
shard_map step stalls in a collective rendezvous under x64 and aborts), so
the JAX side runs the sharded path's other impl, 'blockwise' (the same
all-gather and global-row weights, ``intro_tc_vae_tpu/ops/tc.py:221-280``);
(i) and tests/test_torch_ops.py hold the port's gathered route to the
Pallas kernel itself.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intro_tc_vae_tpu import ops as jops
from intro_tc_vae_tpu.parallel import batch_sharding as jbatch_sharding
from intro_tc_vae_tpu.parallel import make_mesh as jmake_mesh
from intro_tc_vae_tpu.parallel import shard_state
from intro_tc_vae_tpu.solvers import make_optimizer as jmake_optimizer
from intro_tc_vae_tpu.solvers import make_solver as jmake_solver
from intro_tc_vae_tpu.data import Synthetic as JSynthetic
from intro_tc_vae_tpu.models import Decoder as JDecoder
from intro_tc_vae_tpu.models import Encoder as JEncoder
from intro_tc_vae_tpu_torch.config import load_config
from intro_tc_vae_tpu_torch.models import conv_output_size
from intro_tc_vae_tpu_torch.models.blocks import GroupedBatchNorm
from intro_tc_vae_tpu_torch.parallel import backend_for, local_batch_slice, make_mesh
from intro_tc_vae_tpu_torch.parallel.distributed import row_block
from intro_tc_vae_tpu_torch.train import train_soft_intro_vae
from intro_tc_vae_tpu_torch.utils import flax_to_port
from tests import _torch_dp_workers as workers
from tests._torch_threads import one_thread  # noqa: F401  (autouse)
from tests.test_torch_ops import _floor_and_clamp_active, _tc_inputs, assert_close_scaled

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "configs", "intro_tc_ukiyo64.json")
CPU = torch.device("cpu")
N = 5000


# ---------------------------------------------------------------------------
# (i) the global-batch TC
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tc_case():
    """B=32, Z=16, N=5000 inputs (floor and clamp active) and the JAX
    sharded estimator on make_mesh(8) for impl 'pallas' (interpret mode)
    and 'blockwise': value, gradients, per-sample vector."""
    from jax.experimental.pallas import tpu as pltpu

    z, mu, logvar = _tc_inputs(np.random.RandomState(0), 32, 16)
    assert _floor_and_clamp_active(z, mu, logvar)
    mesh = jmake_mesh(8)
    ref = {}
    with pltpu.force_tpu_interpret_mode():
        for impl in ("pallas", "blockwise"):
            def tc(*a, reduce="mean"):
                return jops.total_correlation_sharded(*a, N, mesh, impl=impl, reduce=reduce)

            ref[impl] = dict(tc=float(tc(z, mu, logvar)),
                             grads=[np.asarray(g) for g in
                                    jax.grad(tc, argnums=(0, 1, 2))(z, mu, logvar)],
                             per=np.asarray(tc(z, mu, logvar, reduce="none")))
    return (z, mu, logvar), ref


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def tc_ranks(request, tc_case, tmp_path_factory):
    return workers.run_ranks(workers.tc_sharded, request.param, (*tc_case[0], N),
                             tmp_path_factory.mktemp("tc"))


@pytest.mark.parametrize("jax_impl", ["pallas", "blockwise"])
@pytest.mark.parametrize("impl", ["xla", "blockwise", "pallas"])
def test_total_correlation_sharded_matches_jax(tc_case, tc_ranks, impl, jax_impl):
    """Every rank holds the same global scalar; the ranks' per-sample
    vectors and gradient rows, concatenated in rank order, are the JAX
    sharded estimator's: rtol 1e-5 / atol 1e-5 for the value and 1e-5 /
    1e-4 per sample, as tests/test_tc_impls.py; the gradients at its rtol
    1e-4 with atol 1e-5 of the largest entry (``assert_close_scaled``):
    with the floor active, terms of ~1e3 cancel in float32 sums, and
    JAX's own 'pallas' and 'xla' gradients differ by 3.0e-4 on entries of
    at most 46 here."""
    want = tc_case[1][jax_impl]
    for rank in tc_ranks:
        np.testing.assert_allclose(rank[impl]["tc"], want["tc"], rtol=1e-5, atol=1e-5)
    per = np.concatenate([rank[impl]["per"] for rank in tc_ranks])
    np.testing.assert_allclose(per, want["per"], rtol=1e-5, atol=1e-4)
    for k in range(3):  # z, mu, logvar
        got = np.concatenate([rank[impl]["grads"][k] for rank in tc_ranks])
        assert_close_scaled(got, want["grads"][k])


def test_pallas_impl_takes_the_gathered_route(tc_ranks):
    """impl 'pallas' under a data group goes through
    tc_logsumexp_cuda_gathered (two calls per rank: 'mean' and 'none'),
    never through the single-device wrapper."""
    for rank in tc_ranks:
        assert rank["routes"] == {"gathered": 2, "single": 0}


# ---------------------------------------------------------------------------
# (iii) collectives, replicate_state, GroupedBatchNorm
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bn_case(tmp_path_factory):
    """x [G=2, R*b=8, C=3, 4, 4] float64: global group g is x[g]; rank r
    holds rows r*4..r*4+3 of each group."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 3, 4, 4) * 2.0 + 0.5
    weight, bias = rng.randn(2, 3)
    cot = rng.randn(*x.shape)
    args = (x, weight, bias, cot)
    return args, workers.run_ranks(workers.collectives_and_bn, 2, args,
                                   tmp_path_factory.mktemp("bn"))


def test_collectives_forward_and_backward(bn_case):
    """Rank r holds a_r = [r, r + 0.5] and takes the loss (r + 1) * (sum of
    the gathered bank + sum of the all-reduced a^2): the bank and the sum
    are the same on both ranks, and each rank's gradient is that of the
    sum of both ranks' losses, 3 * (1 + 2 a_r)."""
    _, ranks = bn_case
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["bank"].numpy(), [[0.0], [0.5], [1.0], [1.5]])
        np.testing.assert_array_equal(out["sum"].numpy(), [[1.0], [2.5]])
        a = np.array([[r + 0.0], [r + 0.5]])
        np.testing.assert_allclose(out["grad"].numpy(), 3.0 * (1.0 + 2.0 * a), rtol=1e-15)


def test_replicate_state_makes_ranks_bit_equal(bn_case):
    _, ranks = bn_case
    assert not ranks[0]["agree_before"] and not ranks[1]["agree_before"]
    assert ranks[0]["digest"] == ranks[1]["digest"]
    assert ranks[0]["jax_loaded"] == ranks[1]["jax_loaded"] == []


@pytest.mark.parametrize("groups", [1, 2])
def test_grouped_batchnorm_ranks_equal_one_process(bn_case, groups):
    """Output, input gradient (each rank's rows), weight and bias
    gradients (summed over the ranks) and the running statistics (on
    every rank) against one process on the whole batch, float64."""
    (x, weight, bias, cot), ranks = bn_case
    c, spatial = x.shape[2], x.shape[3:]
    bn = GroupedBatchNorm(c, compute_dtype=torch.float64).double()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    xs = torch.tensor(x[:groups].reshape(-1, c, *spatial), requires_grad=True)
    y = bn(xs, groups=groups)
    dx, dw, db = torch.autograd.grad(
        (y * torch.from_numpy(cot[:groups].reshape(-1, c, *spatial))).sum(),
        (xs, bn.weight, bn.bias))

    def whole(key):  # ranks' [G*b, ...] rows back to the global [G*R*b, ...] order
        parts = [out[f"bn{groups}"][key].reshape(groups, -1, c, *spatial) for out in ranks]
        return torch.cat(parts, dim=1).reshape(-1, c, *spatial).numpy()

    tol = dict(rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(whole("y"), y.detach().numpy(), **tol)
    np.testing.assert_allclose(whole("dx"), dx.numpy(), **tol)
    for key, ref in (("dw", dw), ("db", db)):
        got = sum(out[f"bn{groups}"][key] for out in ranks)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **tol)
    for out in ranks:
        for key in ("running_mean", "running_var"):
            np.testing.assert_allclose(out[f"bn{groups}"][key].numpy(),
                                       getattr(bn, key).numpy(), **tol)


# ---------------------------------------------------------------------------
# (iv) one solver step on 2 ranks against the JAX step on make_mesh(2)
# ---------------------------------------------------------------------------

SMALL = workers.SMALL
COS = conv_output_size(32, (16, 32))
B = 8
HYPER = dict(recon_loss_type="mse", beta_kl=0.5, beta_rec=0.75, beta_neg=512.0,
             gamma_r=1e-8)
NOISE_KEYS = ("prior", "real", "rec_e", "fake_e", "rec_d", "fake_d")
INTRO_METRICS = ("lossE", "lossD", "loss_kl", "loss_rec", "kl_loss_unscaled",
                 "r_loss_unscaled", "expelbo_r", "expelbo_f", "diff_kl", "fc_grad_norm")
ELBO_METRICS = ("loss_enc", "loss_dec", "loss_kl", "loss_rec", "kl_loss_unscaled",
                "r_loss_unscaled", "fc_grad_norm", "total_norm", "L2")
CASES = {"intro_tc paired": ("intro_tc", True), "intro_tc unpaired": ("intro_tc", False),
         "tc": ("tc", True)}
STEP_TOL = dict(rtol=1e-4, atol=1e-5)


def _hyper(name):
    """The tc solver with the global-norm clip, as configs/tc_dsprites.json."""
    return dict(HYPER, clip=0.5) if name == "tc" else HYPER


def _jax_dp_step(name, paired, batch):
    """One float64 step of the JAX solver on make_mesh(2), tc_impl
    'blockwise'; returns (float64 initial weights as port state dict,
    the global noise the step drew, metrics, port state dict after)."""
    mesh = jmake_mesh(2)
    solver = jmake_solver(
        name, dataset=JSynthetic(image_size=32, cdim=3, sizes=(2, 2, 4, 4)),
        encoder=JEncoder(**SMALL), decoder=JDecoder(**SMALL), batch_size=B,
        optimizer_e=jmake_optimizer("adam", 2e-4), optimizer_d=jmake_optimizer("adam", 2e-4),
        tc_impl="blockwise", mesh=mesh, fuse_passes=paired, **_hyper(name))
    state = solver.init_state(jax.random.key(0), jnp.asarray(batch, jnp.float32))
    init = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                  (state.params, state.batch_stats))
    with jax.enable_x64(True):
        params, stats = jax.tree_util.tree_map(jnp.asarray, init)
        state = shard_state(state.replace(
            params=params, batch_stats=stats,
            opt_state_e=solver.optimizer_e.init(params["encoder"]),
            opt_state_d=solver.optimizer_d.init(params["decoder"])), mesh)
        if name == "tc":  # the ELBO step's one draw (solvers/vae.py:31)
            noise = {"real": np.asarray(jax.random.normal(
                jax.random.split(state.rng)[1], (B, SMALL["zdim"]), dtype=jnp.float32))}
        else:  # the intro step's 7-way split (solvers/intro.py:81-85)
            keys = jax.random.split(state.rng, 7)
            noise = {k: np.asarray(jax.random.normal(
                keys[i + 1], (B, SMALL["zdim"]),
                **({} if k == "prior" else {"dtype": jnp.float32})))
                for i, k in enumerate(NOISE_KEYS)}
        x = jax.device_put(jnp.asarray(batch), jbatch_sharding(mesh))
        state, metrics = solver._step_fn(state, x)
        names = ELBO_METRICS if name == "tc" else INTRO_METRICS
        return (flax_to_port(*init, "conv", COS), noise,
                {k: float(metrics[k]) for k in names},
                flax_to_port(state.params, state.batch_stats, "conv", COS))


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    ds = JSynthetic(image_size=32, cdim=3, sizes=(2, 2, 4, 4))
    batch = ds.get_batch(np.arange(B)).astype(np.float64)
    jax_out, cases, init = {}, {}, None
    for label, (name, paired) in CASES.items():
        init, noise, metrics, after = _jax_dp_step(name, paired, batch)
        jax_out[label] = (metrics, after)
        cases[label] = (name, paired, noise, _hyper(name))
    ranks = workers.run_ranks(workers.solver_steps, 2, (cases, init, batch),
                              tmp_path_factory.mktemp("steps"))
    return jax_out, ranks


@pytest.mark.parametrize("label", list(CASES))
def test_dp_step_matches_jax_sharded_step(step_runs, label):
    """Metrics (the same on both ranks), updated parameters and BatchNorm
    running statistics (bit-equal on both ranks) against the JAX step on
    make_mesh(2), float64 in both packages."""
    jax_out, ranks = step_runs
    want_metrics, want_state = jax_out[label]
    assert ranks[0][label]["digest"] == ranks[1][label]["digest"]
    for out in ranks:
        for name, ref in want_metrics.items():
            np.testing.assert_allclose(out[label]["metrics"][name], ref, err_msg=name,
                                       **STEP_TOL)
    got = ranks[0][label]["state"]
    assert set(got) >= set(want_state)
    for key, ref in want_state.items():
        np.testing.assert_allclose(got[key].numpy(), ref.numpy(), err_msg=key, **STEP_TOL)


@pytest.mark.parametrize("label,calls", [("intro_tc paired", 5), ("intro_tc unpaired", 5),
                                         ("tc", 1)])
def test_dp_step_tc_calls_take_the_gathered_route(step_runs, label, calls):
    """tc_impl 'pallas' under the data group: every TC call of the step
    (intro: 3 in phase E, 2 in phase D; tc: 1) is a gathered one."""
    for out in step_runs[1]:
        assert out[label]["routes"] == {"gathered": calls, "single": 0}


# ---------------------------------------------------------------------------
# (v) the trainer on 2 ranks, (vi) the mesh-size checks
# ---------------------------------------------------------------------------

SMALL_RUN = dict(dataset="synthetic_small", tc_impl="pallas", num_epochs=1,
                 use_tensorboard=False, z_dim=8)
BAD_UPDATES = [{"data_parallel": 4}, {"batch_size": 9},
               {"model_parallel": 2, "data_parallel": 3}]


@pytest.fixture(scope="module")
def train_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("train")
    update = {**SMALL_RUN, "batch_size": 32, "data_parallel": 2,
              "checkpoint_dir": str(out / "saves")}
    return workers.run_ranks(workers.train_cli_config, 2,
                             (FLAGSHIP, update, BAD_UPDATES), out), out


def test_train_data_parallel_on_cpu(train_ranks):
    """The flagship recipe at the synthetic_small size, data_parallel 2,
    global batch 32: one epoch of 64 images is 2 steps on each rank, every
    loss finite and equal on both ranks (the metrics are averaged), 5
    gathered TC calls a step, and bit-equal parameters and BatchNorm
    statistics on both ranks afterwards; one final checkpoint, which holds
    them."""
    (a, b), root = train_ranks
    for out in (a, b):
        assert [r["step"] for r in out["history"]] == [1, 2]
        for record in out["history"]:
            assert all(np.isfinite(record[k]) for k in ("lossE", "lossD", "loss_kl",
                                                        "loss_rec", "expelbo_r"))
        assert out["routes"] == {"gathered": 10, "single": 0}
    for ra, rb in zip(a["history"], b["history"]):
        assert {k: v for k, v in ra.items() if k != "seconds"} == \
            {k: v for k, v in rb.items() if k != "seconds"}
    assert a["digest"] == b["digest"]
    saves = os.listdir(root / "saves")
    assert len(saves) == 1 and saves[0].endswith("model_epoch_0_iter_2")
    assert _checkpoint_digest(str(root / "saves" / saves[0])) == a["digest"]


def _checkpoint_digest(path: str) -> str:
    """state_digest of a SoftIntroVAE holding the checkpoint's weights."""
    from intro_tc_vae_tpu_torch.models import Decoder, Encoder, SoftIntroVAE
    from intro_tc_vae_tpu_torch.parallel import state_digest
    from intro_tc_vae_tpu_torch.utils import load_model

    payload = torch.load(path, weights_only=True)
    z = payload["decoder"]["fc.0.weight"].shape[1]
    kw = dict(arch="conv", cdim=3, zdim=z, channels=(16, 32), image_size=32)
    model = SoftIntroVAE(Encoder(**kw), Decoder(**kw))
    return state_digest(load_model(model, path))


@pytest.mark.parametrize("k,error,match", [
    (0, ValueError, "data_parallel=4 but 2 process"),
    (1, ValueError, "batch_size 9 not divisible by the data-axis size 2"),
    (2, ValueError, "3 devices not divisible by model_parallel=2"),
], ids=["data_parallel_4_of_2", "batch_not_divisible", "model_parallel_2"])
def test_train_mesh_checks_raise_on_every_rank(train_ranks, k, error, match):
    for out in train_ranks[0]:
        assert out["errors"][k] is not None, BAD_UPDATES[k]
        name, msg = out["errors"][k]
        assert name == error.__name__ and re.search(match, msg), msg


@pytest.mark.parametrize("update,error,match", [
    (dict(data_parallel=2), ValueError, "data_parallel=2 but 1 process"),
    (dict(model_parallel=2), ValueError, "1 devices not divisible by model_parallel=2"),
], ids=["data_parallel_2_in_one_process", "model_parallel_2"])
def test_mesh_size_checks_raise_in_one_process(update, error, match):
    config = load_config(FLAGSHIP, {**SMALL_RUN, "batch_size": 8, **update})
    with pytest.raises(error, match=match):
        train_soft_intro_vae(config, device=CPU)


def test_make_mesh_checks():
    mesh = make_mesh(device=CPU)
    assert (mesh.size, mesh.rank, mesh.device) == (1, 0, CPU)
    with pytest.raises(ValueError, match="only 1 available"):
        make_mesh(2, device=CPU)
    with pytest.raises(ValueError, match="not divisible by model_parallel=2"):
        make_mesh(model_parallel=2, device=CPU)


def test_local_batch_slice_and_row_blocks():
    assert local_batch_slice(128) == slice(0, 128)
    assert [row_block(128, 8, r) for r in (0, 7)] == [slice(0, 16), slice(112, 128)]
    with pytest.raises(ValueError, match="not divisible by 3 processes"):
        row_block(128, 3, 0)


@pytest.mark.parametrize("ranks,cards,backend", [
    (1, 1, "nccl"), (2, 2, "nccl"), (2, 4, "nccl"), (2, 1, "gloo"), (8, 1, "gloo"),
    (2, 0, "gloo"),
])
def test_backend_rule(ranks, cards, backend):
    assert backend_for(ranks, cards)[0] == backend


# ---------------------------------------------------------------------------
# (vii) checkpoints on 2 ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def resume_runs(tmp_path_factory):
    """Two ranks and one process: a step, a save, a load into a fresh
    state (other weights), a second step; the same weights, global batches
    and noise, float64."""
    from tests._torch_dp_workers import _dp_solver

    ds = JSynthetic(image_size=32, cdim=3, sizes=(2, 2, 4, 4))
    batches = [ds.get_batch(np.arange(k * B, (k + 1) * B)).astype(np.float64) for k in (0, 1)]
    rng = np.random.default_rng(3)
    noises = [{k: torch.from_numpy(rng.standard_normal((B, SMALL["zdim"]))) for k in NOISE_KEYS}
              for _ in batches]
    torch.manual_seed(0)
    init = workers.SoftIntroVAE(workers.Encoder(**SMALL), workers.Decoder(**SMALL)).double()
    init = {k: v.clone() for k, v in init.state_dict().items()}
    out = tmp_path_factory.mktemp("resume")
    ranks = workers.run_ranks(workers.checkpoint_resume, 2,
                              (init, batches, noises, str(out / "saves")), out)

    solver, state = _dp_solver(init, B)
    for batch, noise in zip(batches, noises):
        _, metrics = solver.train_step(
            state, torch.from_numpy(batch.transpose(0, 3, 1, 2).copy()), noise=noise)
    one = dict(metrics={k: float(v) for k, v in metrics.items()},
               state={k: v.clone() for k, v in state.model.state_dict().items()})
    return ranks, one, out


def test_dp_checkpoint_rank0_writes_and_every_rank_loads(resume_runs):
    ranks, _, out = resume_runs
    assert [len(r["writes"]) for r in ranks] == [1, 0]
    assert os.listdir(out / "saves") == ["dp_model_epoch_0_iter_1"]
    for r in ranks:
        assert r["loaded"] == r["saved"] == ranks[0]["saved"]
        assert r["step"] == 1
    assert ranks[0]["digest"] == ranks[1]["digest"]


def test_dp_resumed_step_equals_the_one_process_step(resume_runs):
    """The second step, taken by two ranks from the state they loaded,
    against two uninterrupted steps in one process on the whole batches,
    float64. The collectives sum in another order than one process, and
    the models' float32 casts of mu/logvar and of the pre-sigmoid output
    turn that into float32 roundings: metrics within rtol 1e-6, parameters
    and statistics within 1e-6 (measured: 1.8e-7 relative, 2.3e-7)."""
    ranks, one, _ = resume_runs
    for r in ranks:
        for name, ref in one["metrics"].items():
            np.testing.assert_allclose(r["metrics"][name], ref, rtol=1e-6, atol=0,
                                       err_msg=name)
    for key, ref in one["state"].items():
        np.testing.assert_allclose(ranks[0]["state"][key].numpy(), ref.numpy(),
                                   rtol=0, atol=1e-6, err_msg=key)
