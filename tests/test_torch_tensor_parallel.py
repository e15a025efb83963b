"""PyTorch port, tensor parallel (``model_parallel`` > 1): the port's
('data', 'model') mesh against one process and against the JAX package's
sharded step.

The ranks are processes (``tests/_torch_dp_workers.py::run_ranks``:
spawned, ``gloo`` on the CPU, a 120 s timeout that kills stuck ranks);
their code is ``tests/_torch_tp_workers.py``, which imports no jax. The
small model is tests/test_parallel.py's TP2xDP4 one (res arch, channels
(8, 16), z 8, 32 px, batch 8) with ``min_dim`` 8, as that test lowers it,
so every leaf of 8 channels or more is cut.

Cases:
(i)   ``param_spec`` against JAX's on every leaf of the three archs at the
      flagship width (``min_dim`` 256) and at the small model's
      (``min_dim`` 8), through the weight bridge's name and layout map;
(ii)  ``gather_channels``, ``copy_to_model`` and ``reduce_from_model``,
      forward and backward, against one process;
(iii) one float64 intro_tc step on TP2 (res, conv, inception, res with
      ``remat: "pass"``) and on TP2 x DP2 (res) against the port's
      one-process step: rtol 1e-6 and atol 1e-6, the data-parallel resume
      test's tolerance (the models' float32 casts of mu, logvar and the
      pre-sigmoid output turn the collectives' other summation order into
      float32 roundings);
(iv)  the TP2 x DP2 step against the JAX sharded step (``shard_state(...,
      min_dim=8)`` on ``make_mesh(4, model_parallel=2)``, tc_impl 'xla',
      float64: JAX's Pallas TC stalls under x64) at JAX's own tolerances
      (tests/test_parallel.py:250-258);
(v)   replicated leaves bit-equal on every rank after 3 steps;
(vi)  checkpoints: a TP checkpoint (rank 0 writes whole tensors) loaded in
      one process and on TP ranks, and a one-process checkpoint resumed on
      TP ranks, each equal to the uninterrupted run;
(vii) ``train_soft_intro_vae`` on TP2 x DP2 (4 ranks), and the mesh-size
      errors.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intro_tc_vae_tpu.data import Synthetic as JSynthetic
from intro_tc_vae_tpu.models import Decoder as JDecoder
from intro_tc_vae_tpu.models import Encoder as JEncoder
from intro_tc_vae_tpu.parallel import batch_sharding as jbatch_sharding
from intro_tc_vae_tpu.parallel import make_mesh as jmake_mesh
from intro_tc_vae_tpu.parallel import param_spec as jparam_spec
from intro_tc_vae_tpu.parallel import shard_state as jshard_state
from intro_tc_vae_tpu.solvers import make_optimizer as jmake_optimizer
from intro_tc_vae_tpu.solvers import make_solver as jmake_solver
from intro_tc_vae_tpu_torch.config import load_config
from intro_tc_vae_tpu_torch.data import Synthetic
from intro_tc_vae_tpu_torch.models import Decoder, Encoder, SoftIntroVAE, conv_output_size
from intro_tc_vae_tpu_torch.parallel import DataGroup, ModelGroup, make_mesh, param_spec
from intro_tc_vae_tpu_torch.solvers import NOISE_KEYS
from intro_tc_vae_tpu_torch.train import data_axis_size
from intro_tc_vae_tpu_torch.utils import checkpoint, flax_to_port
from tests import _torch_dp_workers as dp_workers
from tests import _torch_tp_workers as workers
from tests._torch_threads import one_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "configs", "intro_tc_ukiyo64.json")
CPU = torch.device("cpu")
SMALL = workers.SMALL
B = 8
STEP_TOL = dict(rtol=1e-6, atol=1e-6)
INTRO_METRICS = ("lossE", "lossD", "loss_kl", "loss_rec", "kl_loss_unscaled",
                 "r_loss_unscaled", "expelbo_r", "expelbo_f", "diff_kl", "fc_grad_norm")


def _batches(n: int) -> list:
    """``n`` global batches of 8 distinct images."""
    ds = Synthetic(image_size=32, cdim=3, sizes=(2, 2, 4, 4))
    return [ds.get_batch(np.arange(k * B, (k + 1) * B)).astype(np.float64) for k in range(n)]


def _nchw(batch: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(batch.transpose(0, 3, 1, 2).copy())


def _one_process(arch: str, init: dict, batches: list, noises: list, remat=False,
                 model=None):
    """``len(batches)`` float64 steps in one process: the metrics and state
    dict after each."""
    solver, state = workers.tp_solver(arch, init, B, remat=remat, model=model)
    out = []
    for batch, noise in zip(batches, noises):
        _, metrics = solver.train_step(state, _nchw(batch), noise=noise)
        out.append(dict(metrics={k: float(v) for k, v in metrics.items()},
                        state={k: v.clone() for k, v in state.model.state_dict().items()}))
    return out, (solver, state)


def _assert_step(got: dict, want: dict, **tol):
    """Metrics and state within ``tol`` (STEP_TOL by default); prints the
    largest relative metric and absolute state differences."""
    tol = tol or STEP_TOL
    rel = max(abs(got["metrics"][n] - want["metrics"][n]) / abs(want["metrics"][n])
              for n in INTRO_METRICS)
    gap = max(float((got["state"][k].double() - v.double()).abs().max())
              for k, v in want["state"].items())
    print(f"step: metrics max rel diff {rel:.3g}, state max abs diff {gap:.3g}")
    for name in INTRO_METRICS:
        np.testing.assert_allclose(got["metrics"][name], want["metrics"][name], err_msg=name,
                                   **tol)
    assert set(got["state"]) == set(want["state"])
    for key, ref in want["state"].items():
        np.testing.assert_allclose(got["state"][key].numpy(), ref.numpy(), err_msg=key, **tol)


# ---------------------------------------------------------------------------
# (i) param_spec against JAX's
# ---------------------------------------------------------------------------

WIDTHS = {"flagship": (dict(cdim=3, zdim=128, channels=(64, 128, 256, 512), image_size=64),
                       256),
          "small": (SMALL, workers.MIN_DIM)}
# fp32 bytes of the flagship's params and statistics that JAX's param_spec
# shards at model axis 2, per arch: (encoder, decoder)
FLAGSHIP_SHARDED_BYTES = {"conv": (44_999_680, 30_203_904), "res": (45_655_040, 30_728_192),
                          "inception": (14_985_216, 8_707_072)}


def _marker(shape, spec) -> np.ndarray:
    """Zeros for a replicated leaf; for one sharded along axis a, 1 + the
    index along a, so the weight bridge's transposes and permutations
    carry the sharded axis to the port's layout."""
    axes = [a for a, name in enumerate(tuple(spec) + (None,) * len(shape)) if name == "model"]
    if not axes:
        return np.zeros(shape)
    (a,) = axes
    idx = np.arange(1, shape[a] + 1).reshape([-1 if i == a else 1 for i in range(len(shape))])
    return np.broadcast_to(idx, shape).astype(np.float64)


def _varying_dim(t: torch.Tensor):
    dims = [d for d in range(t.dim())
            if t.shape[d] > 1 and not torch.equal(t, t.narrow(d, 0, 1).expand_as(t))]
    assert len(dims) <= 1, dims
    return dims[0] if dims else None


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("arch", ["conv", "res", "inception"])
def test_param_spec_matches_jax(arch, width):
    """The same leaves sharded on the same logical axis: JAX's specs on
    ``make_mesh(4, model_parallel=2)``, carried through ``flax_to_port``,
    against the port's ``param_spec`` on its own state_dict keys. At
    ``min_dim`` 256 no conv the kernel gate routes (64 -> 64) is cut, and
    the flagship's sharded bytes are those JAX's rules give."""
    kw, min_dim = WIDTHS[width]
    jmesh = jmake_mesh(4, model_parallel=2)
    size = kw["image_size"]
    trees = {}
    for side, net, x in (("encoder", JEncoder(arch=arch, **kw), jnp.zeros((1, size, size, 3))),
                         ("decoder", JDecoder(arch=arch, **kw), jnp.zeros((1, kw["zdim"])))):
        shapes = jax.eval_shape(lambda k, net=net, x=x: net.init({"params": k}, x, True),
                                jax.random.key(0))
        trees[side] = {coll: jax.tree_util.tree_map_with_path(
            lambda path, leaf: _marker(leaf.shape, jparam_spec(
                "/".join(str(getattr(p, "key", p)) for p in path), leaf.shape, jmesh,
                min_dim)), shapes[coll]) for coll in ("params", "batch_stats")}
    cos = conv_output_size(size, kw["channels"])
    want = flax_to_port({s: trees[s]["params"] for s in trees},
                        {s: trees[s]["batch_stats"] for s in trees}, arch,
                        (cos[0], cos[1], cos[2]))

    with torch.device("meta"):
        model = SoftIntroVAE(Encoder(arch=arch, **kw), Decoder(arch=arch, **kw))
    mesh = DataGroup(group=None, size=2, rank=0, device=CPU,
                     model=ModelGroup(group=None, size=2, rank=0))
    got = {k: param_spec(k, t.shape, mesh, min_dim) for k, t in model.state_dict().items()}
    assert set(got) == set(want)
    for key, t in want.items():
        assert got[key] == _varying_dim(t), key
    assert any(d is not None for d in got.values())
    if width == "flagship":
        shapes = {k: tuple(t.shape) for k, t in model.state_dict().items()}
        assert all(got[k] is None for k, s in shapes.items() if s == (64, 64, 3, 3))
        sharded = [sum(4 * int(np.prod(s)) for k, s in shapes.items()
                       if k.startswith(side) and got[k] is not None)
                   for side in ("encoder", "decoder")]
        assert tuple(sharded) == FLAGSHIP_SHARDED_BYTES[arch]


def test_param_spec_rules_on_torch_layouts():
    """JAX's test_param_spec_rules on the port's layouts: a conv weight
    [out, in, kh, kw] cuts its outputs, a Linear weight [out, in] its
    widest divisible dim (outputs on a tie), per-channel vectors theirs;
    no model axis replicates everything."""
    mesh = DataGroup(group=None, size=4, rank=0, device=CPU,
                     model=ModelGroup(group=None, size=2, rank=0))
    assert param_spec("a.weight", (512, 256, 3, 3), mesh) == 0
    assert param_spec("a.weight", (32, 16, 3, 3), mesh) is None
    assert param_spec("fc.weight", (256, 1024), mesh) == 1
    assert param_spec("fc.weight", (1024, 128), mesh) == 0
    assert param_spec("fc.weight", (256, 256), mesh) == 0
    assert param_spec("bn.running_var", (512,), mesh) == 0
    assert param_spec("bn.running_var", (511,), mesh) is None
    dp_only = DataGroup(group=None, size=8, rank=0, device=CPU)
    assert param_spec("fc.weight", (256, 1024), dp_only) is None


# ---------------------------------------------------------------------------
# (ii) the model-axis collectives
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def collective_ranks(tmp_path_factory):
    rng = np.random.RandomState(5)
    xs = [rng.randn(3, 2, 4) for _ in range(2)]     # each rank's slice, dim 1
    whole_x = rng.randn(3, 4, 4)
    partials = [rng.randn(3, 4, 4) for _ in range(2)]
    cot = rng.randn(3, 4, 4)
    args = (xs, whole_x, partials, cot)
    return args, dp_workers.run_ranks(workers.collectives, 2, args,
                                      tmp_path_factory.mktemp("tp_collectives"))


@pytest.mark.parametrize("op", ["gather_channels", "copy_to_model", "reduce_from_model"])
def test_model_collectives_match_one_process(collective_ranks, op):
    """Every rank's loss is the same function of the whole tensor, as the
    ranks of a model group compute it: the forward is the one-process
    value and each rank's gradient is its part of the one-process
    gradient (its slice for the gather; the whole gradient, summed over
    the ranks' parts, for the copy; the whole gradient for the sum). A
    bf16 gather is a bit copy."""
    (xs, whole_x, partials, cot), ranks = collective_ranks
    for m, out in enumerate(ranks):
        assert out["mesh"] == (1, 0, 2, m)
        if op == "gather_channels":
            np.testing.assert_array_equal(out["gathered"].numpy(), np.concatenate(xs, axis=1))
            np.testing.assert_array_equal(out["dx"].numpy(), cot[:, 2 * m:2 * m + 2])
            want = torch.from_numpy(np.concatenate(xs, axis=1)).to(torch.bfloat16)
            assert torch.equal(out["gathered_bf16"], want)
        elif op == "copy_to_model":
            np.testing.assert_array_equal(out["dcopy"].numpy(), cot)
        else:
            np.testing.assert_allclose(out["sum"].numpy(), partials[0] + partials[1],
                                       rtol=1e-15)
            np.testing.assert_array_equal(out["dp"].numpy(), cot)


# ---------------------------------------------------------------------------
# (iii), (v), (vi): TP2 steps, three steps and checkpoints on 2 ranks
# ---------------------------------------------------------------------------

# label: (arch, remat, other model arguments, min_dim). "conv routed": the
# 3x3 64 -> 64 convs (conv_impl 'pallas') go to the conv kernels' wrapper
# (on the CPU its plain version), and min_dim 64 cuts them: each rank
# gathers their weights and runs them whole
ROUTED = dict(channels=(64,), conv_impl="pallas")
TP2_CASES = {"res": ("res", False, None, workers.MIN_DIM),
             "conv": ("conv", False, None, workers.MIN_DIM),
             "inception": ("inception", False, None, workers.MIN_DIM),
             "res remat pass": ("res", "pass", None, workers.MIN_DIM),
             "conv routed": ("conv", False, ROUTED, 64)}


def _init(arch: str, model=None) -> dict:
    torch.manual_seed(0)
    kw = dict(arch=arch, **{**SMALL, **(model or {})})
    net = SoftIntroVAE(Encoder(**kw), Decoder(**kw)).double()
    return {k: v.clone() for k, v in net.state_dict().items()}


@pytest.fixture(scope="module")
def tp2_runs(tmp_path_factory):
    """Three global batches and noises; one process's steps of each case
    and a one-process checkpoint after the res arch's first step; then the
    2 ranks (``tp_steps``)."""
    inits = {label: _init(arch, model) for label, (arch, _, model, _) in TP2_CASES.items()}
    batches = _batches(3)
    rng = np.random.default_rng(3)
    noises = [{k: torch.from_numpy(rng.standard_normal((B, SMALL["zdim"])))
               for k in NOISE_KEYS} for _ in batches]
    convs = workers.count_conv_kernel_calls()
    one = {}
    for label, (arch, remat, model, _) in TP2_CASES.items():
        convs.update(conv3x3_pallas=0)
        one[label] = dict(_one_process(arch, inits[label], batches[:1], noises[:1], remat,
                                       model)[0][0], convs=dict(convs))
    three, (_, state) = _one_process("res", inits["res"], batches[:1], noises[:1])
    out = tmp_path_factory.mktemp("tp2")
    one_path = checkpoint.save_checkpoint(state, 0, 1, "one_", checkpoint_dir=str(out / "one"))
    three, _ = _one_process("res", inits["res"], batches, noises)
    cases = {label: (arch, remat, inits[label], model, min_dim)
             for label, (arch, remat, model, min_dim) in TP2_CASES.items()}
    ranks = dp_workers.run_ranks(
        workers.tp_steps, 2,
        (cases, batches, noises, 2, ("res", inits["res"], str(out / "tp"), one_path)), out)
    return dict(one=one, three=three, ranks=ranks, out=out, inits=inits, batches=batches,
                noises=noises)


@pytest.mark.parametrize("label", list(TP2_CASES))
def test_tp2_step_matches_one_process(tp2_runs, label):
    """Metrics (equal on both ranks) and the gathered parameters and
    BatchNorm statistics after one step against the one-process step; the
    conv kernels' wrapper takes as many calls on each rank as in one
    process (the routed convs run whole on every rank, cut or not)."""
    a, b = (r[label] for r in tp2_runs["ranks"])
    assert a["metrics"] == b["metrics"]
    for key in a["state"]:
        assert torch.equal(a["state"][key], b["state"][key]), key
    _assert_step(a, tp2_runs["one"][label])
    assert a["convs"] == b["convs"] == tp2_runs["one"][label]["convs"]
    if label == "conv routed":
        assert a["convs"]["conv3x3_pallas"] > 0
        assert "decoder.main.res_in_32.conv2.weight" in a["sharded"]


@pytest.mark.parametrize("label", list(TP2_CASES))
def test_tp2_leaves_are_cut_as_param_spec_says(tp2_runs, label):
    """Each rank holds its half of exactly the leaves ``param_spec`` cuts
    at ``min_dim`` 8, and both optimizers' moments of them gathered whole
    have the whole shapes."""
    min_dim = TP2_CASES[label][3]
    whole = tp2_runs["inits"][label]
    mesh = DataGroup(group=None, size=1, rank=0, device=CPU,
                     model=ModelGroup(group=None, size=2, rank=0))
    want = sorted(k for k, t in whole.items() if param_spec(k, t.shape, mesh, min_dim) is not None)
    for r in tp2_runs["ranks"]:
        got = r[label]
        assert got["sharded"] == want
        for key, t in whole.items():
            d = param_spec(key, t.shape, mesh, min_dim)
            shape = list(t.shape)
            if d is not None:
                shape[d] //= 2
            assert got["local"][key] == tuple(shape), key
        for opt in (got["opt_e"], got["opt_d"]):
            assert all(v["exp_avg"].shape == v["exp_avg_sq"].shape for v in opt["state"].values())


@pytest.mark.parametrize("grid,routes", [("tp2", {"gathered": 0, "single": 5}),
                                         ("tp2dp2", {"gathered": 5, "single": 0})])
def test_tc_route_follows_the_data_axis(tp2_runs, tp2dp2_runs, grid, routes):
    """The TC sees the data axis only: on TP2 (one data index) every call
    of the step takes the single-device route, on TP2 x DP2 the gathered
    one (3 calls in phase E, 2 in phase D)."""
    ranks = ([r["res"] for r in tp2_runs["ranks"]] if grid == "tp2"
             else [r["step"] for r in tp2dp2_runs["ranks"]])
    for r in ranks:
        assert r["routes"] == routes


def test_replicated_leaves_bit_equal_after_three_steps(tp2_runs):
    """After three steps every leaf the model axis does not cut is the
    same bit for bit on both ranks (the replicated gradients are averaged
    over every rank), and the gathered state is the one-process run's."""
    ranks = tp2_runs["ranks"]
    assert ranks[0]["three_steps"]["agree"] and ranks[1]["three_steps"]["agree"]
    assert ranks[0]["three_steps"]["digest"] == ranks[1]["three_steps"]["digest"]
    for k in range(3):
        _assert_step(ranks[0]["three_steps"]["runs"][k], tp2_runs["three"][k])


def test_tp_checkpoint_is_whole_and_loads_in_one_process(tp2_runs):
    """Rank 0 alone wrote the TP checkpoint (in the background), in the
    one-file format with whole tensors: loaded in one process it equals
    the ranks' gathered state and optimizer moments bit for bit, and the
    second step from it equals the uninterrupted one-process run."""
    ranks = tp2_runs["ranks"]
    assert len(ranks[0]["writes"]) == 1 and ranks[1]["writes"] == []
    path = ranks[0]["writes"][0]
    payload = torch.load(path, weights_only=True)
    saved = ranks[0]["saved"]
    whole = {**{f"encoder.{k}": v for k, v in payload["encoder"].items()},
             **{f"decoder.{k}": v for k, v in payload["decoder"].items()}}
    assert set(whole) == set(saved["state"])
    for key, t in saved["state"].items():
        assert torch.equal(whole[key], t), key
    for name in ("opt_e", "opt_d"):
        for i, entry in saved[name]["state"].items():
            for k, v in entry.items():
                assert torch.equal(payload[name]["state"][i][k], v), (name, i, k)
    solver, state = workers.tp_solver("res", tp2_runs["inits"]["res"], B, bump=0.5)
    checkpoint.load_checkpoint(path, state)
    _, metrics = solver.train_step(state, _nchw(tp2_runs["batches"][1]),
                                   noise=tp2_runs["noises"][1])
    got = dict(metrics={k: float(v) for k, v in metrics.items()},
               state=dict(state.model.state_dict()))
    _assert_step(got, tp2_runs["three"][1])


@pytest.mark.parametrize("source", ["tp_resume", "one_process_resume"])
def test_checkpoint_resumes_on_tp_ranks(tp2_runs, source):
    """The TP checkpoint and a one-process one, each loaded on TP2 ranks
    into a fresh state of other weights: every rank cuts its slices (the
    loaded state, gathered, is the saved one), and the second step equals
    the uninterrupted one-process run."""
    for r in tp2_runs["ranks"]:
        loaded = r[source]["loaded"]["state"]
        saved = (tp2_runs["ranks"][0]["saved"]["state"] if source == "tp_resume"
                 else tp2_runs["three"][0]["state"])
        for key, t in saved.items():
            assert torch.equal(loaded[key], t), key
        _assert_step(r[source]["step"], tp2_runs["three"][1])


# ---------------------------------------------------------------------------
# (iii), (iv), (vii): TP2 x DP2 on 4 ranks, against one process and JAX
# ---------------------------------------------------------------------------

COS = conv_output_size(32, SMALL["channels"])
JAX_METRIC_TOL = dict(rtol=5e-4)           # tests/test_parallel.py:250-251
JAX_PARAM_TOL = dict(rtol=5e-3, atol=5e-4)  # tests/test_parallel.py:257-258


def _jax_tp_step(batch):
    """One float64 step of the JAX intro_tc solver (res arch, tc_impl
    'xla') with its state sharded by ``shard_state(..., min_dim=8)`` on
    ``make_mesh(4, model_parallel=2)`` and the batch on the data axis;
    returns (initial weights as a port state dict, the step's noise,
    metrics, port state dict after)."""
    mesh = jmake_mesh(4, model_parallel=2)
    solver = jmake_solver(
        "intro_tc", dataset=JSynthetic(image_size=32, cdim=3, sizes=(2, 2, 2, 2)),
        encoder=JEncoder(arch="res", **SMALL), decoder=JDecoder(arch="res", **SMALL),
        batch_size=B, optimizer_e=jmake_optimizer("adam", 2e-4),
        optimizer_d=jmake_optimizer("adam", 2e-4), tc_impl="xla", **workers.HYPER)
    state = solver.init_state(jax.random.key(0), jnp.asarray(batch, jnp.float32))
    init = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                  (state.params, state.batch_stats))
    with jax.enable_x64(True):
        params, stats = jax.tree_util.tree_map(jnp.asarray, init)
        state = jshard_state(state.replace(
            params=params, batch_stats=stats,
            opt_state_e=solver.optimizer_e.init(params["encoder"]),
            opt_state_d=solver.optimizer_d.init(params["decoder"])), mesh, min_dim=8)
        kernel = state.params["encoder"]["fc"]["kernel"]
        assert "model" in tuple(kernel.sharding.spec)
        keys = jax.random.split(state.rng, 7)  # the intro step's split (solvers/intro.py:81-85)
        noise = {k: np.asarray(jax.random.normal(
            keys[i + 1], (B, SMALL["zdim"]), **({} if k == "prior" else {"dtype": jnp.float32})))
            for i, k in enumerate(NOISE_KEYS)}
        x = jax.device_put(jnp.asarray(batch), jbatch_sharding(mesh))
        state, metrics = solver._step_fn(state, x)
        return (flax_to_port(*init, "res", COS), noise,
                {k: float(metrics[k]) for k in INTRO_METRICS},
                flax_to_port(state.params, state.batch_stats, "res", COS))


TRAIN_UPDATE = dict(dataset="synthetic_small", tc_impl="pallas", num_epochs=1,
                    use_tensorboard=False, z_dim=8, batch_size=16, data_parallel=4,
                    model_parallel=2)


@pytest.fixture(scope="module")
def tp2dp2_runs(tmp_path_factory):
    """The JAX sharded step, the port's one-process step from the same
    weights, batch and noise, and the 4 ranks: that step, then the
    trainer on TP2 x DP2."""
    batch = _batches(1)[0]
    init, noise, jax_metrics, jax_state = _jax_tp_step(batch)
    torch_noise = {k: torch.from_numpy(np.array(v)) for k, v in noise.items()}
    one, _ = _one_process("res", init, [batch], [torch_noise])
    out = tmp_path_factory.mktemp("tp2dp2")
    update = {**TRAIN_UPDATE, "checkpoint_dir": str(out / "saves")}
    ranks = dp_workers.run_ranks(workers.tp2dp2, 4, (init, batch, noise, FLAGSHIP, update),
                                 out)
    return dict(jax=(jax_metrics, jax_state), one=one[0], ranks=ranks, out=out)


def test_tp2dp2_step_matches_one_process(tp2dp2_runs):
    """Metrics equal on all four ranks; the gathered state equal on all
    four and within rtol/atol 1e-6 of the one-process step."""
    ranks = [r["step"] for r in tp2dp2_runs["ranks"]]
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
        for key, t in r["state"].items():
            assert torch.equal(t, ranks[0]["state"][key]), key
    assert [r["mesh"] for r in ranks] == [(2, 0, 2, 0), (2, 0, 2, 1), (2, 1, 2, 0),
                                          (2, 1, 2, 1)]
    _assert_step(ranks[0], tp2dp2_runs["one"])


def test_tp2dp2_step_matches_jax_sharded_step(tp2dp2_runs):
    """The port's TP2 x DP2 step against the JAX package's step on the
    TP2 x DP2 mesh, same weights, batch and noise, float64 in both, at the
    JAX TP test's tolerances."""
    jax_metrics, jax_state = tp2dp2_runs["jax"]
    got = tp2dp2_runs["ranks"][0]["step"]
    for name, ref in jax_metrics.items():
        np.testing.assert_allclose(got["metrics"][name], ref, err_msg=name, **JAX_METRIC_TOL)
    assert set(got["state"]) == set(jax_state)
    for key, ref in jax_state.items():
        np.testing.assert_allclose(got["state"][key].numpy(), ref.numpy(), err_msg=key,
                                   **JAX_PARAM_TOL)


def test_train_tp2dp2_on_cpu(tp2dp2_runs):
    """The flagship recipe at the synthetic_small size on 4 ranks,
    data_parallel 4 (the total) and model_parallel 2, global batch 16,
    ``min_dim`` lowered to 8: 64 images are 4 steps, every loss finite and
    equal on all ranks, 5 gathered TC calls a step, replicated leaves and
    the gathered state bit-equal on all ranks, the final decode of fresh
    noise whole on every rank, and one final checkpoint (rank 0 wrote it)
    that holds the gathered state."""
    ranks = [r["train"] for r in tp2dp2_runs["ranks"]]
    for r in ranks:
        assert [h["step"] for h in r["history"]] == [1, 2, 3, 4]
        for h in r["history"]:
            assert all(np.isfinite(h[k]) for k in ("lossE", "lossD", "loss_kl", "loss_rec"))
        assert r["routes"] == {"gathered": 20, "single": 0}
        assert r["sharded"]
        assert r["samples"].shape == (16, 3, 32, 32)
        assert torch.equal(r["samples"], ranks[0]["samples"])
        assert r["replicated"] == ranks[0]["replicated"] and r["whole"] == ranks[0]["whole"]
        strip = [{k: v for k, v in h.items() if k != "seconds"} for h in r["history"]]
        assert strip == [{k: v for k, v in h.items() if k != "seconds"}
                         for h in ranks[0]["history"]]
    saves = os.listdir(tp2dp2_runs["out"] / "saves")
    assert len(saves) == 1 and saves[0].endswith("model_epoch_0_iter_4")
    payload = torch.load(tp2dp2_runs["out"] / "saves" / saves[0], weights_only=True)
    kw = dict(arch="conv", cdim=3, zdim=8, channels=(16, 32), image_size=32)
    model = SoftIntroVAE(Encoder(**kw), Decoder(**kw))
    model.encoder.load_state_dict(payload["encoder"])
    model.decoder.load_state_dict(payload["decoder"])
    assert workers.state_digest_whole(model) == ranks[0]["whole"]


# ---------------------------------------------------------------------------
# (vii) the mesh-size errors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("update,world,match", [
    (dict(data_parallel=3, model_parallel=2), 3, "3 devices not divisible by model_parallel=2"),
    (dict(model_parallel=4), 2, "2 devices not divisible by model_parallel=4"),
    (dict(model_parallel=2, batch_size=9), 4,
     r"batch_size 9 not divisible by the data-axis size 2 \(data_parallel=0 total devices "
     r"/ model_parallel=2\)"),
    (dict(data_parallel=2, model_parallel=2), 4, "data_parallel=2 but 4 process"),
], ids=["total_not_divisible", "world_not_divisible", "batch_not_divisible", "total_not_world"])
def test_mesh_size_errors(update, world, match):
    """JAX's ValueErrors (train.py:117-129) and the port's own for a
    total that is not the number of processes."""
    config = load_config(FLAGSHIP, {**TRAIN_UPDATE, "data_parallel": 0, **update})
    with pytest.raises(ValueError, match=match):
        data_axis_size(config, world)


def test_make_mesh_model_axis_errors():
    with pytest.raises(ValueError, match="1 devices not divisible by model_parallel=2"):
        make_mesh(model_parallel=2, device=CPU)
    with pytest.raises(ValueError, match="requested 4 devices but only 1 available"):
        make_mesh(4, model_parallel=2, device=CPU)
