"""PyTorch port: the graphed train step (``solvers/graph.py``) on the CPU.

A CUDA graph is captured and replayed only on a card (``chip_smoke.py``
phase 15 holds the graphed flagship step bit-equal to the eager one). What
the CPU can hold:

* the rule that decides graphed or eager (``train.py::graph_step``), by
  config: graphed on CUDA in one process; eager for data or tensor
  parallel, ``anomaly_detection``, ``profile`` and the CPU; ``graph=True``
  where the rule says eager raises;
* the launch tally (``ops/launch_counts.py``): a stub graph whose capture
  runs a body that adds N launches records them as its tally and leaves
  the counters as they were; K replays add K·N, with the phase hooks run
  between the tally's segments as an eager step runs them; ``reset``
  zeroes every registered counter and a name registers once; the one
  launcher (``ops/cuda_build.py::launch``) against a stub library: its
  arguments, its count and profiler range, its refusal of an error;
* each of the eight optimizers with its step count on the parameters'
  device (torch's classes ``capturable``; their CUDA-only check is lifted
  for the CPU here) against optax over 5 updates, float64 (torch's step
  then float64, as JAX x64 counts in float64), rtol 1e-10 as
  tests/test_torch_optim.py; and a checkpoint round trip with the device
  step, into a capturable and into a host-step optimizer;
* ``GraphedStep``'s buffers and noise through its eager body: the same
  draws, in the same order, as ``step_noise``; a uint8 batch stays uint8
  in the static buffer and is normalized inside the body; steps through
  the body bit-equal to the eager solver's (parameters, statistics,
  optimizer states, metrics, the ring's drained values); a warm-up step
  (through a stub graph factory) leaves no tensor it made alive but the
  static buffers, its output and the optimizer states.
"""

import copy
import types

import numpy as np
import pytest
import torch

from intro_tc_vae_tpu_torch.ops import conv_cuda, launch_counts, tc_cuda
from intro_tc_vae_tpu_torch.solvers import NOISE_KEYS, make_optimizer, optim
from intro_tc_vae_tpu_torch.solvers.graph import GraphedStep
from intro_tc_vae_tpu_torch.utils import tracing
from tests._torch_threads import one_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
OPTIMIZERS = ("adam", "adamw", "adagrad", "adadelta", "sgd", "rmsprop", "lamb", "lion")
SMALL = dict(arch="conv", cdim=3, zdim=8, channels=(16, 32), image_size=32)
B = 8


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------

ONE = types.SimpleNamespace(size=1, model=None)
DP2 = types.SimpleNamespace(size=2, model=None)
TP2 = types.SimpleNamespace(size=1, model=types.SimpleNamespace(size=2))


@pytest.mark.parametrize("device,mesh,update,graph,want", [
    ("cuda", ONE, {}, None, True),
    ("cuda", None, {}, None, True),
    ("cuda", ONE, {}, False, False),
    ("cuda", ONE, {}, True, True),
    ("cpu", ONE, {}, None, False),
    ("cuda", DP2, {}, None, False),
    ("cuda", TP2, {}, None, False),
    ("cuda", ONE, {"anomaly_detection": True}, None, False),
    ("cuda", ONE, {"profile": True}, None, False),
    ("cpu", ONE, {}, True, "on cpu"),
    ("cuda", DP2, {}, True, "data or tensor parallel"),
    ("cuda", TP2, {}, True, "data or tensor parallel"),
    ("cuda", ONE, {"anomaly_detection": True}, True, "anomaly_detection"),
    ("cuda", ONE, {"profile": True}, True, "profile"),
], ids=["cuda", "cuda-no-mesh", "forced-eager", "forced-graph", "cpu", "data-parallel",
        "tensor-parallel", "anomaly", "profile", "raise-cpu", "raise-dp", "raise-tp",
        "raise-anomaly", "raise-profile"])
def test_graph_rule(device, mesh, update, graph, want):
    from intro_tc_vae_tpu_torch.config import load_config
    from intro_tc_vae_tpu_torch.train import graph_step

    config = load_config(update_dict=update)
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            graph_step(config, torch.device(device), mesh, graph)
    else:
        assert graph_step(config, torch.device(device), mesh, graph) is want


def test_build_solver_follows_the_rule_on_the_cpu():
    """On the CPU ``build_solver`` makes an eager solver, and asking for a
    graph raises there."""
    from intro_tc_vae_tpu_torch.config import load_config
    from intro_tc_vae_tpu_torch.data import Synthetic
    from intro_tc_vae_tpu_torch.models import Decoder, Encoder
    from intro_tc_vae_tpu_torch.parallel import make_mesh
    from intro_tc_vae_tpu_torch.train import build_solver

    config = load_config(update_dict=dict(solver="intro_tc", batch_size=B, z_dim=8))
    ds = Synthetic(image_size=32, cdim=3, sizes=(2, 2, 4, 4))
    enc, dec = Encoder(**SMALL), Decoder(**SMALL)
    mesh = make_mesh(1, device=CPU)
    assert build_solver(config, ds, enc, dec, mesh).graphed is None
    with pytest.raises(ValueError, match="on cpu"):
        build_solver(config, ds, enc, dec, mesh, graph=True)


# ---------------------------------------------------------------------------
# the launch tally
# ---------------------------------------------------------------------------

class StubGraph:
    """A graph whose capture runs the body (counting its launches) and
    whose replay runs nothing."""

    replays = 0

    def capture(self):
        import contextlib

        return contextlib.nullcontext()

    def replay(self):
        StubGraph.replays += 1


def _tiny_state():
    net = torch.nn.Linear(2, 2)
    return types.SimpleNamespace(
        step=0, model=net, opt_e=torch.optim.SGD(net.parameters(), lr=0.1),
        opt_d=torch.optim.SGD(net.parameters(), lr=0.1),
        generator=torch.Generator().manual_seed(0))


# per phase of the stub step: (counter, key, launches)
PHASES = ([(tc_cuda.LAUNCHES, "tc_fwd", 3), (tc_cuda.CALLS, "tc_logsumexp", 3)],
          [(tc_cuda.LAUNCHES, "tc_fwd", 2), (conv_cuda.LAUNCHES, "conv3x3_dw_wgmma", 6),
           (conv_cuda.LAUNCHES, "conv3x3_dw_reduce", 6)])


def _stub_step(state, batch, noise):
    """Adds each phase's launches, marking the phase's end (an optimizer
    update) after it, as the intro step does."""
    for phase in PHASES:
        for counts, key, n in phase:
            counts[key] += n
        launch_counts.mark()
    state.step += 1
    return {"loss_enc": batch.sum(), "loss_dec": noise["real"].sum()}


def _reads():
    return {**{f"tc.{k}": v for k, v in tc_cuda.LAUNCHES.items()},
            **{f"calls.{k}": v for k, v in tc_cuda.CALLS.items()},
            **{f"conv.{k}": v for k, v in conv_cuda.LAUNCHES.items()}}


@pytest.mark.parametrize("replays", [1, 5])
def test_launch_tally_of_a_stub_graph(replays):
    launch_counts.reset()
    one_step = {}
    for phase in PHASES:
        for counts, key, n in phase:
            name = {id(tc_cuda.LAUNCHES): "tc", id(tc_cuda.CALLS): "calls",
                    id(conv_cuda.LAUNCHES): "conv"}[id(counts)]
            one_step[f"{name}.{key}"] = one_step.get(f"{name}.{key}", 0) + n

    marks = []
    handle = launch_counts.on_mark(lambda: marks.append(_reads()))
    try:
        graphed = GraphedStep(_stub_step, ("real",), 2, graph_factory=StubGraph, warmup=3)
        state = _tiny_state()
        x = torch.ones(4, 2)
        for i in range(3):  # eager warm-up: counted as it runs, marks fire
            graphed(state, x)
        after_warmup = _reads()
        assert all(after_warmup[k] == 3 * v for k, v in one_step.items())
        assert len(marks) == 6 and state.step == 3

        StubGraph.replays = 0
        graphed(state, x)  # capture (counts nothing, fires no mark), then one replay
        assert graphed.captures == 1 and StubGraph.replays == 1 and state.step == 4
        assert graphed.tally.launches() == {k.split(".", 1)[1]: v for k, v in one_step.items()}
        assert len(graphed.tally.segments) == 3  # cut at the two marks
        for _ in range(replays - 1):
            graphed(state, x)
        got = _reads()
        for k, v in got.items():
            assert v == after_warmup[k] + replays * one_step.get(k, 0), k
        assert state.step == 3 + replays and StubGraph.replays == replays
        # the marks split each replay as the eager steps' did
        assert len(marks) == 6 + 2 * replays
        eager_phase_e = {k: marks[0][k] for k in one_step}
        replay_phase_e = {k: marks[6][k] - after_warmup[k] for k in one_step}
        assert replay_phase_e == eager_phase_e
    finally:
        handle.remove()
        launch_counts.reset()


def test_a_new_batch_shape_steps_eagerly_once_then_captures_again():
    graphed = GraphedStep(_stub_step, ("real",), 2, graph_factory=StubGraph, warmup=3)
    state = _tiny_state()
    for _ in range(4):
        graphed(state, torch.ones(4, 2))
    assert graphed.captures == 1 and graphed.graph is not None
    graphed(state, torch.ones(6, 2))  # eager: fills what the new shapes key
    assert graphed.captures == 1 and graphed.graph is None
    graphed(state, torch.ones(6, 2))
    assert graphed.captures == 2 and state.step == 6
    launch_counts.reset()


def test_recording_restores_the_counters_when_the_capture_fails():
    launch_counts.reset()
    with pytest.raises(RuntimeError, match="capture failed"):
        with launch_counts.recording():
            tc_cuda.LAUNCHES["tc_fwd"] += 7
            raise RuntimeError("capture failed")
    assert tc_cuda.LAUNCHES["tc_fwd"] == 0


def test_reset_zeroes_every_registered_counter_and_a_name_registers_once():
    from intro_tc_vae_tpu_torch.models import blocks
    from intro_tc_vae_tpu_torch.ops import batchnorm_cuda

    ported = (tc_cuda.LAUNCHES, tc_cuda.CALLS, conv_cuda.LAUNCHES, batchnorm_cuda.LAUNCHES,
              batchnorm_cuda.CALLS, batchnorm_cuda.RESAMPLES, blocks.STOCK_CALLS)
    saved = launch_counts.snapshot()
    try:
        for counts in ported:
            counts.update(dict.fromkeys(counts, 5))
        launch_counts.reset()
        assert all(n == 0 for counts in launch_counts.snapshot() for n in counts.values())
        assert all(n == 0 for counts in ported for n in counts.values())
    finally:
        for counts, before in zip(launch_counts._COUNTERS, saved):
            counts.update(before)
    registered = len(saved)
    for name in ("tc_fwd", "tc_logsumexp", "conv3x3_dw", "bn_stats", "plain_data_group",
                 "resample_pool", "pool_stock", "conv_expand"):
        with pytest.raises(ValueError, match=f"counters \\['{name}'\\] are already registered"):
            launch_counts.register({"a_new_counter": 0, name: 0})
    assert len(launch_counts.snapshot()) == registered


class _StubLibrary:
    """``cuda_build.Library``'s ``cdll`` stood in for: ``k_launch``
    records its arguments and returns 0, ``bad_launch`` returns an error."""

    def __init__(self):
        self.calls = []

    def k_launch(self, *args):
        self.calls.append(args)
        return 0

    def bad_launch(self, *args):
        return 719


def test_the_launcher_passes_pointers_then_device_and_stream_and_counts(monkeypatch):
    from intro_tc_vae_tpu_torch.ops import cuda_build

    library = cuda_build.Library("stub", {})
    stub = library.__dict__["cdll"] = _StubLibrary()  # what the first launch would bind
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=4096 + device.index))
    dev, x = torch.device("cuda", 2), torch.ones(3)
    counts = {"k": 0, "k_body": 0}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        cuda_build.launch(library, "k", x, None, 7, 0.5, device=dev, counts=counts)
        cuda_build.launch(library, "k", x, device=dev, counts=counts, counted="k_body")
        cuda_build.launch(library, "k", device=dev)  # uncounted: no count, no range
    assert stub.calls == [(x.data_ptr(), None, 7, 0.5, 2, 4098), (x.data_ptr(), 2, 4098),
                          (2, 4098)]
    assert counts == {"k": 1, "k_body": 1}
    ranges = [e.name for e in prof.events() if e.name.startswith("itcvae::launch:")]
    assert ranges == ["itcvae::launch:k", "itcvae::launch:k_body"]
    failed = {"bad": 0}
    with pytest.raises(RuntimeError, match="CUDA kernel bad failed to launch: cudaError 719"):
        cuda_build.launch(library, "bad", device=dev, counts=failed)
    assert failed == {"bad": 0}


# ---------------------------------------------------------------------------
# the optimizers with their steps on the device
# ---------------------------------------------------------------------------

@pytest.fixture
def capturable_on_cpu(monkeypatch):
    """Lift torch's check that a capturable optimizer's parameters lie on
    a card, so that the CPU runs the capturable arithmetic."""
    import importlib

    def devices(supports_xla: bool = True):
        return ["cuda", "cpu"]

    for name in ("adam", "adamw", "adadelta"):
        module = importlib.import_module(f"torch.optim.{name}")
        if hasattr(module, "_get_capturable_supported_devices"):
            monkeypatch.setattr(module, "_get_capturable_supported_devices", devices)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_device_step_optimizers_match_optax(name, capturable_on_cpu):
    import jax
    import jax.numpy as jnp

    from intro_tc_vae_tpu.solvers import make_optimizer as jmake_optimizer

    shapes, lr = ((4, 3, 3, 3), (7,), (5, 6)), 1e-2
    rng = np.random.default_rng(0)
    params = [rng.standard_normal(s) for s in shapes]
    params[1][2] = 0.0
    grads = [[rng.standard_normal(s) for s in shapes] for _ in range(5)]
    with jax.enable_x64(True):
        tx = jmake_optimizer(name, lr)
        jparams = [jnp.asarray(p) for p in params]
        opt_state = tx.init(jparams)
        want = []
        for g in grads:
            updates, opt_state = tx.update([jnp.asarray(x) for x in g], opt_state, jparams)
            jparams = [p + u for p, u in zip(jparams, updates)]
            want.append([np.asarray(p) for p in jparams])

    dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)  # torch's steps in float64, as x64 counts
    try:
        tparams = [torch.nn.Parameter(torch.tensor(p)) for p in params]
        opt = optim.place_steps(make_optimizer(name, lr)(tparams), capturable=True)
        for k, g in enumerate(grads):
            for p, x in zip(tparams, g):
                p.grad = torch.tensor(x)
            opt.step()
            _steps_where_read(opt, True, check_dtype=False)
            for i, (p, w) in enumerate(zip(tparams, want[k])):
                np.testing.assert_allclose(p.detach().numpy(), w, rtol=1e-10, atol=0,
                                           err_msg=f"{name} update {k + 1} param {i}")
    finally:
        torch.set_default_dtype(dtype)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_device_step_checkpoint_round_trip(name, capturable_on_cpu, tmp_path):
    """Two updates, the state through a file, then one more: into a new
    optimizer of the same kind the state loads bit-equal and the resumed
    update equals an uninterrupted run's, capturable or not; across the
    kinds (a card's checkpoint on a host-step run, an older one on a
    capturable run) the values load and the steps go where the target
    reads them."""
    torch.manual_seed(0)
    base = [torch.randn(3, 4), torch.randn(5)]
    grads = [[torch.randn_like(p) for p in base] for _ in range(3)]

    def run(capturable, steps, path=None, start=None):
        params = [torch.nn.Parameter(p.clone()) for p in (start or base)]
        opt = optim.place_steps(make_optimizer(name, 1e-2)(params), capturable)
        if path is not None:
            optim.load_state_dict(opt, torch.load(path, weights_only=True))
        for g in steps:
            for p, x in zip(params, g):
                p.grad = x.clone()
            opt.step()
        return [p.detach().clone() for p in params], opt

    for capturable in (True, False):
        params, opt = run(capturable, grads[:2])
        path = tmp_path / f"opt_{capturable}.pt"
        torch.save(opt.state_dict(), path)
        whole, _ = run(capturable, grads)
        resumed, again = run(capturable, grads[2:], path, params)
        assert all(torch.equal(a, b) for a, b in zip(whole, resumed)), (name, capturable)
        for target in (True, False):
            _, loaded = run(target, [], path)
            for p, q in zip(opt.state.values(), loaded.state.values()):
                for k in p:
                    assert torch.equal(p[k].float(), q[k].float()), (name, k)
            _steps_where_read(loaded, target)


def _steps_where_read(opt, capturable: bool, check_dtype: bool = True) -> None:
    """torch's classes: the flag and the steps as the optimizer was made
    (on the parameters' device when capturable, else on the host); the
    port's classes: float32 steps on the parameters' device (``check_dtype``
    False: torch's own steps, in the default dtype, not checked)."""
    for g in opt.param_groups:
        if isinstance(opt, optim.CAPTURABLE):
            assert g["capturable"] is capturable
        for p in g["params"]:
            step = opt.state.get(p, {}).get("step")
            if step is None:
                continue
            assert step.device == p.device
            if not isinstance(opt, optim.CAPTURABLE) or (capturable and check_dtype):
                assert step.dtype == torch.float32


@pytest.mark.parametrize("name", ["lamb", "lion"])
def test_an_int_step_of_an_older_checkpoint_loads_onto_the_device(name):
    params = [torch.nn.Parameter(torch.randn(4))]
    opt = make_optimizer(name, 1e-2)(params)
    params[0].grad = torch.randn(4)
    opt.step()
    sd = opt.state_dict()
    sd["state"][0]["step"] = 1  # as the port wrote it before the step moved
    fresh = make_optimizer(name, 1e-2)([torch.nn.Parameter(params[0].detach().clone())])
    optim.load_state_dict(fresh, sd)
    step = fresh.state[fresh.param_groups[0]["params"][0]]["step"]
    assert torch.is_tensor(step) and step.dtype == torch.float32 and float(step) == 1.0


# ---------------------------------------------------------------------------
# GraphedStep's buffers and noise, through its eager body
# ---------------------------------------------------------------------------

def _solver(graph: bool):
    from intro_tc_vae_tpu_torch.data import Synthetic
    from intro_tc_vae_tpu_torch.models import Decoder, Encoder
    from intro_tc_vae_tpu_torch.solvers import make_solver

    torch.manual_seed(0)
    enc, dec = Encoder(**SMALL), Decoder(**SMALL)
    solver = make_solver(
        "intro_tc", dataset=Synthetic(image_size=32, cdim=3, sizes=(2, 2, 4, 4)),
        encoder=enc, decoder=dec, batch_size=B,
        optimizer_e=make_optimizer("adam", 2e-4), optimizer_d=make_optimizer("adam", 2e-4),
        tc_impl="pallas", beta_kl=0.5, beta_rec=0.75, beta_neg=512.0)
    if graph:  # the graph's eager body for every call: no capture on the CPU
        solver.graphed = GraphedStep(solver._step_fn, solver.noise_keys, SMALL["zdim"],
                                     warmup=10**9)
    return solver, solver.init_state(5)


def _u8_batches(n: int):
    rng = np.random.default_rng(3)
    return [torch.from_numpy(rng.integers(0, 256, (B, 3, 32, 32), dtype=np.uint8))
            for _ in range(n)]


def test_graphed_step_draws_the_noise_step_noise_draws():
    from intro_tc_vae_tpu_torch.solvers.base import step_noise

    solver, state = _solver(True)
    twin = torch.Generator().manual_seed(5)
    x = _u8_batches(1)[0]
    graphed = solver.graphed
    for _ in range(2):
        graphed.fill(state, x)
        want = step_noise(solver.hyper, twin, None, B, CPU)
        assert list(graphed._noise) == list(NOISE_KEYS) == list(want)
        for k in NOISE_KEYS:
            assert torch.equal(graphed._noise[k], want[k]), k
    assert graphed._batch.dtype == torch.uint8 and torch.equal(graphed._batch, x)
    given = {k: torch.full((B, SMALL["zdim"]), float(i)) for i, k in enumerate(NOISE_KEYS)}
    state_before = twin.get_state()
    graphed.fill(state, x, given)
    assert all(torch.equal(graphed._noise[k], given[k]) for k in NOISE_KEYS)
    assert torch.equal(state.generator.get_state(), state_before)  # given noise: no draw


@pytest.mark.parametrize("given_noise", [False, True], ids=["generator", "given"])
def test_graphed_body_steps_equal_the_eager_steps(given_noise):
    """uint8 batches through the graph's body (normalized inside it)
    against the eager solver: every metric, the ring's drained values,
    the parameters, statistics and optimizer states bit-equal."""
    rng = np.random.default_rng(11)
    batches = _u8_batches(3)
    noises = [{k: torch.from_numpy(rng.standard_normal((B, SMALL["zdim"])).astype(np.float32))
               for k in NOISE_KEYS} for _ in batches]
    runs = {}
    for graph in (False, True):
        solver, state = _solver(graph)
        metrics = []
        for x, noise in zip(batches, noises):
            _, m = solver.train_step(state, x, noise if given_noise else None)
            metrics.append({k: v.clone() for k, v in m.items()})
        drained = solver.flush_writes()
        runs[graph] = (state, metrics, drained)
    (se, me, de), (sg, mg, dg) = runs[False], runs[True]
    assert sg.step == se.step == 3
    for a, b in zip(me, mg):
        assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert de == dg and [s for _, s in dg] == [1, 2, 3]
    for a, b in ((se.model.state_dict(), sg.model.state_dict()),):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for oe, og in ((se.opt_e, sg.opt_e), (se.opt_d, sg.opt_d)):
        for p, q in zip(oe.state.values(), og.state.values()):
            assert all(torch.equal(p[k], q[k]) for k in p)


def test_a_replaced_optimizer_state_drops_the_graph():
    """The signature a capture keeps changes when ``load_state_dict``
    replaces the optimizer's tensors, not when a model copies in place."""
    solver, state = _solver(True)
    x = _u8_batches(1)[0]
    solver.train_step(state, x)
    graphed = solver.graphed
    before = graphed.signature(state)
    with torch.no_grad():
        state.model.load_state_dict(state.model.state_dict())
    assert graphed.signature(state) == before
    optim.load_state_dict(state.opt_e, state.opt_e.state_dict())  # the same tensors
    assert graphed.signature(state) == before
    optim.load_state_dict(state.opt_e, copy.deepcopy(state.opt_e.state_dict()))
    assert graphed.signature(state) != before


def test_a_warm_up_step_leaves_only_the_buffers_output_and_optimizer_state():
    """A warm-up step runs the body eagerly on the current stream and keeps
    nothing it made but the static batch and noise, its output and the
    optimizer states: every tensor an operation of the call returned is
    gone once the call is, or shares storage with one of those (or is a
    parameter or buffer updated in place). The second warm-up call is the
    one checked: the first fills the caches a shape keys."""
    import gc
    import weakref

    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class Made(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.refs = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.refs.extend(weakref.ref(t) for t in tree_flatten(out)[0]
                             if isinstance(t, torch.Tensor))
            return out

    solver, state = _solver(False)
    graphed = GraphedStep(solver._step_fn, solver.noise_keys, SMALL["zdim"],
                          graph_factory=StubGraph, warmup=3)
    x = _u8_batches(1)[0]
    graphed(state, x)
    made = Made()
    with made:
        names, out = graphed(state, x)
    assert graphed.warm == 2 and graphed.captures == 0
    assert len(names) + len(graphed.phase_names) == out.numel()
    gc.collect()
    alive = [t for t in (r() for r in made.refs) if t is not None]
    # the phase stamps' static buffers are the recorder's, made once
    kept = [graphed._batch, *graphed._noise.values(), out, *state.model.parameters(),
            *state.model.buffers(), *tracing.STAMPS._buffers[CPU]]
    for opt in (state.opt_e, state.opt_d):
        kept.extend(v for s in opt.state.values() for v in s.values() if torch.is_tensor(v))
    allowed = {t.untyped_storage().data_ptr() for t in kept}
    left = [tuple(t.shape) for t in alive if t.untyped_storage().data_ptr() not in allowed]
    assert not left, f"{len(left)} tensors of the warm-up step outlive it: {left[:10]}"
    assert any(t is out for t in alive)
