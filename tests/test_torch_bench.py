"""PyTorch port: the benchmark (``intro_tc_vae_tpu_torch/bench.py``) and
the graphed eval passes (``solvers/graph.py::GraphedEval``) on the CPU,
against the JAX package's ``bench.py``.

* The recipe: the JAX bench's ``make_solver`` and ``make_optimizer`` are
  patched to record their arguments (``make_solver`` then raises, so
  nothing compiles), and so are the port's, with its ``Encoder`` and
  ``Decoder`` (nothing is allocated): ``main`` and ``infer`` build the
  same models, solver and optimizers in both, at every image size,
  solver, fuse, scan, remat, pack, tile, conv_impl and tc_impl tried, in
  fp32 (the CPU) and bf16 (JAX on a TPU, the port on the card);
  ``analysis/profile_step.py`` and ``analysis/ceiling.py`` build through
  the bench's ``build_solver``.
* The eval passes at small widths (image 32, channels (16, 32), z 16,
  batch 8), the port's weights transplanted into the JAX modules and its
  BatchNorm running statistics away from 0 / 1: the bench's eager decode
  and encode equal JAX's ``decode`` / ``encode`` (``train=False``) within
  rtol 1e-5 / atol 1e-5 (fp32), and decode_u8's bytes equal JAX's
  ``unit_f32_to_u8`` of JAX's decode except where the float lies within
  1e-5 of a level boundary k/255 (counted as tests/test_torch_sample.py
  counts them); ``make_eval_encoder`` equals JAX's jitted one on a full
  batch and on a remainder batch (same tolerance), and is graphed where
  the solver's step is (stand-in graphs from the step's factory).
* ``GraphedEval`` with stand-in graphs (a CUDA graph is captured only on a
  card; tests/test_torch_bench_cuda.py holds the real one bit-equal to
  eager there): eager warm-up, then capture, then replay; outputs equal
  eager; a replaced parameter drops the graphs, a copy in place keeps
  them; a new shape captures again, at most ``MAX_EVAL_GRAPHS`` kept, all
  in the first capture's pool; the launch tally added per replay; a
  failed capture raises and restores the launch counters.
* ``headline`` with ``main`` stubbed in both packages (the JAX bench run
  from a copy in a temporary directory, so that its rotation file lands
  there): the same configurations in the same order on the fast path,
  under the 2 % escalation, through the rotation and with ``--sweep``,
  and the same JSON line but ``vs_baseline`` and ``card``; the rotation
  file's path; an arm that raises makes the port's headline raise.
* ``main`` and ``infer`` on the CPU at small widths through the CLI:
  their JSON lines; ``--graph 1`` on the CPU raises; NaN weights raise.
* A subprocess imports the bench, runs it on the CPU and finds no jax and
  nothing of the JAX package in ``sys.modules``.
"""

import contextlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import intro_tc_vae_tpu.solvers as jsolvers
from intro_tc_vae_tpu.data import Synthetic as JSynthetic
from intro_tc_vae_tpu.models import Decoder as JDecoder
from intro_tc_vae_tpu.models import Encoder as JEncoder
from intro_tc_vae_tpu.solvers.base import decode as jdecode
from intro_tc_vae_tpu.solvers.base import encode as jencode
from intro_tc_vae_tpu.solvers.base import unit_f32_to_u8 as junit_f32_to_u8
from intro_tc_vae_tpu.utils.transplant import torch_state_dict_to_flax
import intro_tc_vae_tpu_torch.models as pmodels
import intro_tc_vae_tpu_torch.solvers as psolvers
from intro_tc_vae_tpu_torch import bench
from intro_tc_vae_tpu_torch.models import GroupedBatchNorm, conv_output_size
from intro_tc_vae_tpu_torch.ops import conv_cuda, launch_counts
from intro_tc_vae_tpu_torch.solvers.graph import MAX_EVAL_GRAPHS, GraphedEval
from tests._torch_threads import one_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
RTOL = ATOL = 1e-5
BOUNDARY = 1e-5
SMALL = dict(arch="conv", cdim=3, zdim=16, channels=(16, 32), image_size=32)
B = 8


def _load_jax_bench(path: str):
    spec = importlib.util.spec_from_file_location("jax_bench_under_test", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JBENCH = _load_jax_bench(os.path.join(REPO, "bench.py"))


# ---------------------------------------------------------------------------
# the recipe
# ---------------------------------------------------------------------------

class Built(Exception):
    """Raised by the recording make_solver: the recipe is complete."""


class Recorded:
    """A port Encoder or Decoder that records its arguments only."""

    def __init__(self, **kwargs):
        self.kwargs = kwargs

    def to(self, device):
        return self


ENCODER_FIELDS = ("arch", "cdim", "zdim", "channels", "image_size", "tile_rows",
                  "conv_impl", "remat")


def _jax_recipe(name: str, kw: dict) -> dict:
    enc, dec, ds = kw.pop("encoder"), kw.pop("decoder"), kw.pop("dataset")
    dtype = {None: torch.float32, jnp.bfloat16: torch.bfloat16}[enc.dtype]
    net = {f: getattr(enc, f) for f in ENCODER_FIELDS}
    assert {f: getattr(dec, f) for f in ENCODER_FIELDS} == net and dec.dtype == enc.dtype
    return dict(solver=name, net={**net, "channels": tuple(net["channels"]), "dtype": dtype},
                pack_predict=dec.pack_predict,
                dataset=(ds.image_size, ds.cdim, tuple(ds.factor_sizes)), **kw)


def _port_recipe(name: str, kw: dict) -> dict:
    enc, dec, ds = kw.pop("encoder"), kw.pop("decoder"), kw.pop("dataset")
    net = dict(enc.kwargs)
    net["dtype"] = net.pop("compute_dtype")
    pack = dec.kwargs.pop("pack_predict")
    assert dec.kwargs == enc.kwargs
    return dict(solver=name, net={**net, "channels": tuple(net["channels"])},
                pack_predict=pack,
                dataset=(ds.image_size, ds.cdim, tuple(ds.factor_sizes)), **kw)


@pytest.fixture
def recorders(monkeypatch, tmp_path):
    """Both packages' make_solver / make_optimizer (and the port's
    Encoder / Decoder) record; returns the two lists of recipes."""
    got = {"jax": [], "port": []}

    def solver_recorder(side, recipe):
        def make_solver(name, **kw):
            got[side].append(recipe(name, kw))
            raise Built

        return make_solver

    monkeypatch.setattr(jsolvers, "make_solver", solver_recorder("jax", _jax_recipe))
    monkeypatch.setattr(jsolvers, "make_optimizer", lambda name, lr: ("optimizer", name, lr))
    monkeypatch.setattr(psolvers, "make_solver", solver_recorder("port", _port_recipe))
    monkeypatch.setattr(psolvers, "make_optimizer", lambda name, lr: ("optimizer", name, lr))
    monkeypatch.setattr(pmodels, "Encoder", Recorded)
    monkeypatch.setattr(pmodels, "Decoder", Recorded)
    # --tb: a writer in a new temporary directory, recorded by its prefix
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    for module in ("intro_tc_vae_tpu.utils", "intro_tc_vae_tpu_torch.utils.writer"):
        monkeypatch.setattr(f"{module}.make_writer",
                            lambda log_dir: os.path.basename(log_dir).split("-")[:2])
    return got


def _precision(monkeypatch, bf16: bool) -> str:
    """The JAX bench sees a TPU and the port a card (bf16), or both the
    CPU (fp32); returns the port's device."""
    if not bf16:
        return "cpu"
    monkeypatch.setattr(jax, "devices", lambda *a: [types.SimpleNamespace(platform="tpu")])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    return "cuda"


MAIN_CASES = {
    "flagship": {},
    "128px": dict(image_size=128),
    "256px": dict(image_size=256, batch=32),
    "vae": dict(solver_name="vae"),
    "tc": dict(solver_name="tc", tc_impl="pallas"),
    "intro": dict(solver_name="intro"),
    "unpaired-b128": dict(batch=128, fuse=False),
    "scan4": dict(scan=4),
    "remat-block": dict(remat="block"),
    "remat-pass": dict(remat="pass"),
    "pack4": dict(pack=4),
    "tile16": dict(tile=16),
    "kernels": dict(tc_impl="pallas", conv_impl="pallas"),
    "hybrid": dict(conv_impl="hybrid", arch="res"),
    "tb": dict(tb=True),
}


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(MAIN_CASES))
def test_main_builds_the_jax_bench_recipe(case, bf16, recorders, monkeypatch):
    kw = MAIN_CASES[case]
    device = _precision(monkeypatch, bf16)
    with pytest.raises(Built):
        JBENCH.main(**kw)
    with pytest.raises(Built):
        bench.main(**kw, device=device)
    (want,), (got,) = recorders["jax"], recorders["port"]
    assert got.pop("graph") is bf16  # graphed on the card, eager on the CPU
    assert got == want
    assert want.get("writer") == (["itcvae", "tbbench"] if kw.get("tb") else None)
    assert want["net"]["dtype"] == (torch.bfloat16 if bf16 else torch.float32)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("kw", [{}, dict(pack=4), dict(image_size=128, batch=64)],
                         ids=["flagship", "pack4", "128px"])
def test_infer_builds_the_jax_bench_recipe(kw, bf16, recorders, monkeypatch):
    device = _precision(monkeypatch, bf16)
    with pytest.raises(Built):
        JBENCH.infer(**kw)
    with pytest.raises(Built):
        bench.infer(**kw, device=device)
    (want,), (got,) = recorders["jax"], recorders["port"]
    assert got == want and want["solver"] == "vae"


@pytest.mark.parametrize("tool", ["profile_step", "ceiling"])
def test_the_analysis_tools_build_the_bench_recipe(tool):
    """``analysis/profile_step.py`` and ``analysis/ceiling.py`` set up
    through ``bench.build_solver``: the same weights, hyperparameters and
    batch as the bench's own call."""
    from intro_tc_vae_tpu_torch.analysis import ceiling
    from intro_tc_vae_tpu_torch.analysis import profile_step as ps

    if tool == "profile_step":
        got = ps.build("intro_tc", 4, 16, "conv", 8, "fp32", "xla", "xla", False, CPU)
    else:
        got = ceiling.build("intro_tc", 16, 4, "cpu", zdim=8)
    want = bench.build_solver("intro_tc", 4, 16, CPU, zdim=8, **bench.BETAS, tc_impl="xla")
    assert got[0].hyper == want[0].hyper and got[0].encoder.channels == (8, 16)
    for a, b in zip(got[1].model.state_dict().values(), want[1].model.state_dict().values()):
        assert torch.equal(a, b)
    assert torch.equal(got[2], want[2])


# ---------------------------------------------------------------------------
# the eval passes against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[0, 4], ids=["pack0", "pack4"])
def served(request):
    """(solver, state, inputs, JAX params, JAX stats, pack): the bench's
    serving set-up at small widths, its BatchNorm running statistics drawn
    away from 0 / 1 and its predict conv scaled so that the images spread
    over [0, 1], transplanted into the JAX modules."""
    pack = request.param
    patch = pytest.MonkeyPatch()
    patch.setattr(bench, "CHANNELS", {32: SMALL["channels"]})
    patch.setattr(bench, "ZDIM", SMALL["zdim"])
    try:
        solver, state, inputs = bench.build_infer(B, 32, "conv", pack, CPU)
    finally:
        patch.undo()
    rng = np.random.default_rng(7)
    with torch.no_grad():
        for m in state.model.modules():
            if isinstance(m, GroupedBatchNorm):
                m.running_mean.copy_(torch.from_numpy(
                    rng.uniform(-0.3, 0.3, m.num_features).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, m.num_features).astype(np.float32)))
        state.model.decoder.main["predict"].weight.mul_(50.0)
    params, stats = torch_state_dict_to_flax(
        state.model.state_dict(), "conv", conv_output_size(32, SMALL["channels"]))
    return solver, state, inputs, params, stats, pack


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def test_bench_eval_passes_match_jax(served):
    _, state, inputs, params, stats, pack = served
    passes = bench.surfaces(state)
    jdec = JDecoder(**SMALL, pack_predict=pack)
    z, x = inputs["decode"], inputs["encode"]
    assert z.shape == (B, SMALL["zdim"]) and x.shape == (B, 3, 32, 32)

    want_img, _ = jdecode(jdec, params["decoder"], stats["decoder"], jnp.asarray(z.numpy()),
                          train=False)
    want_img = np.asarray(want_img)
    got_img = _nhwc(passes["decode"](z))
    np.testing.assert_allclose(got_img, want_img, rtol=RTOL, atol=ATOL)

    want_mu, _, _ = jencode(JEncoder(**SMALL), params["encoder"], stats["encoder"],
                            jnp.asarray(_nhwc(x)), train=False)
    np.testing.assert_allclose(passes["encode"](x).numpy(), np.asarray(want_mu),
                               rtol=RTOL, atol=ATOL)

    got = _nhwc(passes["decode_u8"](z))
    want = np.asarray(junit_f32_to_u8(jnp.asarray(want_img)))
    assert got.dtype == want.dtype == np.uint8
    scaled = np.clip(want_img, 0, 1) * 255
    near = np.abs(scaled - np.round(scaled)) < BOUNDARY * 255
    differ = got != want
    assert not np.any(differ & ~near), np.argwhere(differ & ~near)[:5]
    print(f"pack {pack}: {int(near.sum())} of {near.size} entries within {BOUNDARY} of a "
          f"level boundary; {int(differ.sum())} differ")
    assert differ.sum() <= near.sum() < 0.01 * near.size
    assert len(np.unique(got)) > 100  # the images spread over the levels
    assert state.model.training  # each pass gives the modules their mode back


def test_make_eval_encoder_matches_jax(served):
    solver, state, _, params, stats, _ = served
    jds = JSynthetic(image_size=32, cdim=3, sizes=bench.SIZES)
    jsolver = jsolvers.make_solver(
        "vae", dataset=jds, encoder=JEncoder(**SMALL), decoder=JDecoder(**SMALL),
        batch_size=B, optimizer_e=jsolvers.make_optimizer("adam", 2e-4),
        optimizer_d=jsolvers.make_optimizer("adam", 2e-4), beta_kl=0.5, beta_rec=0.75)
    jstate = types.SimpleNamespace(params=params, batch_stats=stats)  # all it reads
    ours, theirs = solver.make_eval_encoder(state), jsolver.make_eval_encoder(jstate)
    images = jds.get_batch(np.arange(B + 3) * 97 % len(jds))
    for batch in (images[:B], images[B:]):  # a full batch and a remainder
        (mu, logvar), (jmu, jlogvar) = ours(batch), theirs(batch)
        assert mu.dtype == np.float32 and mu.shape == (len(batch), SMALL["zdim"])
        np.testing.assert_allclose(mu, np.asarray(jmu), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(logvar, np.asarray(jlogvar), rtol=RTOL, atol=ATOL)
    # the step is eager (the CPU), so is the encoder
    assert solver.graphed is None and solver._eval_encode is None


# ---------------------------------------------------------------------------
# GraphedEval with stand-in graphs
# ---------------------------------------------------------------------------

class RerunGraph:
    """A stand-in graph: its capture runs the block (the pass, once), and
    its replay runs the pass again on the static input and copies the
    result into the outputs the capture returned, which is what a CUDA
    graph's replay does to its static outputs."""

    replays = 0

    def __init__(self, graphed, pool=None):
        self.graphed = graphed
        self.shared = pool

    def capture(self):
        return contextlib.nullcontext()

    def pool(self):
        return self.shared if self.shared is not None else ("pool of", id(self))

    def replay(self):
        RerunGraph.replays += 1
        (static, out), = [(e[2], e[3]) for e in self.graphed()._graphs.values()
                          if e[0] is self]
        new = self.graphed().fn(static)
        for o, n in zip(_tensors(out), _tensors(new)):
            o.copy_(n)


class NoReplayGraph:
    """A stand-in graph whose capture runs the block and whose replay runs
    nothing (what the launch counters then show is the tally alone)."""

    def __init__(self, pool=None):
        pass

    def capture(self):
        return contextlib.nullcontext()

    def replay(self):
        pass

    def pool(self):
        return None


class FailingGraph:
    """A stand-in graph whose capture fails when it ends."""

    def __init__(self, pool=None):
        pass

    @contextlib.contextmanager
    def capture(self):
        yield
        raise RuntimeError("capture failed")


def _tensors(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def _small_encoder():
    from intro_tc_vae_tpu_torch.solvers.base import encode

    torch.manual_seed(3)
    enc = pmodels.Encoder(**SMALL)
    return enc, lambda x: encode(enc, x, train=False)


def _rerun(fn, modules):
    holder = {}
    graphed = GraphedEval(fn, modules,
                          graph_factory=lambda pool=None: RerunGraph(lambda: holder["g"], pool))
    holder["g"] = graphed
    return graphed


def _images(n: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).random((n, 3, 32, 32), np.float32))


def test_graphed_eval_warms_up_then_captures_then_replays():
    enc, fn = _small_encoder()
    graphed = _rerun(fn, (enc,))
    RerunGraph.replays = 0
    xs = [_images(B, s) for s in range(4)]
    first = graphed(xs[0])  # eager
    assert graphed.captures == 0 and RerunGraph.replays == 0
    outs = [first]
    for i, x in enumerate(xs[1:]):
        out = graphed(x)  # the capture and a replay, then replays
        assert graphed.captures == 1 and RerunGraph.replays == i + 1
        outs.append(tuple(t.clone() for t in out))
        if i:
            assert out[0] is prev[0]  # the static outputs, overwritten by each replay
        prev = out
    for x, out in zip(xs, outs):
        want = fn(x)
        assert all(torch.equal(a, b) for a, b in zip(out, want))
    assert enc.training


def test_graphed_eval_follows_copies_in_place_and_drops_on_a_replaced_parameter():
    enc, fn = _small_encoder()
    graphed = _rerun(fn, (enc,))
    x = _images(B, 0)
    graphed(x)
    graphed(x)
    assert graphed.captures == 1
    # copies in place keep the graph: BatchNorm's running statistics move
    # in a train-mode pass, a model's load_state_dict copies its tensors
    enc.train()
    enc(_images(B, 5))
    with torch.no_grad():
        enc.load_state_dict({k: v * 1.5 if v.is_floating_point() else v
                             for k, v in enc.state_dict().items()})
    out = graphed(x)
    assert graphed.captures == 1 and all(torch.equal(a, b) for a, b in zip(out, fn(x)))
    # a replaced parameter drops every graph: eager once, then a new capture
    enc.fc.weight = torch.nn.Parameter(enc.fc.weight.detach() * 0.5)
    out = graphed(x)
    assert graphed.captures == 1 and not graphed._graphs
    assert all(torch.equal(a, b) for a, b in zip(out, fn(x)))
    graphed(x)
    assert graphed.captures == 2


def test_graphed_eval_captures_each_shape_and_keeps_at_most_max_graphs():
    enc, fn = _small_encoder()
    graphed = _rerun(fn, (enc,))
    assert MAX_EVAL_GRAPHS == 2
    for n in (B, 3):  # the metrics' batch and a remainder: eager, then captured
        graphed(_images(n, n))
        graphed(_images(n, n))
    assert graphed.captures == 2 and len(graphed._graphs) == 2
    for n in (B, 3):  # both kept: replays only
        out = graphed(_images(n, 10 + n))
        assert all(torch.equal(a, b) for a, b in zip(out, fn(_images(n, 10 + n))))
    assert graphed.captures == 2
    graphed(_images(5, 0))
    graphed(_images(5, 0))  # a third shape: the graph used longest ago (B) goes
    assert graphed.captures == 3 and len(graphed._graphs) == 2
    assert [k[0][0] for k in graphed._graphs] == [3, 5]
    graphed(_images(B, 1))  # warmed up before: captured again at once
    assert graphed.captures == 4 and [k[0][0] for k in graphed._graphs] == [5, B]
    x = _images(3, 2).to(torch.float64)  # another dtype is another graph
    enc64, fn64 = _small_encoder()
    graphed64 = _rerun(fn64, (enc64.double(),))
    graphed64(x)
    graphed64(x)
    assert graphed64.captures == 1


def test_the_graphs_of_a_graphed_eval_share_one_pool():
    enc, fn = _small_encoder()
    graphed = _rerun(fn, (enc,))

    def pools():
        return [e[0].shared for e in graphed._graphs.values()]

    def own(entry):
        return ("pool of", id(entry[0]))

    for n in (B, 3):
        graphed(_images(n, n))
        graphed(_images(n, n))
    first = next(iter(graphed._graphs.values()))
    assert pools() == [None, own(first)]  # the first capture's pool, shared by the second
    graphed(_images(5, 0))
    graphed(_images(5, 0))  # B goes; the new graph shares the kept one's pool, B's
    assert pools() == [own(first), own(first)]
    enc.fc.weight = torch.nn.Parameter(enc.fc.weight.detach() * 0.5)
    graphed(_images(3, 0))
    graphed(_images(3, 0))  # every graph dropped: the next capture gets a pool of its own
    assert pools() == [None]


@pytest.mark.parametrize("graph", [False, True], ids=["eager-step", "graphed-step"])
def test_the_eval_encoder_is_graphed_where_the_step_is(graph, monkeypatch):
    """The decision is the step's (``solver.graphed``, which the trainer's
    ``graph_step`` sets): a graphed solver encodes through a GraphedEval
    made by the step's graph factory (stand-in graphs here), bit-equal to
    the eager encoder; ``eager`` gives that reference."""
    monkeypatch.setitem(bench.CHANNELS, 32, SMALL["channels"])
    solver, state, _ = bench.build_solver("vae", B, 32, CPU, zdim=SMALL["zdim"], graph=graph,
                                          beta_kl=0.5, beta_rec=0.75)
    if graph:
        solver.graphed.graph_factory = lambda pool=None: RerunGraph(
            lambda: solver._eval_encode, pool)
    graphed, eager = solver.make_eval_encoder(state), solver.make_eval_encoder(state, eager=True)
    images = np.random.default_rng(4).random((B + 3, 32, 32, 3), dtype=np.float32)
    for _ in range(3):  # eager, the capture and a replay, then a replay, of each shape
        for batch in (images[:B], images[B:]):
            for got, want in zip(graphed(batch), eager(batch)):
                np.testing.assert_array_equal(got, want)
    if graph:
        assert solver._eval_encode.captures == 2 and len(solver._eval_encode._graphs) == 2
        assert all(isinstance(e[0], RerunGraph) for e in solver._eval_encode._graphs.values())
        kept = solver._eval_encode
        solver.make_eval_encoder(state)  # the solver keeps its graphs across calls
        assert solver._eval_encode is kept
    else:
        assert solver.graphed is None and solver._eval_encode is None


def test_graphed_eval_adds_the_capture_tally_on_every_replay():
    launch_counts.reset()

    def fn(x):
        conv_cuda.LAUNCHES["conv3x3_fwd_wgmma"] += 3
        conv_cuda.LAUNCHES["conv3x3_pack_w"] += 3
        return x * 2

    graphed = GraphedEval(fn, (), graph_factory=NoReplayGraph)
    try:
        x = torch.ones(4)
        graphed(x)  # eager: counted as it runs
        assert conv_cuda.LAUNCHES["conv3x3_fwd_wgmma"] == 3
        for replays in (1, 2, 3):  # the first call captures (counted as the tally) and replays
            graphed(x)
            assert conv_cuda.LAUNCHES["conv3x3_fwd_wgmma"] == 3 + 3 * replays
            assert conv_cuda.LAUNCHES["conv3x3_pack_w"] == 3 + 3 * replays
        (entry,) = graphed._graphs.values()
        assert entry[1].launches() == {"conv3x3_fwd_wgmma": 3, "conv3x3_pack_w": 3}
    finally:
        launch_counts.reset()


def test_a_failed_eval_capture_raises_and_restores_the_launch_counters():
    launch_counts.reset()
    calls = []

    def fn(x):
        calls.append(1)
        conv_cuda.LAUNCHES["conv3x3_fwd_wgmma"] += 7
        return x + 1

    graphed = GraphedEval(fn, (), graph_factory=FailingGraph)
    try:
        x = torch.ones(4)
        graphed(x)
        assert conv_cuda.LAUNCHES["conv3x3_fwd_wgmma"] == 7
        for _ in range(2):  # no eager fallback: every later call tries to capture and raises
            with pytest.raises(RuntimeError, match="capture failed"):
                graphed(x)
            assert conv_cuda.LAUNCHES["conv3x3_fwd_wgmma"] == 7
            assert graphed.captures == 0 and not graphed._graphs
        assert len(calls) == 3
        assert launch_counts._recording is None
    finally:
        launch_counts.reset()


# ---------------------------------------------------------------------------
# headline, with main stubbed
# ---------------------------------------------------------------------------

def _stub_rates(rates: dict, calls: list, port: bool, fail=None):
    def main(batch=64, fuse=True, emit=True, **kw):
        calls.append((batch, fuse))
        if (batch, fuse) == fail:
            raise RuntimeError(f"arm b{batch} failed")
        v = rates[(batch, fuse)]
        return {"img_s": v, "card": "stub card, 700.00 W"} if port else v

    return main


RATES_APART = {(64, True): 1000.0, (128, True): 1500.0, (256, True): 1600.0,
               (64, False): 900.0, (128, False): 1300.0, (256, False): 1700.0}
RATES_CLOSE = {**RATES_APART, (128, False): 990.0}


@pytest.fixture
def both_headlines(tmp_path, monkeypatch):
    """The JAX bench loaded from a copy in a temporary directory (its
    rotation file ``.bench_arm`` lands there) and the port's bench with
    its rotation file there too."""
    shutil.copy(os.path.join(REPO, "bench.py"), tmp_path / "bench.py")
    jbench = _load_jax_bench(str(tmp_path / "bench.py"))
    monkeypatch.setattr(bench, "ARM_FILE", str(tmp_path / ".bench_arm_torch"))
    return jbench


def _run_both(jbench, monkeypatch, capsys, rates, full_sweep=False):
    calls = {"jax": [], "port": []}
    monkeypatch.setattr(jbench, "main", _stub_rates(rates, calls["jax"], False))
    monkeypatch.setattr(bench, "main", _stub_rates(rates, calls["port"], True))
    jbench.headline(full_sweep=full_sweep)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    line = bench.headline(full_sweep=full_sweep)
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == line
    assert got.pop("card") == "stub card, 700.00 W"
    want.pop("vs_baseline")
    assert got == want
    assert calls["port"] == calls["jax"]
    return calls["port"], got


def test_headline_fast_path_and_rotation_follow_the_jax_bench(both_headlines, monkeypatch,
                                                              capsys, tmp_path):
    rest = [(128, True), (256, True), (64, False), (256, False)]
    for run in range(5):  # the rotating arm walks the four other configs, then wraps
        calls, line = _run_both(both_headlines, monkeypatch, capsys, RATES_APART)
        arm = rest[run % 4]
        assert calls[:3] == [(64, True), (128, False), arm]
        best = max([(64, True), (128, False), arm], key=RATES_APART.get)
        assert calls[3:] == [best, best]
        assert line["batch"] == best[0] and line["fuse_passes"] is best[1]
        assert line["repeats"] == [RATES_APART[best]] * 3
    assert (tmp_path / ".bench_arm").read_text() == "5"
    assert (tmp_path / ".bench_arm_torch").read_text() == "5"


def test_headline_escalates_to_the_full_sweep_within_two_percent(both_headlines, monkeypatch,
                                                                 capsys, tmp_path):
    calls, line = _run_both(both_headlines, monkeypatch, capsys, RATES_CLOSE)
    assert calls[:6] == [(64, True), (128, False), (128, True), (256, True), (64, False),
                         (256, False)]
    assert calls[6:] == [(256, False)] * 2 and line["value"] == 1700.0
    assert not os.path.exists(tmp_path / ".bench_arm_torch")  # no rotation
    calls, line = _run_both(both_headlines, monkeypatch, capsys, RATES_APART, full_sweep=True)
    assert calls == [(64, True), (128, True), (256, True), (64, False), (128, False),
                     (256, False), (256, False), (256, False)]
    assert len([k for k in line if k.startswith("b") and k[1].isdigit()]) == 6


def test_the_rotation_file_is_the_ports_own_at_the_repo_root():
    assert bench.ARM_FILE == os.path.join(REPO, ".bench_arm_torch")


def test_a_failing_arm_makes_the_headline_raise(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(bench, "ARM_FILE", str(tmp_path / ".bench_arm_torch"))
    calls = []
    monkeypatch.setattr(bench, "main", _stub_rates(RATES_APART, calls, True, fail=(128, False)))
    with pytest.raises(RuntimeError, match="b128 failed"):
        bench.headline()
    assert "images_per_sec_per_chip" not in capsys.readouterr().out


# ---------------------------------------------------------------------------
# main and infer on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(bench, "CHANNELS", {32: (8, 16)})
    monkeypatch.setattr(bench, "ZDIM", 8)


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("argv", [[], ["--scan", "2", "--tc-impl", "pallas",
                                       "--conv-impl", "pallas", "--no-fuse"]],
                         ids=["flagship-recipe", "scan-kernels-unpaired"])
def test_main_on_the_cpu_prints_its_json_line(argv, tiny, capsys):
    bench.cli(["--batch", "4", "--image-size", "32", "--iters", "2", "--device", "cpu", *argv])
    line = _last_json(capsys)
    assert set(line) == {"metric", "value", "unit", "card"}
    assert line["metric"] == "images_per_sec_per_chip" and line["unit"] == "img/s"
    assert np.isfinite(line["value"]) and line["value"] > 0 and line["card"] == "cpu"
    out = bench.main(batch=4, image_size=32, iters=2, device="cpu", emit=False)
    assert out["steps"] == bench.WARMUP + 2 and out["device_ms_per_step"] is None
    assert np.isfinite(out["last_loss_enc"])


def test_infer_on_the_cpu_prints_its_json_line(tiny, capsys):
    bench.cli(["--infer", "--batch", "4", "--image-size", "32", "--iters", "2",
               "--pack", "4", "--device", "cpu"])
    line = _last_json(capsys)
    assert line["metric"] == "inference_images_per_sec_per_chip" and line["unit"] == "img/s"
    assert line["batch"] == 4 and line["image_size"] == 32 and line["card"] == "cpu"
    assert all(np.isfinite(line[k]) and line[k] > 0 for k in ("decode", "encode", "decode_u8"))
    out = bench.infer(batch=4, image_size=32, iters=1, device="cpu")
    assert out["rows"] == {k: v for k, v in _last_json(capsys).items() if k in out["rows"]}
    assert set(out["runs"]) == set(out["inputs"]) == {"decode", "encode", "decode_u8"}
    for name, run in out["runs"].items():  # off the card, the timed runs are the eager passes
        assert torch.equal(run(out["inputs"][name]),
                           bench.surfaces(out["state"])[name](out["inputs"][name]))


@pytest.mark.parametrize("argv", [["--batch", "4"], ["--infer", "--batch", "4"]],
                         ids=["main", "infer"])
def test_graph_on_the_cpu_raises(argv, tiny):
    with pytest.raises(ValueError, match="needs the card"):
        bench.cli([*argv, "--image-size", "32", "--iters", "1", "--device", "cpu",
                   "--graph", "1"])


def test_the_card_is_the_default_device(monkeypatch, tiny):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(batch=4, image_size=32, iters=1)


def test_nan_weights_raise(tiny, monkeypatch):
    class NaNEncoder(pmodels.Encoder):
        def __init__(self, **kw):
            super().__init__(**kw)
            with torch.no_grad():
                self.fc.weight.fill_(float("nan"))

    monkeypatch.setattr(pmodels, "Encoder", NaNEncoder)
    with pytest.raises(RuntimeError, match="non-finite loss"):
        bench.main(batch=4, image_size=32, iters=1, device="cpu", emit=False)


def test_the_bench_imports_no_jax():
    code = ("import sys, json\n"
            "from intro_tc_vae_tpu_torch import bench\n"
            "bench.CHANNELS = {32: (8, 16)}\n"
            "bench.ZDIM = 8\n"
            "bench.cli(['--batch', '2', '--image-size', '32', '--iters', '1', '--device', 'cpu'])\n"
            "bench.cli(['--infer', '--batch', '2', '--image-size', '32', '--iters', '1',\n"
            "           '--device', 'cpu'])\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'intro_tc_vae_tpu' or m.startswith('intro_tc_vae_tpu.')\n"
            "       or m == 'bench']\n"
            "print(json.dumps(bad))\n")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
