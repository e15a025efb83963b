"""PyTorch port: the flight recorder (``utils/tracing.py``).

On the CPU: spans nest, carry their parent and their step's or request's
unit id, and fill a bounded ring that counts what it overwrites; they open
``itcvae::`` profiler ranges only while a profiler records. The device
phase stamps of an eager ``intro_tc`` step (the CPU stamps the host clock)
give ``fwd``, ``bwd``, ``opt`` for both phases, in order, and change no
metric, history record or launch count. ``GraphedStep`` and ``GraphedEval``
over stub graphs: their spans and their ``replays``, ``eager`` and
``drops`` counters.

On the card (marker ``cuda``, skipped without one): in a captured replay of
the flagship step the stamps increase, and ``fwd + bwd + opt`` is within 5 %
of the replay's CUDA-event interval. This file imports no JAX, so it runs
there with ``python -m pytest --noconftest -q -m cuda tests/test_torch_tracing.py``.
"""

import contextlib
import os
import threading

import numpy as np
import pytest
import torch

from intro_tc_vae_tpu_torch.ops import launch_counts
from intro_tc_vae_tpu_torch.solvers.graph import GraphedEval, GraphedStep
from intro_tc_vae_tpu_torch.utils import tracing
from tests._torch_threads import one_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "configs", "intro_tc_ukiyo64.json")
SMALL = dict(arch="conv", cdim=3, zdim=8, channels=(16, 32), image_size=32)
B = 8
TWO_PHASES = ("fwd", "bwd", "opt", "fwd", "bwd", "opt")


@pytest.fixture
def rec(monkeypatch):
    """A fresh recorder in the program's place."""
    fresh = tracing.Recorder(capacity=256, phase_capacity=64)
    monkeypatch.setattr(tracing, "RECORDER", fresh)
    return fresh


def _by_name(rec) -> dict:
    out = {}
    for seq, name, start, end, parent, unit, thread in rec.spans():
        out.setdefault(name, []).append(dict(seq=seq, start=start, end=end, parent=parent,
                                             unit=unit, thread=thread))
    return out


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def test_spans_nest_with_parents_units_and_threads(rec):
    with rec.span("step", unit=7):
        with rec.span("step.fill"):
            pass
        with rec.span("step.launch"):
            with rec.span("inner"):
                pass
    with rec.span("ring.drain"):  # outside a unit: the last one that closed
        pass
    other = threading.Thread(target=lambda: rec.span("loader.make").__enter__().__exit__())
    other.start()
    other.join(timeout=30)
    assert not other.is_alive()
    got = {n: v[0] for n, v in _by_name(rec).items()}
    step = got["step"]
    assert step["parent"] == -1
    assert got["step.fill"]["parent"] == got["step.launch"]["parent"] == step["seq"]
    assert got["inner"]["parent"] == got["step.launch"]["seq"]
    assert {got[n]["unit"] for n in ("step", "step.fill", "step.launch", "inner")} == {7}
    assert got["ring.drain"]["unit"] == 7 and got["ring.drain"]["parent"] == -1
    for name in ("step.fill", "step.launch"):
        assert step["start"] <= got[name]["start"] <= got[name]["end"] <= step["end"]
    assert got["loader.make"]["thread"] != step["thread"] == threading.get_ident()
    assert got["loader.make"]["unit"] == 0 and got["loader.make"]["parent"] == -1
    assert rec.overwritten() == 0


def test_nested_units_restore_the_enclosing_one(rec):
    with rec.span("step", unit=3):
        with rec.span("eval", unit=11):
            with rec.span("eval.check"):
                pass
        with rec.span("step.push"):
            pass
    got = {n: v[0]["unit"] for n, v in _by_name(rec).items()}
    assert got == {"step": 3, "eval": 11, "eval.check": 11, "step.push": 3}


def test_the_rings_wrap_and_count_what_they_overwrote():
    with pytest.raises(ValueError, match="power of two"):
        tracing.Recorder(capacity=100)
    rec = tracing.Recorder(capacity=8, phase_capacity=4)
    for k in range(20):
        with rec.span("step", unit=k + 1):
            pass
    assert rec.overwritten() == 12
    assert [s[5] for s in rec.spans()] == list(range(13, 21))  # the newest 8, in order
    assert rec.span_ns(("step",), 0, 2**62) is None  # the ring lost part of it
    for k in range(3):
        rec.phases(k + 1, 10 + k, TWO_PHASES, (1.0, 2.0, 0.5, 1.0, 2.0, 0.5))
    assert rec.phases_overwritten() == 5
    assert rec.phase_ms("fwd", 0, 100) is None
    fresh = tracing.Recorder(capacity=8, phase_capacity=8)
    fresh.phases(1, 10, TWO_PHASES, (1.0, 2.0, 0.5, 1.5, 2.5, 0.25))
    assert fresh.phase_ms("fwd", 0, 100) == [2.5] and fresh.phase_ms("opt", 0, 100) == [0.75]
    assert fresh.phase_ms("fwd", 11, 100) == [] and fresh.span_ns(("step",), 0, 100) == (0, 0)


def test_the_profiler_mirror_opens_ranges_only_while_recording(rec, monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        opened.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with rec.span("step", unit=1), rec.span("step.launch"):
        torch.ones(4).sum()
    assert opened == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with rec.span("step", unit=2), rec.span("step.launch"):
            torch.ones(4).sum()
    assert opened == ["itcvae::step", "itcvae::step.launch"]
    names = {e.name for e in prof.events()}
    assert {"itcvae::step", "itcvae::step.launch"} <= names
    assert len(rec.spans()) == 4  # recorded either way


# ---------------------------------------------------------------------------
# device phase stamps of an eager step
# ---------------------------------------------------------------------------

def _solver(graph: bool):
    from intro_tc_vae_tpu_torch.data import Synthetic
    from intro_tc_vae_tpu_torch.models import Decoder, Encoder
    from intro_tc_vae_tpu_torch.solvers import make_optimizer, make_solver

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


def _u8_batch():
    rng = np.random.default_rng(3)
    return torch.from_numpy(rng.integers(0, 256, (B, 3, 32, 32), dtype=np.uint8))


@pytest.mark.parametrize("graph", [False, True], ids=["eager", "graph-body"])
def test_an_eager_intro_tc_step_stamps_both_phases(rec, graph):
    solver, state = _solver(graph)
    for _ in range(2):
        solver.train_step(state, _u8_batch())
    # each ring entry carries the segments, named in stamp order
    assert [e[1] for e in solver.metric_ring._entries] == [TWO_PHASES] * 2
    assert len(solver.drain_metrics()) == 2
    if graph:
        row = solver.graphed.body(state)  # one more step through the body
        segments = row[len(solver.graphed.names):]
        assert len(segments) == len(TWO_PHASES) and bool((segments >= 0).all())
    steps = {s["unit"]: s["end"] - s["start"] for s in _by_name(rec)["step"]}
    assert sorted(steps) == [1, 2]
    for name in ("fwd", "bwd", "opt"):
        assert all(ms >= 0 for ms in rec.phase_ms(name, 0, 2**62))
    for k, (fwd, bwd, opt) in enumerate(zip(*(rec.phase_ms(n, 0, 2**62)
                                                for n in ("fwd", "bwd", "opt")))):
        assert fwd > 0 and bwd > 0 and opt > 0
        assert 1e6 * (fwd + bwd + opt) <= steps[k + 1]
    assert tracing.STAMPS.names is None  # no step left open


def test_stamps_change_no_metric_history_or_launch_count(tmp_path, monkeypatch, capsys):
    """Two runs of the flagship recipe at the synthetic_small size, one
    without the stamps' columns: the same history records (timings aside)
    and launch counts. A run ends by printing the recorder's counters."""
    from intro_tc_vae_tpu_torch.config import load_config
    from intro_tc_vae_tpu_torch.train import train_soft_intro_vae

    def run(tag):
        config = load_config(FLAGSHIP, dict(
            dataset="synthetic_small", tc_impl="pallas", num_epochs=1, use_tensorboard=False,
            batch_size=8, z_dim=8, checkpoint_dir=str(tmp_path / tag / "saves"),
            log_dir=str(tmp_path / tag / "runs")))
        before = launch_counts.snapshot()
        state = train_soft_intro_vae(config, device=CPU)
        after = launch_counts.snapshot()
        counts = [{k: b[k] - a.get(k, 0) for k in b} for a, b in zip(before, after)]
        return [{k: v for k, v in r.items() if k != "seconds"} for r in state.history], counts

    with monkeypatch.context() as m:
        m.setattr(tracing, "RECORDER", tracing.Recorder())
        stamped, stamped_counts = run("stamped")
        assert len(tracing.RECORDER.phase_ms("fwd", 0, 2**62)) == len(stamped) == 8
        assert "counters: {'launches': " in capsys.readouterr().out
    with monkeypatch.context() as m:
        m.setattr(tracing, "stamp", lambda name, like: None)
        m.setattr(tracing, "close_phases", lambda like: ((), None))
        m.setattr(tracing, "RECORDER", tracing.Recorder())
        plain, plain_counts = run("plain")
        assert tracing.RECORDER.phase_ms("fwd", 0, 2**62) == []
    assert stamped == plain and stamped_counts == plain_counts


# ---------------------------------------------------------------------------
# the graphs' spans and counters, over stub graphs
# ---------------------------------------------------------------------------

class StubGraph:
    """A graph whose capture runs the body once and whose replay runs
    nothing; it takes ``GraphedEval``'s ``pool``."""

    def __init__(self, pool=None):
        self._pool = pool

    def capture(self):
        return contextlib.nullcontext()

    def replay(self):
        pass

    def pool(self):
        return self._pool if self._pool is not None else object()


def _stub_step(state, batch, noise):
    state.step += 1
    return {"loss_enc": batch.sum(), "loss_dec": noise["real"].sum()}


def _tiny_state():
    import types

    net = torch.nn.Linear(2, 2)
    return types.SimpleNamespace(
        step=0, model=net, opt_e=torch.optim.SGD(net.parameters(), lr=0.1),
        opt_d=torch.optim.SGD(net.parameters(), lr=0.1),
        generator=torch.Generator().manual_seed(0))


def test_graphed_step_spans_and_counters(rec):
    graphed = GraphedStep(_stub_step, ("real",), 2, graph_factory=StubGraph, warmup=2)
    state = _tiny_state()
    x = torch.ones(4, 2)
    for _ in range(5):  # 2 eager, the capture and its replay, 2 replays
        graphed(state, x)
    assert graphed.counters() == {"captures": 1, "replays": 3, "eager": 2,
                                  "drops": {"signature": 0, "shape": 0}}
    spans = _by_name(rec)
    assert {n: len(v) for n, v in spans.items()} == {
        "step.fill": 5, "step.eager": 2, "step.capture": 1, "step.check": 2, "step.launch": 3}
    graphed(state, torch.ones(6, 2))  # a new shape: dropped, one eager step
    assert graphed.drops == {"signature": 0, "shape": 1} and graphed.eager == 3
    graphed(state, torch.ones(6, 2))  # captured again
    state.model.weight.data = state.model.weight.data.clone()  # replaced: a new address
    graphed(state, torch.ones(6, 2))
    assert graphed.drops == {"signature": 1, "shape": 1} and graphed.captures == 3
    assert rec.counters()["GraphedStep"] == graphed.counters()


def test_graphed_eval_spans_units_and_counters(rec):
    net = torch.nn.Linear(2, 2)
    graphed = GraphedEval(lambda x: net(x), (net,), graph_factory=StubGraph)
    for n in (3, 3, 3, 4, 4, 5, 5):  # 5 evicts 3 (two graphs at most)
        graphed(torch.ones(n, 2))
    assert graphed.counters() == {"captures": 3, "replays": 4, "eager": 3,
                                  "drops": {"signature": 0, "shape": 1}}
    net.weight.data = net.weight.data.clone()
    graphed(torch.ones(5, 2))
    assert graphed.drops == {"signature": 1, "shape": 1} and graphed.eager == 4
    spans = _by_name(rec)
    assert [s["unit"] for s in spans["eval"]] == list(range(1, 9))
    assert {n: len(v) for n, v in spans.items()} == {
        "eval": 8, "eval.check": 8, "eval.eager": 4, "eval.capture": 3, "eval.copy": 1,
        "eval.launch": 4}
    for child in ("eval.check", "eval.launch"):
        parents = {s["seq"]: s["unit"] for s in spans["eval"]}
        assert all(parents[s["parent"]] == s["unit"] for s in spans[child])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_replayed_stamps_increase_and_cover_the_replay():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stamps are a kernel captured into the graph")
    from intro_tc_vae_tpu_torch import bench

    dev = torch.device("cuda", 0)
    solver, state, x = bench.build_solver("intro_tc", 64, 64, dev, graph=True, tc_impl="pallas",
                                          conv_impl="pallas", beta_kl=0.5, beta_rec=0.75,
                                          beta_neg=512.0)
    graphed = solver.graphed
    for _ in range(graphed.warmup + 3):
        solver.train_step(state, x)
    assert graphed.captures == 1 and graphed.phase_names == TWO_PHASES
    slots = tracing.STAMPS._buffers[dev][0]
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graphed.graph.replay()
        end.record()
        torch.cuda.synchronize()
        stamps = slots[:len(TWO_PHASES) + 1].tolist()
        assert all(b > a for a, b in zip(stamps, stamps[1:])), stamps
        segments = graphed._out[len(graphed.names):].tolist()
        assert segments == pytest.approx([(b - a) / 1e6 for a, b in zip(stamps, stamps[1:])],
                                         rel=1e-3, abs=2e-3)
        interval = start.elapsed_time(end)
        assert abs(sum(segments) - interval) <= 0.05 * interval, (segments, interval)
