"""The six readers of the program's flight recorder (``core/program.py``)
on a synthetic recorder: host spans over the window less the traced
stretch, per unit of work; device phases as the mean over the steps
drained in the window; nothing where the recorder overwrote records of
the window, holds none, or is not loaded."""

import types

import pytest

from perfbench.core import program, spec
from perfbench.core.readings import Readings
from perfbench.core.spans import Spans

S = 1_000_000_000  # ns a second
LO, HI, TRACED = 100.0, 110.0, (103.0, 104.0)  # the window and its traced stretch, s
READERS = ("fwd_ms.train", "bwd_ms.train", "opt_ms.train", "launch_ms.train",
           "host_work_ms.train", "serve_host_ms.sample")


@pytest.fixture
def tracing(monkeypatch):
    """The program's tracing module with a small fresh recorder and a
    clock the test sets (``clock.now``, ns)."""
    from intro_tc_vae_tpu_torch.utils import tracing

    clock = types.SimpleNamespace(now=0)
    monkeypatch.setattr(tracing, "RECORDER", tracing.Recorder(capacity=64, phase_capacity=64))
    monkeypatch.setattr(tracing, "time", types.SimpleNamespace(perf_counter_ns=lambda: clock.now))
    monkeypatch.setattr(tracing, "clock", clock, raising=False)
    return tracing


def put(tracing, name, start_s, end_s, unit=None, inner=()):
    """A span ``name`` over [start_s, end_s], with ``inner`` spans
    (name, start_s, end_s) inside it."""
    span = tracing.span(name, unit)
    tracing.clock.now = int(start_s * S)
    span.__enter__()
    for child in inner:
        put(tracing, *child)
    tracing.clock.now = int(end_s * S)
    span.__exit__(None, None, None)


def readings(units=10, trace_units=2):
    return Readings(cell=None, arch=None, batch=64, units=units, lo=LO, hi=HI, spans=Spans(),
                    trace_units=trace_units, traced=TRACED)


def read(name, r):
    return spec.metric_reader(name)(r)


def a_train_window(tracing):
    """Steps at 100.5, 101.5, ... 109.5 s: ``step`` 0.8 s, its launch 0.6
    s; a drain at 105.2 s of 0.1 s waiting 0.04 s; the steps' phases
    drained at 105.2 s (steps 1-5) and at 111 s, after the window."""
    for k in range(10):
        t = LO + 0.5 + k
        put(tracing, "step", t, t + 0.8, unit=k + 1,
            inner=[("step.fill", t, t + 0.1), ("step.launch", t + 0.1, t + 0.7),
                   ("step.push", t + 0.7, t + 0.75)])
    put(tracing, "ring.drain", 105.2, 105.3, inner=[("ring.wait", 105.2, 105.24),
                                                    ("ring.read", 105.24, 105.3)])
    names = ("fwd", "bwd", "opt", "fwd", "bwd", "opt")
    for step in range(1, 11):
        t = 105.2 if step <= 5 else 111.0
        tracing.RECORDER.phases(step, int(t * S), names, (1.0, 2.0, 0.25, step, 3.0, 0.5))


def test_train_readers(tracing):
    a_train_window(tracing)
    r = readings()
    # steps 4 and 5 (103.5, 104.5 s) start in or after the stretch: 104.5 is
    # outside it, 103.5 inside; 9 steps counted over 8 untraced units
    assert read("launch_ms.train", r) == pytest.approx(1e3 * 0.6 * 9 / 8)
    assert read("host_work_ms.train", r) == pytest.approx(
        1e3 * ((0.8 - 0.6) * 9 + (0.1 - 0.04)) / 8)
    # steps 1-5 drained in the window: fwd 1 + step, bwd 5, opt 0.75
    assert read("fwd_ms.train", r) == pytest.approx(1.0 + 3.0)
    assert read("bwd_ms.train", r) == pytest.approx(5.0)
    assert read("opt_ms.train", r) == pytest.approx(0.75)


def test_serve_reader(tracing):
    for k in range(10):
        t = LO + 0.5 + k
        put(tracing, "eval", t, t + 0.002, unit=k + 1,
            inner=[("eval.check", t, t + 0.001), ("eval.launch", t + 0.001, t + 0.002)])
    assert read("serve_host_ms.sample", readings()) == pytest.approx(2.0 * 9 / 8)


def test_nothing_when_empty_or_not_loaded(tracing, monkeypatch):
    r = readings()
    for name in READERS:
        assert read(name, r) is None, name
    monkeypatch.setattr(program, "PROGRAM_TRACING", "no.such.module")
    a_train_window(tracing)
    for name in READERS:
        assert read(name, r) is None, name


def test_nothing_when_the_window_was_overwritten(tracing):
    a_train_window(tracing)
    r = readings()
    assert read("launch_ms.train", r) is not None
    # 64 records a ring: 60 more spans in the window overwrite its first steps
    for k in range(60):
        put(tracing, "loader.batch", 106.0 + k * 1e-3, 106.0 + k * 1e-3 + 1e-4)
    assert tracing.RECORDER.overwritten() > 0
    for name in ("launch_ms.train", "host_work_ms.train", "serve_host_ms.sample"):
        assert read(name, r) is None, name
    # the phases' own ring: 64 records, 30 of them the window's steps; 12
    # more steps drained in the window wrap it
    assert read("fwd_ms.train", r) is not None
    for step in range(11, 23):
        tracing.RECORDER.phases(step, int(106.0 * S), ("fwd", "bwd", "opt"), (1.0, 1.0, 1.0))
    assert tracing.RECORDER.phases_overwritten() == 2
    for name in ("fwd_ms.train", "bwd_ms.train", "opt_ms.train"):
        assert read(name, r) is None, name
