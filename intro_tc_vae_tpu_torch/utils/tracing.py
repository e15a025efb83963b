"""The port's flight recorder: host spans at the program's layer boundaries,
device phase stamps inside the train step, and the counters beside them.

Host spans. ``span(name)`` (optionally ``unit=``) times a block on the
host clock (``time.perf_counter_ns``) into a preallocated ring of
``CAPACITY`` records: name id, start ns, end ns (before the start while
the span is open), the sequence number of the span open around it on the
same thread (its parent, -1 for none), unit id, thread. A span given ``unit`` (a train
step's count, a serving pass's call count) passes it to every span
opened inside it; a span outside any takes the unit that last closed on
its thread. When the ring wraps the oldest records are overwritten and
``overwritten()`` counts them. A span keeps nothing else: no string is
formatted and nothing grows. While a ``torch.profiler`` records, each
span also opens the range ``itcvae::<name>`` (``launch_counts.
host_range``'s rule), on the profiler's clock, so a trace puts the
device's idle gaps down to the program's innermost span.

The spans (module, what the span covers):

* ``loader.batch`` (``data/loader.py``, cache path): the index and flag
  uploads, the gather and the flip of one batch; ``loader.wait``
  (streamed paths): the consumer's wait on the prefetch queue;
  ``loader.make`` (streamed paths, the producer thread): gathering,
  pinning and queueing one batch's copy.
* ``step`` (``solvers/base.py::train_step``, unit: the step count after
  it) with ``step.fill`` (batch copy, noise draws), ``step.check`` (the
  graph's signature compare), ``step.eager`` or ``step.capture`` when one
  runs, ``step.launch`` (``graph.replay()``) and ``step.push`` (the metric
  ring's D2H copy and event), in ``solvers/graph.py::GraphedStep``.
* ``ring.drain`` (``drain_metrics``) with ``ring.wait`` (an entry's
  ``event.synchronize()``) and ``ring.read`` (its ``tolist``, the writer's
  scalars).
* ``eval`` (``GraphedEval.__call__``, unit: its call count) with
  ``eval.check`` (the signature), ``eval.copy`` (the static input copy),
  ``eval.launch`` (the replay), ``eval.capture`` or ``eval.eager``.

Device phase stamps. Inside a train step (``open_phases`` ..
``close_phases``, which ``GraphedStep.body`` and the eager path of
``train_step`` call around the step), ``stamp(name, like)`` stores the
device's clock (``%globaltimer``, a one-thread kernel of
``csrc/conv_kernels.cu``; on the CPU ``perf_counter_ns()``) into the next
slot of a small static int64 buffer; captured into the graph like any
kernel, launched eagerly in an eager step, counted by no launch counter.
``close_phases`` stamps ``end`` and turns the differences into float32 ms
on the device: segment k runs from stamp k to stamp k + 1 and takes stamp
k's name. The step stacks them after its metrics; they ride to the host in
the metric ring's pinned copy, and ``MetricRing.drain`` hands each step's
sums by name to the recorder (``phases``), keyed by the step and the host
time of the drain. Stamp sites: ``fwd`` at each phase's start
(``solvers/intro.py``, ``solvers/vae.py``), ``bwd`` before each
``torch.autograd.grad``, ``opt`` in ``solvers/base.py::apply_grads`` just
before ``optimizer.step()``.

Counters stay where they are counted (the hand kernels' launch counts,
``DeviceLoader.stats``, the graphs' ``captures``, ``replays``, ``eager``
and ``drops``); an object that keeps some calls ``watch(self)`` and
``counters()`` reads them all.

``summary()`` is what ``profile: true`` prints. The benchmark's per-layer
readers (``perfbench/metrics/``) read ``RECORDER`` after their window.
"""

from __future__ import annotations

import array
import ctypes
import itertools
import statistics
import threading
import time
import weakref
from typing import Optional

import numpy as np
import torch

from intro_tc_vae_tpu_torch.ops import cuda_build, launch_counts

# host spans kept: ~30 spans a sampling request at ~160 requests a second
# would need 4.4 minutes to wrap the ring; a 30 s window holds ~25k
CAPACITY = 1 << 17
PHASE_CAPACITY = 1 << 14  # (step, phase) sums: 5,400 steps of three phases
MAX_STAMPS = 16           # stamps a step
RANGE_PREFIX = "itcvae::"


class _Thread(threading.local):
    """A thread's state: [innermost open span's sequence number, unit,
    unit spans open, thread id]."""

    def __init__(self):
        self.state = [-1, 0, 0, threading.get_ident()]


class _Span:
    __slots__ = ("rec", "name", "unit", "seq", "parent", "prev_unit", "range")

    def __init__(self, rec: "Recorder", name: int, unit: Optional[int]):
        self.rec = rec
        self.name = name
        self.unit = unit
        self.range = None

    def __enter__(self):
        rec = self.rec
        here = rec._here.state
        seq = next(rec._next)
        i = seq & rec._mask
        self.seq = seq
        self.parent = here[0]
        here[0] = seq
        if self.unit is not None:
            self.prev_unit = here[1]
            here[1] = self.unit
            here[2] += 1
        rec._seq[i] = seq
        rec._name[i] = self.name
        rec._parent[i] = self.parent
        rec._unit[i] = here[1]
        rec._thread[i] = here[3]
        if launch_counts.profiling():
            self.range = launch_counts.host_range(rec._ranges[self.name])
            self.range.__enter__()
        rec._start[i] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t = time.perf_counter_ns()
        rec = self.rec
        here = rec._here.state
        i = self.seq & rec._mask
        if rec._seq[i] == self.seq:  # not overwritten meanwhile
            rec._end[i] = t
        if self.range is not None:
            self.range.__exit__(*exc)
        here[0] = self.parent
        if self.unit is not None:
            here[2] -= 1
            if here[2]:  # back to the enclosing unit
                here[1] = self.prev_unit
        return False


def _ring(code: str, n: int, fill=0) -> array.array:
    return array.array(code, [fill]) * n


class Recorder:
    """Host spans and device phases in two bounded rings; see the module
    docstring."""

    def __init__(self, capacity: int = CAPACITY, phase_capacity: int = PHASE_CAPACITY):
        for n in (capacity, phase_capacity):
            if n < 1 or n & (n - 1):
                raise ValueError(f"a ring's capacity is a power of two, not {n}")
        self.names: list = []  # id -> name
        self._ids: dict = {}
        self._ranges: list = []  # id -> the profiler range's name
        self.capacity, self._mask = capacity, capacity - 1
        self._next = itertools.count()
        self._seq = _ring("q", capacity, -1)
        self._name, self._parent, self._unit = (_ring("q", capacity) for _ in range(3))
        self._thread, self._start, self._end = (_ring("q", capacity) for _ in range(3))
        self._here = _Thread()
        self.phase_capacity = phase_capacity
        self._pnext = itertools.count()
        self._pseq = _ring("q", phase_capacity, -1)
        self._punit, self._pt, self._pname = (_ring("q", phase_capacity) for _ in range(3))
        self._pms = _ring("d", phase_capacity, 0.0)
        self._watched: weakref.WeakSet = weakref.WeakSet()

    def name_id(self, name: str) -> int:
        i = self._ids.get(name)
        if i is None:
            i = self._ids[name] = len(self.names)
            self.names.append(name)
            self._ranges.append(RANGE_PREFIX + name)
        return i

    def span(self, name: str, unit: Optional[int] = None) -> _Span:
        """A context manager timing its block as the span ``name``."""
        return _Span(self, self.name_id(name), unit)

    def phases(self, unit: int, t_ns: int, names: tuple, values) -> None:
        """One step's device segments (ms, named ``names``), summed by
        name, drained at host time ``t_ns``."""
        sums: dict = {}
        for name, ms in zip(names, values):
            sums[name] = sums.get(name, 0.0) + ms
        for name, ms in sums.items():
            seq = next(self._pnext)
            i = seq & (self.phase_capacity - 1)
            self._pseq[i] = seq
            self._punit[i], self._pt[i], self._pname[i] = unit, t_ns, self.name_id(name)
            self._pms[i] = ms

    def watch(self, obj) -> None:
        """Read ``obj.counters()`` in ``counters()`` while ``obj`` lives."""
        self._watched.add(obj)

    # -- reading -----------------------------------------------------------

    def _host(self) -> dict:
        """The span ring as numpy views (no copy)."""
        return {k: np.frombuffer(getattr(self, "_" + k), dtype=np.int64)
                for k in ("seq", "name", "parent", "unit", "thread", "start", "end")}

    def _phase(self) -> dict:
        out = {k: np.frombuffer(getattr(self, "_p" + k), dtype=np.int64)
               for k in ("seq", "unit", "t", "name")}
        out["ms"] = np.frombuffer(self._pms, dtype=np.float64)
        return out

    @staticmethod
    def _overwritten(seq, capacity: int) -> int:
        return max(0, int(seq.max()) + 1 - capacity)

    def overwritten(self) -> int:
        """Host spans the ring has overwritten."""
        return self._overwritten(self._host()["seq"], self.capacity)

    def phases_overwritten(self) -> int:
        return self._overwritten(self._phase()["seq"], self.phase_capacity)

    @staticmethod
    def _lost(seq, times, capacity: int, lo_ns: int) -> bool:
        """Whether a record the ring overwrote may lie at or after
        ``lo_ns``: some was overwritten (so every slot is full), and the
        oldest kept is not older."""
        if not Recorder._overwritten(seq, capacity):
            return False
        return int(times[int(np.argmin(seq))]) >= lo_ns

    def spans(self) -> list:
        """The closed spans the ring holds, oldest first: [(seq, name,
        start ns, end ns, parent seq, unit, thread)]."""
        h = self._host()
        keep = np.flatnonzero((h["seq"] >= 0) & (h["end"] >= h["start"]))
        keep = keep[np.argsort(h["seq"][keep])]
        return [(int(h["seq"][i]), self.names[h["name"][i]], int(h["start"][i]),
                 int(h["end"][i]), int(h["parent"][i]), int(h["unit"][i]),
                 int(h["thread"][i])) for i in keep]

    def span_ns(self, names, lo_ns: int, hi_ns: int) -> Optional[tuple]:
        """(ns, count) of the closed spans named one of ``names`` that
        started in [lo_ns, hi_ns); None when the ring overwrote a record
        that may lie in that stretch."""
        h = self._host()
        if self._lost(h["seq"], h["start"], self.capacity, lo_ns):
            return None
        ids = [self._ids[n] for n in names if n in self._ids]
        sel = ((h["seq"] >= 0) & (h["end"] >= h["start"]) & np.isin(h["name"], ids)
               & (h["start"] >= lo_ns) & (h["start"] < hi_ns))
        return int((h["end"][sel] - h["start"][sel]).sum()), int(sel.sum())

    def phase_ms(self, name: str, lo_ns: int, hi_ns: int) -> Optional[list]:
        """Each step's device ms in the phase ``name``, over the steps
        drained in [lo_ns, hi_ns], in step order; None when the ring
        overwrote a record that may lie there."""
        p = self._phase()
        if self._lost(p["seq"], p["t"], self.phase_capacity, lo_ns):
            return None
        sel = ((p["seq"] >= 0) & (p["name"] == self._ids.get(name, -1))
               & (p["t"] >= lo_ns) & (p["t"] <= hi_ns))
        order = np.argsort(p["unit"][sel], kind="stable")
        return [float(v) for v in p["ms"][sel][order]]

    def counters(self) -> dict:
        """Every counter the program keeps, read where it is kept: the
        hand kernels' launches, and each watched object's ``counters()``
        under its class's name (``#k`` from the second on)."""
        out = {"launches": {k: v for c in launch_counts.snapshot() for k, v in c.items() if v}}
        for obj in list(self._watched):
            key = type(obj).__name__
            k = 1
            while key in out:
                k += 1
                key = f"{type(obj).__name__}#{k}"
            out[key] = obj.counters()
        return out

    def summary(self, lo_ns: int = 0) -> dict:
        """Since ``lo_ns``: the units (steps, requests), the median over
        units of each host span's ms a unit (a span outside any unit, such
        as the loader thread's, counts alone), the median of each device
        phase's ms a step, the counters and the records overwritten."""
        per: dict = {}
        for seq, name, start, end, _, unit, _ in self.spans():
            if start >= lo_ns:
                key = (name, unit if unit else -1 - seq)
                per[key] = per.get(key, 0) + end - start
        by_name: dict = {}
        for (name, _), ns in per.items():
            by_name.setdefault(name, []).append(ns / 1e6)
        phases: dict = {}
        p = self._phase()
        for i in np.flatnonzero((p["seq"] >= 0) & (p["t"] >= lo_ns)):
            phases.setdefault(self.names[p["name"][i]], []).append(float(p["ms"][i]))
        return {"units": len({u for _, u in per if u > 0}),
                "span_ms": {n: round(statistics.median(v), 4) for n, v in sorted(by_name.items())},
                "phase_ms": {n: round(statistics.median(v), 4) for n, v in sorted(phases.items())},
                "counters": self.counters(),
                "overwritten": self.overwritten() + self.phases_overwritten()}


RECORDER = Recorder()


def span(name: str, unit: Optional[int] = None) -> _Span:
    return RECORDER.span(name, unit)


def watch(obj) -> None:
    RECORDER.watch(obj)


# ---------------------------------------------------------------------------
# device phase stamps
# ---------------------------------------------------------------------------

# phase_stamp (csrc/conv_kernels.cu): slots, i, seg (or NULL)
_STAMP_KERNEL = cuda_build.Library("conv_kernels",
                                   {"phase_stamp": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]})


class PhaseStamps:
    """The stamps of the step in progress: their names, in order, and per
    device a static int64 [MAX_STAMPS] buffer of times and a float32
    [MAX_STAMPS] buffer of segment ms."""

    def __init__(self):
        self.names: Optional[list] = None  # None: no step open
        self._buffers: dict = {}

    def _buffer(self, device: torch.device) -> tuple:
        buf = self._buffers.get(device)
        if buf is None:
            buf = self._buffers[device] = (
                torch.zeros(MAX_STAMPS, dtype=torch.int64, device=device),
                torch.zeros(MAX_STAMPS, dtype=torch.float32, device=device))
        return buf

    def open(self) -> None:
        self.names = []

    def stamp(self, name: str, like: torch.Tensor, close: bool = False):
        names = self.names
        if names is None or len(names) >= MAX_STAMPS - (0 if close else 1):
            return None  # no step open, or its stamps full but for the last
        i = len(names)
        names.append(name)
        slots, seg = self._buffer(like.device)
        if like.is_cuda:
            cuda_build.launch(_STAMP_KERNEL, "phase_stamp", slots, i, seg if close else None,
                              device=like.device)
        else:
            slots[i] = time.perf_counter_ns()
            if close:
                seg[:i] = (slots[1:i + 1] - slots[:i]).to(torch.float32) * 1e-6
        return seg[:i] if close else None

    def close(self, like: torch.Tensor) -> tuple:
        """Stamp ``end``; (segment names, float32 [n] ms) of the step, or
        ((), None) where it made no stamp."""
        if not self.names:
            self.names = None
            return (), None
        seg = self.stamp("end", like, close=True)
        names, self.names = tuple(self.names[:-1]), None
        return names, seg


STAMPS = PhaseStamps()


def open_phases() -> None:
    """A train step begins: the stamps until ``close_phases`` are its own."""
    STAMPS.open()


def stamp(name: str, like: torch.Tensor) -> None:
    """A phase ``name`` of the open step starts here, on ``like``'s device
    (nothing outside an open step)."""
    STAMPS.stamp(name, like)


def close_phases(like: torch.Tensor) -> tuple:
    """The open step ends: (segment names, float32 [n] device ms)."""
    return STAMPS.close(like)
