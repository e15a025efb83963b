"""The hand kernels' launch counters, kept true under CUDA graph replay.

Each kernel module counts in dicts of its own (``tc_cuda.LAUNCHES``,
``tc_cuda.CALLS``, ``conv_cuda.LAUNCHES``), one add where a wrapper
launches a kernel (``cuda_build.launch``) or a route is chosen, and
registers them here; ``reset`` zeroes them all. Every reader flattens the
registry by name, so a name is registered once. A captured graph runs no
wrapper when it is replayed, so ``recording()`` takes what a capture added
as the graph's ``Tally`` and puts the counters back as they were (a capture
runs nothing on the card); each replay then adds the tally
(``Tally.add``), and the counters go on meaning "launches the card ran".

A step's phases end at its optimizer updates: ``solvers/base.py::
apply_grads`` calls ``mark()`` just before each. The hooks given to
``on_mark`` run there in an eager step, and between the tally's segments
in a replay, so a caller splits the counts by phase (or reads anything
else at the updates) the same way whether the step ran eager or graphed.
A capture's marks cut its tally into segments and run no hook.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import Callable, Iterator, Optional

_COUNTERS: list = []
_HOOKS: dict = {}
_next_hook = itertools.count()
_recording: Optional[list] = None  # the snapshots of a capture in progress


def register(counts: dict) -> dict:
    """Count ``counts`` (a module's name -> count dict); returns it. A name
    another registered dict holds raises: ``snapshot``'s readers (the
    flight recorder's ``counters()``, the benchmark's) flatten by name and
    would merge the two."""
    taken = sorted({k for c in _COUNTERS for k in c}.intersection(counts))
    if taken:
        raise ValueError(f"counters {taken} are already registered")
    _COUNTERS.append(counts)
    return counts


def reset() -> None:
    """Zero every registered counter."""
    for counts in _COUNTERS:
        for k in counts:
            counts[k] = 0


def snapshot() -> list:
    return [dict(c) for c in _COUNTERS]


def _delta(before: list, after: list) -> list:
    """Per counter, the keys that rose and by how much."""
    return [{k: n - a.get(k, 0) for k, n in b.items() if n != a.get(k, 0)}
            for a, b in itertools.zip_longest(before, after, fillvalue={})]


def _run_hooks() -> None:
    for fn in list(_HOOKS.values()):
        fn()


def mark() -> None:
    """A phase of the step ends here: run the ``on_mark`` hooks, or, in a
    capture, start the tally's next segment."""
    if _recording is not None:
        _recording.append(snapshot())
    else:
        _run_hooks()


class HookHandle:
    def __init__(self, key: int):
        self._key = key

    def remove(self) -> None:
        _HOOKS.pop(self._key, None)


def on_mark(fn: Callable[[], None]) -> HookHandle:
    """Call ``fn()`` at every ``mark``, eager or replayed."""
    key = next(_next_hook)
    _HOOKS[key] = fn
    return HookHandle(key)


@dataclasses.dataclass
class Tally:
    """What one replay of a captured region launches, per counter, in
    segments cut at the capture's marks."""

    segments: list = dataclasses.field(default_factory=list)

    def add(self, times: int = 1) -> None:
        """Count ``times`` replays: each segment's launches, with the mark
        hooks run between segments, as an eager run would."""
        for _ in range(times):
            for i, segment in enumerate(self.segments):
                if i:
                    _run_hooks()
                for counts, delta in zip(_COUNTERS, segment):
                    for k, n in delta.items():
                        counts[k] = counts.get(k, 0) + n

    def launches(self) -> dict:
        """One replay's launches by name, summed over the segments."""
        total: dict = {}
        for segment in self.segments:
            for delta in segment:
                for k, n in delta.items():
                    total[k] = total.get(k, 0) + n
        return total


@contextlib.contextmanager
def recording() -> Iterator[Tally]:
    """Take what the block adds to the counters as a ``Tally`` (filled
    when the block ends) and restore the counters; the block's marks cut
    the tally and run no hook."""
    global _recording
    if _recording is not None:
        raise RuntimeError("a capture is already being recorded")
    start = snapshot()
    _recording = [start]
    tally = Tally()
    try:
        yield tally
    finally:
        marks, _recording = _recording + [snapshot()], None
        tally.segments = [_delta(a, b) for a, b in zip(marks, marks[1:])]
        for i, counts in enumerate(_COUNTERS):
            before = start[i] if i < len(start) else {}
            for k in counts:
                counts[k] = before.get(k, 0)


def profiling() -> bool:
    """Whether a ``torch.profiler`` records: the rule ``host_range`` and
    the flight recorder's spans (``utils/tracing.py``) open ranges by."""
    import torch

    return torch._C._autograd._profiler_enabled()


def host_range(name: str):
    """A ``torch.profiler`` range named ``name`` while a profiler records,
    else nothing (a range costs the host an order of magnitude more than
    the check, profiler or not). The wrappers of the hand kernels open
    ``itcvae::<wrapper>`` around a call and ``itcvae::launch:<counted
    name>`` around each launch; ``analysis/profile_step.py`` reads both."""
    if profiling():
        import torch

        return torch.profiler.record_function(name)
    return contextlib.nullcontext()
