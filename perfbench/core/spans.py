"""The harness's own spans: around each call it makes into a layer of the
program, kept in memory on the host clock, and, while a profiler records,
also as ``record_function`` ranges (``perfbench::<name>``), so that the
traced stretch sees them beside the device's operations."""

from __future__ import annotations

import contextlib
import time

from perfbench.core.trace import SPAN_PREFIX


class Spans:
    """(name, start s, end s) of every span, in the order they closed."""

    def __init__(self):
        self.records: list = []
        self.tracing = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        if self.tracing:
            import torch

            with torch.profiler.record_function(SPAN_PREFIX + name):
                yield
        else:
            yield
        self.records.append((name, t0, time.perf_counter()))

    def total(self, name: str, lo: float = float("-inf"), hi: float = float("inf")) -> float:
        """Seconds spent in spans called ``name`` that started in [lo, hi)."""
        return sum(b - a for n, a, b in self.records if n == name and lo <= a < hi)
