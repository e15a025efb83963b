"""What a run hands the per-layer metric readers (``metrics/<name>.py``,
``read(r) -> float | None``): the cell, the closed window (its bounds on
the host clock and its units of work), the harness's spans and the traced
stretch (``trace``, None without ``--trace 1``). Readers divide by counts
taken over the reference (``reference/flops.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

from perfbench.core.spans import Spans
from perfbench.core.trace import Trace
from perfbench.reference.model import Arch


@dataclasses.dataclass
class Readings:
    cell: object
    arch: Arch
    batch: int            # images a unit of work (a step or a request)
    units: int            # steps or requests completed in the window
    lo: float             # the window's start and end on the host clock
    hi: float
    spans: Spans
    trace: Optional[Trace] = None
    trace_units: int = 0  # units of work the traced stretch covered
    traced: tuple = ()    # the stretch (t_on, t_off) on the host clock
    precision: str = "bf16"

    def _outside(self) -> list:
        """The host-clock parts of the window the profiler did not run in."""
        if not self.traced:
            return [(self.lo, self.hi)]
        return [(self.lo, self.traced[0]), (self.traced[1], self.hi)]

    @property
    def untraced_seconds(self) -> float:
        return sum(b - a for a, b in self._outside())

    @property
    def untraced_images(self) -> int:
        return (self.units - self.trace_units) * self.batch

    def image_rate(self) -> float:
        """Images a second over the window, the traced stretch left out
        (the device is drained at both of its ends)."""
        return self.untraced_images / self.untraced_seconds

    def span_ms_per_unit(self, *names: str) -> float:
        """Host ms a unit of work spent in the harness's spans ``names``,
        over the window, the traced stretch left out."""
        total = sum(self.spans.total(n, a, b) for n in names for a, b in self._outside())
        return 1e3 * total / (self.units - self.trace_units)

    def traced_ms_per_unit(self, keep) -> Optional[float]:
        """Device ms a unit of work in the operations whose name ``keep``s,
        over the traced stretch; None without a trace or without such
        operations."""
        if self.trace is None or not self.trace_units:
            return None
        seconds = self.trace.seconds_where(keep)
        if seconds <= 0:
            return None
        return 1e3 * seconds / self.trace_units

    def idle_share(self) -> Optional[float]:
        """1 - device busy / traced wall, in %; None without a trace."""
        if self.trace is None or self.trace.window_s <= 0 or not self.trace.device:
            return None
        return 100.0 * (1.0 - self.trace.busy_s() / self.trace.window_s)
