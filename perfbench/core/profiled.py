"""The traced run's profiler: it covers one steady stretch inside the
window, starting once ``AFTER_SHARE`` of the window has passed and lasting
until the device has done at least ``DEVICE_S`` seconds of the cell's work
(at the rate the window has run so far), and keeps its events in memory."""

from __future__ import annotations

import math
import time

import torch

from perfbench.core.trace import SPAN_PREFIX, Trace

AFTER_SHARE = 0.3  # of the window, before the stretch starts
DEVICE_S = 1.5     # seconds of the cell's work the stretch covers at least


def activities(device: torch.device) -> list:
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])


def warm_up(device: torch.device) -> None:
    """Start and stop the profiler once over a small operation, in the
    set-up, so that its own initialisation stays out of the window."""
    from torch.profiler import profile

    with profile(activities=activities(device)):
        torch.ones(8, device=device).sum().item()


class Stretch:
    """Call ``before(done, elapsed, seconds)`` before each unit of work
    (a step or a request) and ``after(done)`` after it, ``close()`` once
    the window has closed; ``trace`` then holds the stretch's ``Trace``,
    ``units`` the units of work it covered and ``t_on``..``t_off`` its
    span on the host clock. The device is drained at both ends, so the
    window's other units and seconds are the profiler's-free rest."""

    def __init__(self, spans, device: torch.device, after_share: float = AFTER_SHARE,
                 device_s: float = DEVICE_S):
        self.spans = spans
        self.device = torch.device(device)
        self.after_share = after_share
        self.device_s = device_s
        self.prof = None
        self.range = None
        self.done0 = 0
        self.needed = 0
        self.units = 0
        self.trace = None
        self.t_on = self.t_off = None  # the stretch on the host clock
        self._stopped = None

    def before(self, done: int, elapsed: float, seconds: float) -> None:
        if self.prof is not None or self._stopped is not None:
            return
        if elapsed < self.after_share * seconds or done == 0:
            return
        from torch.profiler import profile

        per_unit = elapsed / done
        self.needed = max(3, math.ceil(self.device_s / per_unit))
        self.done0 = done
        if self.device.type == "cuda":  # nothing queued before the stretch runs in it
            torch.cuda.synchronize(self.device)
        self.t_on = time.perf_counter()
        self.prof = profile(activities=activities(self.device))
        self.prof.start()
        self.spans.tracing = True
        self.range = torch.profiler.record_function(SPAN_PREFIX + "traced")
        self.range.__enter__()

    def after(self, done: int) -> None:
        if self.prof is not None and done - self.done0 >= self.needed:
            self._stop(done)

    def _stop(self, done: int) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.range.__exit__(None, None, None)
        self.spans.tracing = False
        self.prof.stop()
        self.t_off = time.perf_counter()
        self.units = done - self.done0
        self._stopped, self.prof = self.prof, None

    def close(self, done: int = None) -> None:
        """After the window: stop a stretch still open, read the events."""
        if self.prof is not None:
            self._stop(done if done is not None else self.done0 + self.needed)
        if self._stopped is not None:
            self.trace = Trace.of(self._stopped)
            self._stopped = None
