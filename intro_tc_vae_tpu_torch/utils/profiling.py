"""Profiling: a ``torch.profiler`` trace and a step timer.

Counterpart of ``intro_tc_vae_tpu/utils/profiling.py``: ``profile: true``
traces the train loop's first epoch up to iteration 50, which then stops
and prints ``StepTimer``'s summary. The trace is Chrome's trace-event
JSON (``*.pt.trace.json``), which TensorBoard's profiler plugin and
``chrome://tracing`` / Perfetto both open.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Optional

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str = "runs/profile", enabled: bool = True):
    """Trace the block (host operations, and the card's kernels when CUDA
    is present) into ``log_dir``."""
    if not enabled:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}."
                                     f"{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        print(f"profiler trace written to {path}")


class StepTimer:
    """Wall-clock step timing. Given a CUDA device, ``stop`` waits for the
    card first, so each time covers the step's work, not its enqueueing."""

    def __init__(self, device: Optional[torch.device] = None):
        self.times: list = []
        self._t0 = None
        self._device = device if device is not None and device.type == "cuda" else None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._device is not None:
            torch.cuda.synchronize(self._device)
        self.times.append(time.perf_counter() - self._t0)

    def summary(self) -> dict:
        """The times after the first (the warm-up), or the first alone."""
        ts = self.times[1:] or self.times
        return {
            "steps": len(ts),
            "mean_s": sum(ts) / len(ts),
            "min_s": min(ts),
            "max_s": max(ts),
        }
