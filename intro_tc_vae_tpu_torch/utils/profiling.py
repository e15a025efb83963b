"""Profiling: a ``torch.profiler`` trace.

Counterpart of ``intro_tc_vae_tpu/utils/profiling.py``: ``profile: true``
traces the train loop's first epoch up to iteration 50, which then stops
and prints the flight recorder's summary (``utils/tracing.py``: each host
span's and device phase's median a step, the counters). The trace is
Chrome's trace-event JSON (``*.pt.trace.json``), which TensorBoard's
profiler plugin and ``chrome://tracing`` / Perfetto both open; it carries
the recorder's spans as ``itcvae::`` ranges.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time

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
