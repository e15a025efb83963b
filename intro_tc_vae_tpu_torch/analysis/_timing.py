"""The harnesses' timer: the median time of one call of a function.

On the card each sample is the CUDA-event time of ``inner`` back-to-back
calls, enqueued behind a device sleep of a few milliseconds, so that the
events bracket the card's time and not the host's enqueue (a wrapper of a
hand kernel takes 20-90 us of host time, more than some kernels take on
the card). ``chip_smoke.py`` times its kernels the same way. On the CPU
each sample is the host clock around ``inner`` calls.
"""

from __future__ import annotations

import time
from typing import Callable

SLEEP_CYCLES = 8_000_000  # ~4 ms of device sleep ahead of each sample


def median_ms(fn: Callable[[], object], device, reps: int = 21, inner: int = 10,
              warmup: int = 5) -> float:
    """Median over ``reps`` samples of the time of one call of ``fn``, in
    ms, after ``warmup`` calls; on ``device`` (CUDA events) or the CPU."""
    import torch

    for _ in range(warmup):
        fn()
    cuda = torch.device(device).type == "cuda"
    times = []
    if cuda:
        torch.cuda.synchronize(device)
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / inner)
        else:
            t0 = time.perf_counter()
            for _ in range(inner):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / inner)
    return sorted(times)[len(times) // 2]
