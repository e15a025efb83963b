"""The reduction from a profiled stretch to per-layer numbers.

The traced run's profiler keeps its events in memory (nothing is written
to disk); ``Trace.of`` reads them once: every kernel, copy and set the
device ran (``device``) and every ``record_function`` range the host
opened (``ranges``: the harness's ``perfbench::`` spans and the program's
own). The arithmetic is a frozen copy of ``intro_tc_vae_tpu_torch/
analysis/profile_step.py``'s: the device is busy in the union of its
operations' intervals, idle for the rest of the window, and a kernel is
told apart by its own name (under a CUDA graph's replay no operation on
the host encloses a launch).
"""

from __future__ import annotations

import collections
import dataclasses
import re

SPAN_PREFIX = "perfbench::"
RANGE_PREFIXES = (SPAN_PREFIX, "itcvae::")  # the harness's ranges and the program's
# hand kernels by their own symbols (csrc/*.cu)
TC_KERNEL = re.compile(r"\btc_(fwd|bwd_dz|bwd_dmu)\b")
CONV_KERNEL = re.compile(r"\bconv3x3_\w+")
# the stock conv and matrix-product libraries' kernels (cuDNN, cuBLAS and
# the CUTLASS kernels both ship); cuDNN's layout transposes are copies
LIBRARY_KERNEL = re.compile(
    r"xmma|gemm|gemv|cutlass|cudnn|convolve|fprop|dgrad|wgrad|winograd|implicit_|fft",
    re.IGNORECASE)
LAYOUT_KERNEL = re.compile(r"nchwtonhwc|nhwctonchw|transpose", re.IGNORECASE)


def is_hand(name: str) -> bool:
    return bool(TC_KERNEL.search(name) or CONV_KERNEL.search(name))


def is_library_compute(name: str) -> bool:
    """A cuDNN / cuBLAS conv or matrix-product kernel (not its transposes)."""
    return bool(LIBRARY_KERNEL.search(name)) and not LAYOUT_KERNEL.search(name)


def is_memory_bound(name: str) -> bool:
    """Neither a library conv or matrix product nor a hand kernel: the
    BatchNorm, activation, cast, copy, transpose and reduction passes."""
    return not is_hand(name) and not is_library_compute(name)


@dataclasses.dataclass
class Trace:
    """A profiled stretch: ``device`` [(name, start s, end s)] of the
    kernels, copies and sets; ``ranges`` [(name, start s, end s)] of the
    host's ranges; ``lo``..``hi`` the stretch, from its first device
    operation to its last."""

    device: list
    ranges: list
    lo: float
    hi: float

    @staticmethod
    def of(prof) -> "Trace":
        """From a stopped ``torch.profiler.profile``'s in-memory events. The
        stretch runs from the first device operation it recorded to the
        last: work queued before the profiler started is not in it."""
        device, ranges = [], []
        for e in prof.profiler.kineto_results.events():
            start = e.start_ns() * 1e-9
            end = start + e.duration_ns() * 1e-9
            name = e.name()
            annotation = e.is_user_annotation() or name.startswith(RANGE_PREFIXES)
            if str(e.device_type()).endswith("CUDA"):
                if not annotation:  # a range's shadow on the device is no work
                    device.append((name, start, end))
            elif annotation:
                ranges.append((name, start, end))
        lo = min((d[1] for d in device), default=0.0)
        hi = max((d[2] for d in device), default=0.0)
        return Trace(device=sorted(device, key=lambda d: d[1]), ranges=ranges, lo=lo, hi=hi)

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return busy(self.device, self.lo, self.hi)

    def seconds_where(self, keep) -> float:
        """Summed device seconds of the operations whose name ``keep``s."""
        return sum(b - a for name, a, b in self.device if keep(name))

    def by_name(self, top: int = 10) -> list:
        """[[name, seconds], ...] of the ``top`` operations by total time."""
        total = collections.Counter()
        for name, a, b in self.device:
            total[name] += b - a
        return [[k, v] for k, v in total.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list:
        """[[span, seconds], ...]: the device's idle time in the window, by
        the innermost host range open when each gap began, longest first."""
        spans = sorted(self.ranges, key=lambda r: (r[1], -r[2]))
        total, active, i = collections.Counter(), [], 0
        for a, b in gaps(self.device, self.lo, self.hi):  # sorted by start
            while i < len(spans) and spans[i][1] <= a:
                active.append(spans[i])
                i += 1
            active = [s for s in active if s[2] >= a]
            total[active[-1][0] if active else "(no span)"] += b - a
        return [[k, v] for k, v in total.most_common(top)]


def busy(intervals: list, lo: float, hi: float) -> float:
    """Length of the union of (name, start, end) intervals within
    [lo, hi]."""
    total, end = 0.0, None
    for _, a, b in sorted(intervals, key=lambda i: i[1]):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def gaps(intervals: list, lo: float, hi: float) -> list:
    """[(start, end)] of [lo, hi] that no interval covers."""
    out, cursor = [], lo
    for _, a, b in sorted(intervals, key=lambda i: i[1]):
        if a > cursor:
            out.append((cursor, min(a, hi)))
        cursor = max(cursor, b)
        if cursor >= hi:
            break
    if cursor < hi:
        out.append((cursor, hi))
    return [(a, b) for a, b in out if b > a]
