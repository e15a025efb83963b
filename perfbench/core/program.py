"""The program's own flight recorder (``intro_tc_vae_tpu_torch/utils/
tracing.py``: spans at its layer boundaries, device phase stamps inside
the train step), read by the per-layer metric readers once the window has
closed. The program is already loaded in the run; nothing here loads it.

Host spans are read as ``Readings.span_ms_per_unit`` reads the harness's:
spans that started in the window, the traced stretch left out, over the
units of work outside it. Device phases are each drained step's ms, their
mean over the steps drained in the window. A reading is None where the
program keeps no recorder (a checkout from before it), where the recorder
overwrote records that may lie in the window, or where it holds none."""

from __future__ import annotations

import statistics
import sys
from typing import Optional

PROGRAM_TRACING = "intro_tc_vae_tpu_torch.utils.tracing"


def recorder():
    """The loaded program's recorder, or None."""
    module = sys.modules.get(PROGRAM_TRACING)
    return getattr(module, "RECORDER", None)


def _ns(seconds: float) -> int:
    return int(round(seconds * 1e9))  # perf_counter and perf_counter_ns share a clock


def host_ms_per_unit(r, plus: tuple, minus: tuple = ()) -> Optional[float]:
    """Host ms a unit of work in the program's spans ``plus``, less those
    in ``minus`` (spans inside them), over the window less the traced
    stretch; None where no ``plus`` span started there."""
    rec = recorder()
    units = r.units - r.trace_units
    if rec is None or units <= 0:
        return None
    totals = []
    for names in (plus, minus):
        ns = count = 0
        for a, b in r._outside():
            got = rec.span_ns(names, _ns(a), _ns(b))
            if got is None:
                return None
            ns, count = ns + got[0], count + got[1]
        totals.append((ns, count))
    (plus_ns, n_plus), (minus_ns, _) = totals
    if not n_plus:
        return None
    return (plus_ns - minus_ns) / 1e6 / units


def phase_ms(r, name: str) -> Optional[float]:
    """Device ms a step in the phase ``name``, the mean over the steps
    drained in the window."""
    rec = recorder()
    if rec is None:
        return None
    steps = rec.phase_ms(name, _ns(r.lo), _ns(r.hi))
    if not steps:
        return None
    return statistics.fmean(steps)
