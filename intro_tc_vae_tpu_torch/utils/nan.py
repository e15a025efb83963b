"""Non-finite detection (reference utils.py:39-45, train.py:119-138).

Counterpart of ``intro_tc_vae_tpu/utils/nan.py`` and of the JAX train
loop's anomaly mode (``train.py:87-88``, ``:166-169``). There the mode is
``jax_debug_nans``; here it is ``torch.autograd.detect_anomaly()``, which
raises at the backward function that returned the first NaN and names
the forward operation that made it. ``anomaly_detection`` sets it for a
block and restores the previous mode when the block ends, however it
ends; the train loop also checks every batch's range with
``check_unit_range``.
"""

from __future__ import annotations

import contextlib

import torch


def check_non_finite_gradients(named_parameters) -> list:
    """Names of the parameters whose gradient holds non-finite values
    (``named_parameters``: (name, parameter) pairs, as
    ``module.named_parameters()`` yields them)."""
    bad = []
    for name, p in named_parameters:
        if p.grad is None:
            continue
        finite = torch.isfinite(p.grad)
        if not bool(finite.all()):
            print(f"Non-finite gradients in {name}: {int((~finite).sum())} values")
            bad.append(name)
    return bad


# Reference public API spells it 'gradints' (utils.py:39, quirk Q9).
check_non_finite_gradints = check_non_finite_gradients


@contextlib.contextmanager
def anomaly_detection(enabled: bool = True):
    """Run the block under ``torch.autograd.detect_anomaly()`` when
    ``enabled``; the previous mode is back after it."""
    if not enabled:
        yield
        return
    with torch.autograd.detect_anomaly():
        yield


def check_unit_range(batch: torch.Tensor) -> torch.Tensor:
    """Raise ValueError unless every value of ``batch`` lies in [0, 1]
    (the JAX loader's ``check_range``); returns ``batch``."""
    lo, hi = torch.aminmax(batch)
    lo, hi = float(lo), float(hi)
    if not (0.0 <= lo and hi <= 1.0):
        raise ValueError(f"batch values outside [0, 1]: min {lo!r}, max {hi!r}")
    return batch
