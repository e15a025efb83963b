"""The table of peaks and the least time of the hand kernels' work.

Frozen copies of ``chip_smoke.py::bound``, ``TC_OPS`` and ``tc_bounds``
and of its conv bound (``conv_bounds``), so that the benchmark's
yardstick does not move when the program's files do. Peaks are those of
one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at its 700 W
limit): a kernel's least time is the larger of the bytes it must move
over HBM's rate and its operations over the peak of their type, each
input read once and each output written once.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12, "fp64": 34e12}  # fp64 without tensor cores
PEAK_BF16 = PEAK_OPS["bf16"]


def bound_s(bytes_moved: float, ops: float, kind: str) -> float:
    """Least seconds of a kernel that moves ``bytes_moved`` and does
    ``ops`` operations of type ``kind``."""
    return max(bytes_moved / HBM_BYTES_S, ops / PEAK_OPS[kind])


# Operations of the TC kernels as the data sheet counts them (a fused
# multiply-add is two), float64: a software exp is 29, the density of a
# pair (j, i, l) 5. Per (row, bank row, latent) and per (row, bank row).
TC_EXP_OPS, TC_DENSITY_OPS = 29, 5
TC_OPS = {
    "tc_fwd": (TC_DENSITY_OPS + 1 + TC_EXP_OPS + 2, 4 + TC_EXP_OPS),
    "tc_bwd_dz": (TC_DENSITY_OPS + 1 + 2 + TC_EXP_OPS + 2 + 2 + 3, 3 + TC_EXP_OPS),
    "tc_bwd_dmu": (TC_DENSITY_OPS + 1 + 2 + TC_EXP_OPS + 2 + 2, 3 + TC_EXP_OPS),
}


def tc_bounds_s(b: int, bank: int, zdim: int) -> dict:
    """Least seconds of each TC kernel for ``b`` rows against a bank of
    ``bank``: operations at the fp64 rate; bytes: z, mu, logvar, their
    gradients, pm, qz and the two incoming gradients in float32, and the
    float64 terms [b, z, 4], psum [b, bank] and lj [b] the forward writes
    and each backward kernel reads."""
    rows, bank_rows = b * zdim * 4, bank * zdim * 4
    kept = b * zdim * 32 + b * bank * 8 + b * 8
    moved = {"tc_fwd": 2 * rows + bank_rows + kept + 2 * b * 4,
             "tc_bwd_dz": kept + bank_rows + rows + 2 * b * 4 + 2 * rows,
             "tc_bwd_dmu": kept + bank_rows + 2 * b * 4 + bank_rows}
    return {k: bound_s(moved[k], b * bank * (zdim * per_pair + per_row), "fp64")
            for k, (per_pair, per_row) in TC_OPS.items()}


def conv3x3_bound_s(shape, kind: str) -> float:
    """Least seconds of one routed 64 -> 64 3x3 conv function (forward,
    input gradient or weight gradient) on activations ``shape`` [N, 64, H,
    W] of ``kind``: 2 x 64 x 576 operations a pixel; two activations and
    the weights moved."""
    n, c, h, w = shape
    size = 2 if kind == "bf16" else 4
    act, wts = n * c * h * w * size, 64 * 64 * 9 * size
    return bound_s(2 * act + wts, 2.0 * n * h * w * 64 * 576, kind)
