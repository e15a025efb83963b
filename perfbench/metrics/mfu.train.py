"""The whole step's share of the card's bf16 peak (the Graphed step
layer): the operations of the steps completed in the window, counted
over the reference on the meta device (every pass forward, the gradients
the step takes and the TC term, ``reference/flops.py``), over the
window's seconds times 989 TFLOP/s, in %; the traced stretch is left
out of both."""

from perfbench.core.peaks import PEAK_BF16
from perfbench.reference.flops import step_flops_per_image


def read(r):
    return 100.0 * step_flops_per_image(r.arch, r.batch) * r.image_rate() / PEAK_BF16
