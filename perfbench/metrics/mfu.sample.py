"""The serving decode's share of the card's bf16 peak (Serving decode):
the decoder-forward operations of the images delivered, counted over the
reference on the meta device (``reference/flops.py``), over the window's
seconds times 989 TFLOP/s, in %; the traced stretch is left out of
both."""

from perfbench.core.peaks import PEAK_BF16
from perfbench.reference.flops import decode_flops_per_image


def read(r):
    return 100.0 * decode_flops_per_image(r.arch) * r.image_rate() / PEAK_BF16
