"""Device ms a step on the stock conv route (``PallasConv3x3``'s fallback
and the plain ``Conv2d``s: the stem, the 1x1 ``conv_expand``s, the predict
conv), by kernel name over the traced stretch: the cuDNN / cuBLAS
library kernels (``is_library_compute``, which also takes the dense
layers' few products) plus cuDNN's layout transposes (``LAYOUT_KERNEL``)."""

from perfbench.core.trace import LAYOUT_KERNEL, is_library_compute


def _stock_conv(name: str) -> bool:
    return is_library_compute(name) or bool(LAYOUT_KERNEL.search(name))


def read(r):
    return r.traced_ms_per_unit(_stock_conv)
