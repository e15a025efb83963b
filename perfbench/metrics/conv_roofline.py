"""The hand conv kernels' share of their roofline (Kernels, conv): the
least time of one step's routed 64 -> 64 3x3 conv functions (forward,
input and weight gradients, as the reference's step needs them;
``reference/flops.py``) over the device time of the ``conv3x3_*``
kernels a step, in %. Nothing when the step runs no conv kernel."""

from perfbench.core.trace import CONV_KERNEL
from perfbench.reference.flops import routed_conv_bound_s


def read(r):
    ms = r.traced_ms_per_unit(lambda name: bool(CONV_KERNEL.search(name)))
    if ms is None:
        return None
    return 100.0 * routed_conv_bound_s(r.arch, r.batch, r.precision) * 1e3 / ms
