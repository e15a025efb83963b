"""The TC kernels' share of their roofline (Kernels, TC): the least time
of one step's TC work (five sites, forward and both backward kernels, at
the configuration's batch and z; ``core/peaks.py``) over the device time
of the ``tc_*`` kernels a step, in %. Nothing when the step runs no TC
kernel."""

from perfbench.core.trace import TC_KERNEL
from perfbench.reference.flops import tc_bound_s


def read(r):
    ms = r.traced_ms_per_unit(lambda name: bool(TC_KERNEL.search(name)))
    if ms is None:
        return None
    return 100.0 * tc_bound_s(r.arch, r.batch) * 1e3 / ms
