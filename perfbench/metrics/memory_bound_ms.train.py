"""Device ms a step spends in kernels that are neither cuDNN / cuBLAS
conv or matrix-product kernels nor hand kernels, by kernel name (the
Models layer: BatchNorm, activations, casts, copies, transposes,
reductions), over the traced stretch."""

from perfbench.core.trace import is_memory_bound


def read(r):
    return r.traced_ms_per_unit(is_memory_bound)
