"""Host ms a step working in the loop and the ring (Loop and ring,
``solvers/base.py``): the program's ``step`` and ``ring.drain`` spans less
the parts of them blocked on the device, ``step.launch`` and
``ring.wait``, over the window less the traced stretch."""

from perfbench.core.program import host_ms_per_unit


def read(r):
    return host_ms_per_unit(r, ("step", "ring.drain"), ("step.launch", "ring.wait"))
