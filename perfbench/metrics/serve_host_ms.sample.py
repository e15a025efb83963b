"""Host ms a request in the serving pass's call (Serving decode,
``solvers/graph.py::GraphedEval``): the program's ``eval`` spans (its
signature check, input copy and replay), over the window less the traced
stretch."""

from perfbench.core.program import host_ms_per_unit


def read(r):
    return host_ms_per_unit(r, ("eval",))
