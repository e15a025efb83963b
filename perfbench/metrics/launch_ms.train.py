"""Host ms a step in ``graph.replay()`` (Graphed step launch,
``solvers/graph.py``): the program's ``step.launch`` spans, over the
window less the traced stretch. Time the host is blocked there, behind a
full launch queue, is the slack a faster step has on the host."""

from perfbench.core.program import host_ms_per_unit


def read(r):
    return host_ms_per_unit(r, ("step.launch",))
