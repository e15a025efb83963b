"""Device ms a step in the forward passes (Graphed step: forward passes,
``solvers/intro.py`` and ``models/``): the program's phase stamps, from
each phase's start to its backward, summed over the two phases; the mean
over the steps drained in the window."""

from perfbench.core.program import phase_ms


def read(r):
    return phase_ms(r, "fwd")
