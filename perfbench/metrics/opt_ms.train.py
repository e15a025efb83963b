"""Device ms a step in the optimizer updates (Optimizer: ``torch.optim.
Adam``, capturable, through ``solvers/base.py::apply_grads``): the
program's phase stamps, from each ``optimizer.step()`` to the next phase or
the step's end, summed over the two updates; the mean over the steps
drained in the window."""

from perfbench.core.program import phase_ms


def read(r):
    return phase_ms(r, "opt")
