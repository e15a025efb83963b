"""Device ms a step in the backward passes (Graphed step: backward
passes): the program's phase stamps, from each ``torch.autograd.grad`` to
the optimizer update (a recomputation under remat, a gradient average or
clip included), summed over the two phases; the mean over the steps
drained in the window."""

from perfbench.core.program import phase_ms


def read(r):
    return phase_ms(r, "bwd")
