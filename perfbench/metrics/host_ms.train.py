"""Host ms a step spends in the loop's calls into the program (the Loop
and ring layer: ``solvers/base.py::train_step`` and ``drain_metrics``),
over the window: the harness's ``train_step`` and ``drain`` spans."""


def read(r):
    return r.span_ms_per_unit("train_step", "drain")
