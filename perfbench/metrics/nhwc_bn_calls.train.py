"""Train-mode BatchNorm calls a step that take the kernels' channels-last
(NHWC) bodies (the Models layer): the program's counter ``bn_nhwc``, read
from its recorder's ``counters()`` once the window has closed, over the
graphed step's ``replays`` + ``eager`` calls (the counter adds a capture's
tally on every replay). None where the recorder's ``launches`` hold no
such counter (a program that keeps none, or one that counted none) or
where there is no graphed step."""

from perfbench.core.program import recorder

KEY = "bn_nhwc"


def read(r):
    rec = recorder()
    if rec is None:
        return None
    counters = rec.counters()
    launches = counters["launches"]
    graphed = counters.get("GraphedStep")
    steps = graphed["replays"] + graphed["eager"] if graphed else 0
    if not steps or KEY not in launches:
        return None
    return launches[KEY] / steps
