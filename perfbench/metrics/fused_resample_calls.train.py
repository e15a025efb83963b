"""Stage resamples a step that the BatchNorm kernels take into their call
(the Models layer): the program's counters ``resample_pool`` (a 2x2
average pool) plus ``resample_up`` (a nearest 2x upsample), read from its
recorder's ``counters()`` once the window has closed, over the graphed
step's ``replays`` + ``eager`` calls (the counters add a capture's tally
on every replay). None where the recorder's ``launches`` hold neither
counter (a program that keeps no such counter, or one that counted none)
or where there is no graphed step."""

from perfbench.core.program import recorder

KEYS = ("resample_pool", "resample_up")


def read(r):
    rec = recorder()
    if rec is None:
        return None
    counters = rec.counters()
    launches = counters["launches"]
    graphed = counters.get("GraphedStep")
    steps = graphed["replays"] + graphed["eager"] if graphed else 0
    if not steps or not any(k in launches for k in KEYS):
        return None
    return sum(launches.get(k, 0) for k in KEYS) / steps
