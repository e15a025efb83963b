"""3x3 conv calls a step that the conv kernels could take by kind but
that run on the stock conv route (the stock conv route layer): the
program's counters ``conv_stock_size`` (64 -> 64 refused by its size) plus
``conv_stock_channels`` (not 64 -> 64), read from its recorder's
``counters()`` once the window has closed, over the graphed step's
``replays`` + ``eager`` calls (the counters add a capture's tally on every
replay). None where the recorder's ``launches`` hold neither counter (a
program that keeps no such counter, or one that counted none) or where
there is no graphed step."""

from perfbench.core.program import recorder

KEYS = ("conv_stock_size", "conv_stock_channels")


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
