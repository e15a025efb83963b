"""Host ms a step waits in ``next()`` on the loader's iterator (the Data
layer, ``data/loader.py``), over the window: the harness's
``loader_next`` spans (a new epoch's ``iter()`` included)."""


def read(r):
    return r.span_ms_per_unit("loader_next")
