"""The device's idle share while serving samples (Device): 1 - the union
of kernel, copy and set time over the traced stretch's wall time, in %."""


def read(r):
    return r.idle_share()
