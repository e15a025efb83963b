"""Host ms a request spends bringing its images to the host as uint8 NHWC
(Host copy: the D2H of ``sample.py::to_host_u8``, the quantisation having
run in the graph), over the window: the harness's ``copy_out`` spans."""


def read(r):
    return r.span_ms_per_unit("copy_out")
