"""Kernels: the approximate products' least time (logical operations and
bytes on the rows each traced call was given) over the device time of
the approximate-product kernels in the traced window."""

from port_bench import readers


def read(rec):
    if rec["kind"] != "lm_engine":
        return None
    return readers.roofline_pct(readers.lm_approx_least_s(rec),
                                readers.approx_device_s(rec))
