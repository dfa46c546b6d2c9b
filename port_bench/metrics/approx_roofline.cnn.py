"""Kernels: the conv-shaped approximate products' least time over the
device time of the approximate-product kernels in the traced window."""

from port_bench import readers


def read(rec):
    if rec["kind"] != "cnn_eval":
        return None
    return readers.roofline_pct(readers.cnn_approx_least_s(rec),
                                readers.approx_device_s(rec))
