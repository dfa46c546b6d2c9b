"""Model step: the seconds at the int8 peak that the served images'
approximate products need (2 (k k cin) cout an output pixel, and the
head) over the window's seconds."""

from port_bench import peaks, readers


def read(rec):
    if rec["kind"] != "cnn_eval":
        return None
    ops = rec["images"] * readers.cnn_image_ops(rec["cnn"])
    return 100.0 * ops / peaks.PEAK["int8"] / rec["window_s"]
