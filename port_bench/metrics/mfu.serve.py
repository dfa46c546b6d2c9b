"""Model step: the seconds at peak that the served tokens need (their
approximate products at the int8 rate, attention over the visible keys
and the head of each generated token at the bf16 rate; no padded row, no
masked key, no embedding gather) over the window's seconds."""

from port_bench import readers


def read(rec):
    if rec["kind"] != "lm_engine":
        return None
    least = readers.lm_useful_least_s(rec)
    return None if least is None else float(100.0 * least / rec["window_s"])
