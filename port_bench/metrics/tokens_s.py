"""Prompt tokens prefilled plus tokens generated in the window, over the
window's seconds."""

from port_bench import readers


def read(rec):
    if rec["kind"] != "lm_engine":
        return None
    return readers.served_tokens(rec) / rec["window_s"]
