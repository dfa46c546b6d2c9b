"""Device: share of the traced window in which no operation ran."""

from port_bench import readers


def read(rec):
    return readers.idle_pct(rec) if rec["kind"] == "cnn_eval" else None
