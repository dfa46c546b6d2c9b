"""95th percentile (nearest rank) of every gap between consecutive output
tokens in the window."""

from port_bench import readers


def read(rec):
    if rec["kind"] != "lm_engine":
        return None
    return readers.p95_ms(readers.itls(rec))
