"""95th percentile (nearest rank) of submit to first token over every
request whose first token came in the window; a rejected request
misses."""

from port_bench import readers


def read(rec):
    if rec["kind"] != "lm_engine":
        return None
    return readers.p95_ms(readers.ttfts(rec))
