"""Engine: useful rows over rows computed by the model step, the sum of
``n_valid`` over the sum of slots x C of every ``decode_slots`` call in
the window (the harness's proxy of the model API records them)."""


def read(rec):
    if rec["kind"] != "lm_engine" or not rec["calls"]:
        return None
    useful = sum(int(c["n_valid"].sum()) for c in rec["calls"])
    rows = sum(c["shape"][0] * c["shape"][1] for c in rec["calls"])
    return 100.0 * useful / rows
