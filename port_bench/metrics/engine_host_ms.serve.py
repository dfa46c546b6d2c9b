"""Engine: mean host milliseconds of an ``engine.step()`` spent outside
the model step (admission, scheduling, postprocess).  In a ``--trace 1``
run the proxy synchronises at the end of each ``decode_slots``, so the
device's time is charged to the model step."""


def read(rec):
    if rec["kind"] != "lm_engine" or not rec["timed"]:
        return None
    calls, outside = rec["calls"], []
    for t0, t1, c0, c1 in rec["steps"]:
        if c1 > c0:
            model = sum(c["t1"] - c["t0"] for c in calls[c0:c1])
            outside.append(t1 - t0 - model)
    return 1e3 * sum(outside) / len(outside) if outside else None
