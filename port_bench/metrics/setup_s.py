"""Set-up seconds: process start to the first timed request (weights,
pack, engine or stream, warm-up; on a checkout's first run the kernel
build too)."""


def read(rec):
    return rec["setup_s"]
