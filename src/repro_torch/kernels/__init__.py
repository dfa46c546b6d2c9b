"""Hand-written Hopper kernels and their wrappers.  Importing this package
builds nothing: each CUDA source compiles at its first launch on a card,
or all together through :func:`build_all`.

``trace_card``: while True, a model traced on the ``meta`` device takes
the card's routes (the flash kernel for GQA prefill attention); only the
dry run's op count (``launch/op_count.py``) sets it, around a trace whose
kernel calls it counts instead of launching."""

trace_card = False


def build_all(force: bool = False) -> list:
    """Build every kernel library at once (one ``nvcc`` per source, run in
    parallel); returns their paths."""
    from repro_torch.kernels import approx_matmul, flash_attention, nvcc, rwkv6_scan

    return nvcc.build_many([m.build_job() for m in (approx_matmul,
                                                      flash_attention,
                                                      rwkv6_scan)], force)
