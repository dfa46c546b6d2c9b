"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

One command runs one cell (a model configuration under a traffic mix)
once, on the machine it is started on:

    python3 port_bench/run.py --workload olmo-1b.docs --seed 7 \\
        --seconds 30 --trace 0

The harness is driven by data.  ``BENCHMARK.json`` at the checkout root
names the cells and metrics; the harness finds by name

  * ``port_bench/configs/<config>.json``: the sizes, the numerics, the
    source and what was cut (``reduced``, ``assumed``), the limits of the
    correctness check, and ``kind``, the cell runner
    (``port_bench/cell_<kind>.py``) that serves it;
  * ``port_bench/traffic/<mix>.json``: the parameters of a traffic mix,
    read by the one general generator (:mod:`port_bench.traffic`);
  * ``port_bench/metrics/<metric>.py``: the reader of one metric, which
    takes its value from what the run recorded, or returns None when it
    finds nothing to read.

The yardstick lives here and not in the program: the traffic, the
reduction of timestamps, counters and traces to metrics, the table of
peaks and the operation counts (:mod:`port_bench.peaks`), the plain
references (:mod:`port_bench.ref_lm`, :mod:`port_bench.ref_cnn`, over the
frozen arithmetic of :mod:`port_bench.approx_ref`) and the comparison
that decides ``correct``.  Nothing here imports ``jax``, ``jaxlib``,
``flax`` or ``repro``; the references import nothing of ``repro_torch``.
"""
