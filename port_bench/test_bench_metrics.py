"""The metric arithmetic of the benchmark on made-up records: tails over
every request, rates over the whole window, and the operation counts,
rooflines and mfu on known shapes."""

import json

import numpy as np
import pytest

from port_bench import harness, peaks, readers
from port_bench.tiny import ROOT


def read(name, rec):
    return harness.reader(ROOT, name)(rec)


def lm_rec(**kw):
    arch = json.loads((ROOT / "port_bench/configs/olmo-1b.json").read_text())[
        "arch"]
    rec = {"kind": "lm_engine", "t0": 0.0, "t1": 10.0, "window_s": 10.0,
           "setup_s": 3.0, "arch": arch, "requests": [], "calls": [],
           "steps": [], "timed": False, "trace": None, "x_bytes": 2}
    rec.update(kw)
    return rec


@pytest.mark.parametrize("q,want", [(50, 50), (95, 95), (100, 100), (1, 1)])
def test_percentile_nearest_rank(q, want):
    assert harness.percentile(range(1, 101), q) == want


def test_tails_cover_every_request_and_gap():
    # 100 requests, first tokens 1..100 ms after submit; one request late
    # in the window carries all its gaps
    reqs = [{"t_submit": 1.0, "times": [1.0 + i / 1e3], "prompt_len": 10,
             "prefilled": 10, "rejected": False} for i in range(1, 101)]
    reqs.append({"t_submit": 2.0, "times": [2.0 + 0.01 * i for i in range(1, 41)],
                 "prompt_len": 5, "prefilled": 5, "rejected": False})
    rec = lm_rec(requests=reqs)
    assert read("ttft_p95_ms", rec) == pytest.approx(95.0)
    assert read("itl_p95_ms", rec) == pytest.approx(10.0)
    # the rate is over the whole window: 101 prompts' tokens, 140 generated
    assert read("tokens_s", rec) == pytest.approx((1005 + 140) / 10.0)


def test_rejected_request_misses_and_unserved_first_token_is_left_out():
    ok = [{"t_submit": 0.0, "times": [0.05], "prompt_len": 1, "prefilled": 1,
           "rejected": False} for _ in range(10)]
    late = {"t_submit": 9.9, "times": [], "prompt_len": 1, "prefilled": 0,
            "rejected": False}
    assert read("ttft_p95_ms", lm_rec(requests=ok + [late])) == \
        pytest.approx(50.0)
    bad = ok + [{"t_submit": 0.0, "times": [], "prompt_len": 1,
                 "prefilled": 0, "rejected": True}]
    assert read("ttft_p95_ms", lm_rec(requests=bad)) is None


def test_row_fill_and_engine_host_time():
    calls = [{"shape": (4, 16), "n_valid": np.array([16, 1, 1, 0]),
              "lengths": np.array([0, 10, 20, 0]), "t0": 0.0, "t1": 0.004,
              "traced": True},
             {"shape": (4, 1), "n_valid": np.array([1, 1, 1, 1]),
              "lengths": np.array([16, 11, 21, 0]), "t0": 0.01, "t1": 0.012,
              "traced": False}]
    rec = lm_rec(calls=calls, steps=[(0.0, 0.005, 0, 1), (0.009, 0.013, 1, 2)],
                 timed=True)
    assert read("row_fill_pct.serve", rec) == pytest.approx(100 * 22 / 68)
    assert read("engine_host_ms.serve", rec) == pytest.approx(1.5)


def test_mfu_counts_useful_rows_and_visible_keys_only():
    arch = lm_rec()["arch"]
    calls = [{"shape": (2, 8), "n_valid": np.array([3, 0]),
              "lengths": np.array([5, 0]), "t0": 0, "t1": 0, "traced": True}]
    reqs = [{"t_submit": 0.0, "times": [0.5], "prompt_len": 8,
             "prefilled": 8, "rejected": False}]
    rec = lm_rec(calls=calls, requests=reqs, window_s=1.0)
    keys = 6 + 7 + 8  # positions 5, 6, 7 see 6, 7, 8 keys
    d, ff, L = arch["d_model"], arch["d_ff"], arch["n_layers"]
    lin = 3 * L * 2 * (d * 3 * d + d * d + 2 * d * ff + ff * d)
    want = (lin / 1979e12 + L * 4 * d * keys / 989e12
            + 2 * d * arch["vocab"] / 989e12)
    assert read("mfu.serve", rec) == pytest.approx(100 * want)


@pytest.mark.parametrize("m,k,ns", [(4096, 2048, [2048, 2048, 2048]),
                                    (16, 8192, [2048]),
                                    (1_024_000, 144, [16])])
def test_approx_least_time_bounds_a_perfect_kernel(m, k, ns):
    ops, nbytes = peaks.approx_group(m, k, ns, 2, 2)
    assert ops == sum(2 * m * k * n for n in ns)
    assert nbytes >= m * k * 2 + sum(k * n for n in ns)
    least = peaks.least_time(ops, nbytes, "int8")
    # a kernel at the peaks takes exactly the least time: 100%
    assert readers.roofline_pct(least, least) == pytest.approx(100.0)
    assert readers.roofline_pct(least, 2 * least) == pytest.approx(50.0)


def test_lm_roofline_reads_the_traced_calls_and_the_approx_kernels():
    arch = lm_rec()["arch"]
    call = {"shape": (16, 256), "n_valid": np.zeros(16, dtype=int),
            "lengths": None, "t0": 0, "t1": 0, "traced": True}
    least = arch["n_layers"] * sum(
        peaks.least_time(*peaks.approx_group(4096, k, ns, 2, 2), "int8")
        for k, ns in peaks.lm_layer_groups(arch))
    trace = {"busy_s": 0.5, "window_s": 1.0, "device_ops": [],
             "idle_gaps": [], "device_s_by_name": {
                 "void am_wgmma_kernel<Tile<128, 256>>": least,
                 "void prep_kernel<float>": least,
                 "void at::native::elementwise_kernel": 9.0}}
    rec = lm_rec(calls=[call, dict(call, traced=False)], trace=trace)
    assert read("approx_roofline.serve", rec) == pytest.approx(50.0)
    assert read("device_idle_pct.serve", rec) == pytest.approx(50.0)
    assert read("approx_roofline.cnn", rec) is None


def test_resnet44_counts():
    cnn = {"family": "resnet", "num_classes": 10, "width": 16, "depth": 7,
           "img_size": 32, "in_channels": 3}
    layers = peaks.resnet_layers(cnn)
    assert len(layers) == 6 * 7 + 2 + 2  # 6n + 2 layers, 2 projections
    assert layers[0] == (1024, 27, 16) and layers[-1] == (1, 64, 10)
    macs = readers.cnn_image_ops(cnn) / 2
    assert 90e6 < macs < 110e6  # ~0.1 G multiply-adds an image (He et al.)
    rec = {"kind": "cnn_eval", "images": 1000, "window_s": 1.0, "cnn": cnn,
           "batch": 1000, "traced_batches": 1, "x_bytes": 4, "trace": None}
    assert read("mfu.cnn", rec) == pytest.approx(
        100 * 1000 * 2 * macs / 1979e12)
    assert read("images_s", rec) == 1000.0
    assert read("approx_roofline.cnn", rec) is None
