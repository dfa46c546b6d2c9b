"""The port's paper benches (``repro_torch.paper``) against the reference's
``benchmarks/`` modules of the same names, on the CPU.

Table 1 and the conv-error bench at reduced sample counts (monkeypatched
in both modules: the draws are the same prefix of the same generator
sequence), Figs. 7-9 and Table 5 at full size, Fig. 10 over one synthetic
results cache that both read, and Tables 2-4 on reduced nets (width 8,
depth 1, 16 x 16 images; a residual family and shufflenet, whose
depthwise conv trains too).

Tolerances.  Rows are equal key for key, ``us_per_call`` aside.  A value
the reference rounds may differ by one unit in its last rounded place:
the moments are float64 reductions in other orders (integer error sums
exact).  Training: 20 steps from the same bridged initial weights; every
step's loss within rtol 1e-3 and every trained leaf within 1e-2 of its
largest magnitude (float32 sums in other orders, compounding through SGD
with momentum: measured 4e-4 and 3e-3 on the residual family, 2e-7 and
8e-7 on shufflenet).  Accuracies: within one image of the N_TEST test
images, on the reference-trained weights carried over by ``bridge``.
"""

import concurrent.futures
import functools
import json
import os
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import benchmarks.conv_error_validation as r_conv  # noqa: E402
import benchmarks.fig10_pareto as r_fig10  # noqa: E402
import benchmarks.fig7_9_power as r_fig79  # noqa: E402
import benchmarks.table1_error as r_table1  # noqa: E402
import benchmarks.table5_overhead as r_table5  # noqa: E402
import benchmarks.tables2_4_accuracy as r_t24  # noqa: E402
from repro.checkpoint.manager import _flatten  # noqa: E402
from repro.data import vision as jvision  # noqa: E402
from repro.nn import cnn as jcnn  # noqa: E402
from repro_torch.bridge import from_jax_cnn_params  # noqa: E402
from repro_torch.data import vision as tvision  # noqa: E402
from repro_torch.nn import cnn as tcnn  # noqa: E402
from repro_torch.paper import conv_error_validation as t_conv  # noqa: E402
from repro_torch.paper import fig7_9_power as t_fig79  # noqa: E402
from repro_torch.paper import fig10_pareto as t_fig10  # noqa: E402
from repro_torch.paper import run as t_run  # noqa: E402
from repro_torch.paper import table1_error as t_table1  # noqa: E402
from repro_torch.paper import table5_overhead as t_table5  # noqa: E402
from repro_torch.paper import tables2_4_accuracy as t_t24  # noqa: E402

#: decimal places the reference rounds each key to
PLACES = {"mu": 2, "sigma": 2, "mu_rel_err": 4, "sigma_rel_err": 4,
          "mean_no_cv": 1, "mean_cv": 3, "std_no_cv": 1, "std_cv": 2,
          "rms_improvement": 1, "eq20_var_rel_err": 4}
LOSS_RTOL, PARAM_TOL = 1e-3, 1e-2
N_TRAIN, N_TEST, N_CALIB, STEPS = 256, 200, 64, 20


def _rows_equal(got: list[dict], want: list[dict]) -> None:
    assert [r["name"] for r in got] == [r["name"] for r in want]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w), g["name"]
        for key, wv in w.items():
            if key == "us_per_call":
                continue
            gv = g[key]
            assert isinstance(gv, bool) == isinstance(wv, bool) and \
                isinstance(gv, float) == isinstance(wv, float), \
                (g["name"], key, type(gv), type(wv))
            if key in PLACES and gv != wv:
                assert abs(gv - wv) <= 1.01 * 10.0 ** -PLACES[key], \
                    (g["name"], key, gv, wv)
            else:
                assert gv == wv, (g["name"], key, gv, wv)


def test_constants_equal_the_reference():
    assert t_table1.PAPER == r_table1.PAPER
    assert t_table1.N_SAMPLES == r_table1.N_SAMPLES
    assert (t_conv.K, t_conv.N_TRIALS) == (r_conv.K, r_conv.N_TRIALS)
    assert t_fig79.N_SIZES == r_fig79.N_SIZES
    assert t_table5.CONFIGS == r_table5.CONFIGS
    assert t_table5.N_SIZES == r_table5.N_SIZES
    assert (t_t24.N_TRAIN, t_t24.N_TEST, t_t24.N_CALIB, t_t24.TRAIN_STEPS,
            t_t24.BATCH) == (r_t24.N_TRAIN, r_t24.N_TEST, r_t24.N_CALIB,
                             r_t24.TRAIN_STEPS, r_t24.BATCH)
    assert pathlib.Path(t_t24.ART_DIR) == ROOT / "artifacts" / "cnn_torch"
    assert t_t24.ART_DIR != r_t24.ART_DIR


def test_table1_rows_equal(monkeypatch):
    for mod in (r_table1, t_table1):
        monkeypatch.setattr(mod, "N_SAMPLES", 200_000)
    got = t_table1.run(device="cpu")
    _rows_equal(got, r_table1.run())
    assert len(got) == sum(len(v) for v in t_table1.PAPER.values()) == 22


def test_conv_error_rows_equal(monkeypatch):
    for mod in (r_conv, t_conv):
        monkeypatch.setattr(mod, "N_TRIALS", 4_000)
    got = t_conv.run(device="cpu")
    _rows_equal(got, r_conv.run())
    assert len(got) == 9 and all(r["mean_nullified"] for r in got)
    assert all(r["eq20_var_rel_err"] < 0.1 for r in got
               if "eq20_var_rel_err" in r)


@pytest.mark.parametrize("port,ref", [(t_fig79, r_fig79),
                                      (t_table5, r_table5)],
                         ids=["fig7_9", "table5"])
def test_cost_model_bench_rows_equal(port, ref):
    got = port.run()
    _rows_equal(got, ref.run())
    assert got


def _synthetic_cache() -> dict:
    """A results cache for two nets: resnet44 at 100 classes and vgg13 at
    10, every grid point, losses from a seeded generator (some above the
    10% the figure plots)."""
    rng = np.random.default_rng(7)
    cache = {}
    for net, c in (("resnet44", 100), ("vgg13", 10)):
        for mode, ms in t_table5.CONFIGS.items():
            for m in ms:
                key = f"tables2_4/{net}/c{c}/{mode}/m{m}"
                loss = float(np.round(rng.uniform(-0.5, 14.0), 2))
                cache[key] = {"name": key, "loss_cv_pct": loss,
                              "loss_no_cv_pct": loss + 5.0}
    return cache


@pytest.mark.parametrize("args", [(), ("vgg13", 10), ("googlenet", 10)],
                         ids=["default", "vgg13", "fallback"])
def test_fig10_rows_equal_over_one_cache(tmp_path, monkeypatch, args):
    (tmp_path / "results_cache.json").write_text(json.dumps(
        _synthetic_cache()))
    for mod in (r_t24, t_t24):
        monkeypatch.setattr(mod, "ART_DIR", str(tmp_path))
    got = t_fig10.run(*args)
    _rows_equal(got, r_fig10.run(*args))
    assert got[0]["n_points"] > 1 and got[0]["pareto_front"]
    # an empty cache: the pending row
    (tmp_path / "results_cache.json").unlink()
    _rows_equal(t_fig10.run(*args), r_fig10.run(*args))


def test_run_prints_the_reference_format_and_defaults_to_cuda(capsys):
    assert [k for k, _ in t_run.SUITES] == [
        "table1", "conv_error", "tables2_4", "fig7_9", "table5", "fig10"]
    t_run.main(["table5", "table1"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "# --- table1 (repro_torch.paper.table1_error) ---"
    rows = [line for line in out if not line.startswith("#")]
    if not torch.cuda.is_available():  # the default device is the card
        assert rows[0].startswith("table1/ERROR,,") and "CUDA" in rows[0]
        rows = rows[1:]
        for run in (t_table1.run, t_conv.run, t_t24.run):
            with pytest.raises(RuntimeError, match="CUDA"):
                run()
    want = r_table5.run()
    assert len(rows) == len(want)
    for line, w in zip(rows, want):
        name, _, derived = line.split(",", 2)
        w.pop("us_per_call")
        assert name == w.pop("name")
        assert derived == json.dumps(w, sort_keys=True, default=str)
    assert out[-1].startswith("# total ")


# --- Tables 2-4 on reduced nets --------------------------------------------

FAMILIES = {"resnet44": "resnet", "shufflenet": "shufflenet"}


def _reduced(module, cnn_mod, vision_mod, monkeypatch, art_dir):
    """Points ``module`` (either package's tables2_4) at width-8, depth-1
    nets on 16 x 16 images, the reduced sizes and ``art_dir``."""
    def get_cnn(name, classes=10):
        return cnn_mod.CNNConfig(family=FAMILIES[name], width=8, depth=1,
                                 img_size=16, num_classes=classes)

    monkeypatch.setattr(module, "get_cnn", get_cnn)
    monkeypatch.setattr(module, "VisionConfig", functools.partial(
        vision_mod.VisionConfig, img_size=16))
    for key, val in (("N_TRAIN", N_TRAIN), ("N_TEST", N_TEST),
                     ("N_CALIB", N_CALIB), ("TRAIN_STEPS", STEPS),
                     ("ART_DIR", str(art_dir))):
        monkeypatch.setattr(module, key, val)
    return get_cnn


class _LossRecorder:
    """Stands in for the reference module's ``jax``: every attribute is
    jax's, and ``value_and_grad`` also hands each step's loss to the host
    (a debug callback inside the jitted step)."""

    def __init__(self):
        self.losses = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def value_and_grad(self, fn):
        vg = jax.value_and_grad(fn)

        def step(params):
            loss, grad = vg(params)
            jax.debug.callback(lambda v: self.losses.append(float(v)), loss)
            return loss, grad

        return step


def _walk(tree, path=()):
    if isinstance(tree, torch.Tensor):
        yield "/".join(path), tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    else:
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))


@pytest.fixture
def one_torch_thread():
    """The port's side on one intra-op thread, as the other port test
    files run it: beside the suite's other worker processes torch's
    8-thread pool spends its time waiting for cores (on an 8-core host
    beside five busy processes the resnet44 case takes about three times
    as long on eight threads as on one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("net", list(FAMILIES))
def test_tables2_4_train_and_grid_vs_reference(net, tmp_path, monkeypatch,
                                               one_torch_thread):
    jget = _reduced(r_t24, jcnn, jvision, monkeypatch, tmp_path / "ref")
    tget = _reduced(t_t24, tcnn, tvision, monkeypatch, tmp_path / "port")
    jc, tc = jget(net), tget(net)
    xtr, ytr = jvision.make_vision_dataset(
        jvision.VisionConfig(img_size=16), "train", N_TRAIN)

    # 1. 20 training steps from the same initial weights
    rec = _LossRecorder()
    monkeypatch.setattr(r_t24, "jax", rec)
    jtrained = r_t24._train_cnn(net, jc, xtr, ytr)  # caches its checkpoint
    jax.effects_barrier()
    # the reference's grid on those weights (step 2) needs nothing of the
    # port: it runs in a second thread beside the port's steps (its time
    # is XLA compiling its eager operations, one thread's work; the
    # port's side runs on one thread).  The reference's forward runs its
    # jnp operations un-jitted (its jit compiles anew for each of the 18
    # packs).
    monkeypatch.setattr(r_t24, "_logits", jcnn.cnn_apply)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        ref_rows = pool.submit(r_t24.run, nets=[net], class_counts=(10,))
        init = from_jax_cnn_params(dict(_flatten(jcnn.init_cnn(
            jax.random.PRNGKey(0), jc))[0]))
        tparams, tlosses = t_t24.train_cnn(net, tc, xtr, ytr, params=init,
                                           device="cpu")
        assert len(tlosses) == len(rec.losses) == STEPS
        np.testing.assert_allclose(tlosses, rec.losses, rtol=LOSS_RTOL)
        jflat = dict(_flatten(jtrained)[0])
        got = dict(_walk(tparams))
        assert sorted(got) == sorted(jflat)
        for key, want in jflat.items():
            want = np.asarray(want)
            assert not got[key].requires_grad
            np.testing.assert_allclose(got[key].numpy(), want, rtol=0,
                                       atol=PARAM_TOL * np.abs(want).max(),
                                       err_msg=key)
        # every leaf trained, BN scale and bias and the depthwise kernel
        for key, t0 in _walk(init):
            assert not torch.equal(got[key], t0), f"{key} did not train"
        # the weights file reloads without training
        again, losses = t_t24.train_cnn(net, tc, xtr, ytr, device="cpu")
        assert losses == tlosses
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
            _walk(again), _walk(tparams)))

        # 2. the reference-trained weights in both packages: every grid
        # point, CV on and off, on backend "jnp"
        bridged = from_jax_cnn_params(jflat)
        t_t24.save_weights(t_t24.weights_path(net, tc), tc, bridged,
                           rec.losses)
        rows = t_t24.run(nets=[net], class_counts=(10,), device="cpu",
                         backend="jnp")
        want = ref_rows.result(timeout=1200)
        _accuracies_within_one_image(rows, want)
        assert len(rows) == 9

        # 3. the port's "pallas" backend (its plain version here) against
        # its "jnp" backend, on the same weights
        os.remove(os.path.join(t_t24.ART_DIR, "results_cache.json"))
        pallas = t_t24.run(nets=[net], class_counts=(10,), device="cpu")
        _accuracies_within_one_image(pallas, rows)
        # and the cached rows come back without a device
        monkeypatch.setenv("BENCH_CACHED_ONLY", "1")
        cached = t_t24.run(nets=[net], class_counts=(10,))
        assert cached[:-1] == sorted(pallas, key=lambda r: r["name"])
        assert cached[-1]["nets_completed"] == [f"{net}/c10"]
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def _accuracies_within_one_image(got, want):
    assert [r["name"] for r in got] == [r["name"] for r in want]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in ("acc_float", "acc_cv", "acc_no_cv"):
            assert abs(g[key] - w[key]) <= 1.0 / N_TEST + 1e-9, (
                g["name"], key, g[key], w[key])
        for key in ("loss_cv_pct", "loss_no_cv_pct"):
            assert abs(g[key] - w[key]) <= 200.0 / N_TEST + 0.011, (
                g["name"], key, g[key], w[key])
