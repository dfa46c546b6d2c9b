"""The port's examples (``repro_torch.examples``) against the computation
of the repo-root JAX examples (``examples/*.py``) on the CPU, each from
the JAX example's own init carried across by ``repro_torch.bridge``.

Tolerances:
- quickstart (olmo-1b-reduced, float32): the seven mean |logit err|
  values within rtol 1e-4 of the reference's (both sides sum the same
  integer products; the float32 forwards around them differ in summation
  order by a few ulps, and a mean over 4 x 32 x vocab logits carries
  that); the ``serve-default`` plan table's text equal.  (``chip_smoke.py``
  holds the card's table against the host's at 5e-3: there the float32
  forwards differ in their last bits, enough to move an activation on a
  rounding boundary to the neighbouring int8 code, and later layers carry
  the change.)
- serve_approx (qwen3-4b-reduced, 4 requests, int8 KV): every request's
  generated tokens and every reject reason equal.
- train_lm (``--small``, 5 steps, the example's schedule and AdamW): every
  loss within rtol 1e-4 of the reference's jitted ``make_train_step`` on
  the same ``lm_batch`` batches (float32 gradients in other summation
  orders, normalised by AdamW at eps 1e-8: see ``test_torch_train.py``);
  the final checkpoint is read by the reference's ``CheckpointManager``
  and holds the port's final state bit for bit.
- pareto_sweep (a width-8, depth-1 resnet at 16 x 16, 64 calibration and
  100 test images): the labels and the power column of all nine rows
  equal the reference's grid and cost model; the float accuracy and, at
  the most approximate point of each mode (``PARETO_POINTS``: the
  reference compiles a forward per pack, so its side is cut to these
  three to keep the file's time down), each accuracy loss within one test
  image; the front the reference's rule gives on the rows.
- Each example's ``main`` raises without a card unless given ``--device
  cpu``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.checkpoint.manager import _flatten
from repro.configs import get_config as jax_get_config
from repro.configs.base import EngineConfig as JaxEngineConfig
from repro.core import cost_model as jcm
from repro.core.policy import ApproxPolicy as JaxPolicy
from repro.data import SyntheticLMConfig as JaxSyntheticLMConfig
from repro.data.synthetic import lm_batch as jax_lm_batch
from repro.launch.serve import ServeConfig as JaxServeConfig
from repro.launch.serve import build_serving_params as jax_build_serving_params
from repro.launch.serve import mixed_trace as jax_mixed_trace
from repro.launch.train import TrainConfig as JaxTrainConfig
from repro.launch.train import init_train_state as jax_init_train_state
from repro.launch.train import make_train_step as jax_make_train_step
from repro.models import build_model as jax_build_model
from repro.nn import cnn as jcnn
from repro.numerics import apply_numerics as jax_apply_numerics
from repro.numerics import get_preset as jax_get_preset
from repro.numerics import paper_grid_specs as jax_grid
from repro.serving import ServingEngine as JaxEngine
from repro_torch.bridge import from_jax_cnn_params, from_jax_params
from repro_torch.checkpoint.manager import _walk
from repro_torch.configs import get_config
from repro_torch.examples import (pareto_sweep, quickstart, serve_approx,
                                  train_lm)
from repro_torch.nn import cnn as tcnn

import benchmarks.tables2_4_accuracy as r_t24

QUICKSTART_RTOL = 1e-4
#: the grid points whose accuracy the reference computes: the largest m of
#: each mode
PARETO_POINTS = ("perforated/m3", "recursive/m4", "truncated/m7")
TRAIN_RTOL = 1e-4
TRAIN_STEPS = 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's side (reduced models: torch's
    pool costs more than it saves beside the other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_llm(arch: str, **replace):
    """(jax cfg, jax api, the JAX example's init, the port's cfg, the init
    carried across)."""
    jcfg = dataclasses.replace(jax_get_config(arch), **replace)
    api = jax_build_model(jcfg)
    params = api.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(get_config(arch), **replace)
    return jcfg, api, params, tcfg, from_jax_params(
        dict(_flatten(params)[0]), tcfg)


# --- quickstart ---------------------------------------------------------------


def _jax_quickstart(jcfg, api, params, toks):
    """``examples/quickstart.py``'s table and rows."""
    ref = api.forward(params, {"tokens": toks})
    table = jax_get_preset("serve-default").resolve(params).table()
    rows = []
    for mode, m, cv in quickstart.POINTS:
        policy = JaxPolicy(mode, m, use_cv=cv)
        spec = jax_get_preset("serve-default", policy=policy)
        packed = jax_build_serving_params(params, jcfg,
                                          JaxServeConfig(spec=spec))
        logits = api.forward(packed, {"tokens": toks})
        rows.append((policy.label(), float(jnp.abs(logits - ref).mean())))
    return table, rows


def test_quickstart_equals_the_jax_example():
    jcfg, japi, jparams, tcfg, tparams = _jax_llm("olmo-1b-reduced",
                                                  compute_dtype="float32")
    assert tcfg == quickstart.quickstart_config()
    toks = jax.random.randint(jax.random.PRNGKey(1), (4, 32), 0, jcfg.vocab)
    want_table, want = _jax_quickstart(jcfg, japi, jparams, toks)
    table, got = quickstart.quickstart(
        tcfg, tparams, torch.from_numpy(np.array(toks)).long(), "cpu")
    assert table == want_table
    assert [lbl for lbl, _ in got] == [lbl for lbl, _ in want]
    np.testing.assert_allclose([e for _, e in got], [e for _, e in want],
                               rtol=QUICKSTART_RTOL)
    # the CV recovers what the approximation lost, on both sides
    errs = dict(got)
    assert errs["perforated(m=3)+cv(g=1)"] < errs["perforated(m=3)-cv"]


# --- serve_approx ---------------------------------------------------------------


def _jax_serve_approx(jcfg, params, n: int):
    """``examples/serve_approx.py``'s engine run: (requests, rejects)."""
    spec = jax_get_preset("serve-default",
                          policy=JaxPolicy("perforated", 2, use_cv=True))
    packed = jax_build_serving_params(params, jcfg, JaxServeConfig(
        spec=spec, cache_dtype="int8"))
    eng = JaxEngine(jcfg, packed, JaxEngineConfig(
        slots=4, max_len=128, prefill_chunk=32, cache_dtype="int8"),
        numerics=spec.name)
    reqs, rejected = [], []
    for i, (prompt, gen) in enumerate(jax_mixed_trace(jcfg, n, 128, 32)):
        r = eng.submit(prompt, gen)
        reqs.append(r)
        if r.state.value == "rejected":
            rejected.append((i, r.reject_reason))
    eng.run()
    return reqs, rejected


def test_serve_approx_tokens_equal_the_jax_example():
    jcfg, _, jparams, tcfg, tparams = _jax_llm("qwen3-4b-reduced")
    want, want_rej = _jax_serve_approx(jcfg, jparams, 4)
    lines = []
    res = serve_approx.serve_approx(tcfg, tparams, "cpu", requests=4,
                                    out=lines.append)
    assert res["rejected"] == want_rej
    assert len(res["finished"]) + len(want_rej) == 4
    for t, j in zip(res["requests"], want):
        assert t.state.value == j.state.value
        assert t.generated == j.generated, (t.rid, t.generated, j.generated)
    assert res["streamed"] == res["requests"][0].generated
    assert lines[0].startswith("arch=qwen3-4b-reduced  numerics=serve-default")
    assert any("(2 compiled shapes)" in ln for ln in lines)
    assert any("cpu plain path" in ln for ln in lines)


# --- train_lm -------------------------------------------------------------------


def test_train_lm_losses_and_checkpoint_equal_the_jax_example(tmp_path):
    jcfg, _, _, tcfg, _ = _jax_llm("olmo-1b-reduced")
    assert tcfg == train_lm.train_lm_config(small=True)
    seq, batch = 32, 4
    # the JAX example's step on the same batches, from its own init
    jt = JaxTrainConfig(base_lr=3e-3, warmup_steps=20,
                        total_steps=TRAIN_STEPS)
    jd = JaxSyntheticLMConfig(vocab=jcfg.vocab, seq_len=seq, batch=batch,
                              markov_states=64)
    state = jax_init_train_state(jcfg, jt, jax.random.PRNGKey(0))
    init_params = from_jax_params(dict(_flatten(state["params"])[0]), tcfg)
    step = jax.jit(jax_make_train_step(jcfg, jt))
    want = []
    for s in range(TRAIN_STEPS):
        b = jax_lm_batch(jd, s, 0, 1)
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        want.append(float(m["loss"]))

    tt, td = train_lm.example_configs(tcfg, TRAIN_STEPS, batch, seq)
    assert (tt.base_lr, tt.warmup_steps, tt.total_steps) == (
        jt.base_lr, jt.warmup_steps, jt.total_steps)
    assert td.markov_states == jd.markov_states == 64
    lines = []
    res = train_lm.train_lm(tcfg, tt, td, str(tmp_path), "cpu",
                            params=init_params, out=lines.append)
    np.testing.assert_allclose(res["losses"], want, rtol=TRAIN_RTOL)
    assert lines == [f"step    0  loss {res['losses'][0]:.4f}"]
    assert res["checkpoints"] == [TRAIN_STEPS - 1]
    # the reference reads the port's final checkpoint
    back, at = JaxCheckpointManager(str(tmp_path)).restore(state)
    assert at == TRAIN_STEPS - 1
    got = dict(_walk(res["state"]))
    flat = dict(_flatten(back)[0])
    assert set(flat) == set(got)
    for k, arr in flat.items():
        leaf = got[k]
        mine = (leaf.float().numpy() if isinstance(leaf, torch.Tensor)
                else np.asarray(leaf))
        np.testing.assert_array_equal(np.asarray(arr, np.float32)
                                      if arr.dtype != mine.dtype else arr,
                                      mine, err_msg=k)


# --- pareto_sweep -----------------------------------------------------------------


def _small_resnet_data():
    rng = np.random.default_rng(0)
    x = rng.random((164, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 10, 164).astype(np.int32)
    return x[:64], x[64:], y[64:]


def _front(points):
    """``examples/pareto_sweep.py``'s front over (power, loss, label)."""
    front = []
    for p in sorted(points):
        if not front or p[1] < front[-1][1]:
            front.append(p)
    return front


def _jax_pareto(jc, params, xcal, xte, yte):
    """``examples/pareto_sweep.py``'s sweep at ``PARETO_POINTS``: (float
    accuracy, {label: (power, loss with the CV, without it)}), and the
    labels and powers of its whole grid."""
    acc_f = r_t24._accuracy(params, jc, xte, yte)
    ranges = r_t24._calibrate(params, jc, xcal[:r_t24.N_CALIB])
    rows, grid = {}, []
    for spec_cv, spec_no in zip(jax_grid(use_cv=True),
                                jax_grid(use_cv=False)):
        mode, m = spec_cv.default.mode, spec_cv.default.m
        label, power = f"{mode}/m{m}", 1 - jcm.power_saving(mode, m, 64) / 100
        grid.append((label, power))
        if label not in PARETO_POINTS:
            continue
        accs = {}
        for cv, spec in ((True, spec_cv), (False, spec_no)):
            packed = jax_apply_numerics(params, spec.resolve(params),
                                        act_ranges=ranges)
            accs[cv] = r_t24._accuracy(packed, jc, xte, yte)
        rows[label] = (power, 100 * (acc_f - accs[True]),
                       100 * (acc_f - accs[False]))
    return acc_f, rows, grid


def test_pareto_sweep_equals_the_jax_example():
    kw = dict(family="resnet", width=8, depth=1, img_size=16,
              num_classes=10)
    jc, tc = jcnn.CNNConfig(**kw), tcnn.CNNConfig(**kw)
    jp = jcnn.init_cnn(jax.random.PRNGKey(0), jc)
    tp = from_jax_cnn_params(dict(_flatten(jp)[0]))
    xcal, xte, yte = _small_resnet_data()
    acc_f, want, grid = _jax_pareto(jc, jp, xcal, xte, yte)
    assert set(want) == set(PARETO_POINTS)
    res = pareto_sweep.pareto_sweep(
        tc, tp, torch.from_numpy(xcal), torch.from_numpy(xte),
        torch.from_numpy(yte).long(), "cpu", out=lambda *a: None)
    one_image = 100 / len(yte)
    assert abs(res["acc_float"] - acc_f) * 100 <= one_image
    assert [(r[0], r[1]) for r in res["rows"]] == grid
    for lbl, _, d_cv, d_no in res["rows"]:
        if lbl in want:
            _, w_cv, w_no = want[lbl]
            assert abs(d_cv - w_cv) <= one_image + 1e-9, lbl
            assert abs(d_no - w_no) <= one_image + 1e-9, lbl
    assert res["front"] == _front([(p, d, lbl)
                                   for lbl, p, d, _ in res["rows"]])


# --- the entry points ---------------------------------------------------------------


def _reduced_pareto(monkeypatch):
    """pareto_sweep's main at the test's size: a width-8 resnet and the
    test's images in place of resnet44 and the procedural dataset."""
    xcal, xte, yte = _small_resnet_data()
    cfg = tcnn.CNNConfig(family="resnet", width=8, depth=1, img_size=16,
                         num_classes=10)
    monkeypatch.setattr(pareto_sweep, "get_cnn", lambda name, c: cfg)
    monkeypatch.setattr(pareto_sweep, "dataset", lambda c, dev: (
        torch.from_numpy(xcal).to(dev), None, torch.from_numpy(xte).to(dev),
        torch.from_numpy(yte).long().to(dev)))

    def train(name, cfg, xtr, ytr, device):
        return tcnn.init_cnn(cfg, generator=torch.Generator(
            device=device).manual_seed(0), device=device), []

    monkeypatch.setattr(pareto_sweep, "train_cnn", train)


@pytest.mark.parametrize("name,argv", [
    ("quickstart", []),
    ("serve_approx", ["--requests", "2", "--max-len", "64", "--chunk", "16"]),
    ("train_lm", ["--small", "--steps", "2", "--batch", "2", "--seq", "16"]),
    ("pareto_sweep", []),
])
def test_main_raises_without_a_card_unless_cpu(name, argv, tmp_path,
                                               monkeypatch):
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    if name == "train_lm":
        argv = argv + ["--ckpt-dir", str(tmp_path)]
    if name == "pareto_sweep":
        _reduced_pareto(monkeypatch)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main(argv)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        mod.main(argv + ["--device", "cpu"])
    text = out.getvalue()
    assert {"quickstart": "truncated(m=6)+cv(g=1)",
            "serve_approx": "cpu plain path",
            "train_lm": "2 steps in",
            "pareto_sweep": "Pareto front"}[name] in text
