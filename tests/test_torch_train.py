"""The training step in the port against the JAX package: LR schedules,
AdamW with its decay mask, int8 error-feedback gradient compression, the
synthetic token stream, the chunked cross-entropy, and three steps of
``make_train_step`` on five reduced archs (float32), on weights
initialised once in JAX and carried across by repro_torch.bridge.

Tolerances: schedules rtol 1e-6; AdamW 1e-6 (the global norm sums its
leaves in another order); compressed codes equal, residuals within 1e-7;
synthetic batches equal; losses rtol 1e-5; parameters after the steps
atol 1e-5 (float32 gradients summed in different orders, through AdamW's
normalised step).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten
from repro.data.synthetic import SyntheticLMConfig as JaxDataConfig
from repro.data.synthetic import lm_batch as jax_lm_batch
from repro.launch.train import TrainConfig as JaxTrainConfig
from repro.launch.train import init_train_state as jax_init_train_state
from repro.launch.train import make_train_step as jax_make_train_step
from repro.models.lm import chunked_ce_loss as jax_chunked_ce
from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jgc
from repro.optim import schedules as jsched
from repro_torch.data.synthetic import SyntheticLMConfig, lm_batch
from repro_torch.launch.train import (TrainConfig, init_train_state,
                                      make_train_step)
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import grad_compress as tgc
from repro_torch.optim import schedules as tsched

from _torch_port import jax_side, to_np, torch_side

ARCHS = ["olmo-1b-reduced", "qwen3-4b-reduced", "rwkv6-1.6b-reduced",
         "hymba-1.5b-reduced", "deepseek-v2-lite-16b-reduced"]
STEPS = 3
#: AdamW's eps in the training-step comparison.  The two packages'
#: gradients agree to ~1e-8 absolute (float32 sums in other orders; the
#: largest elements are ~1e-2), and a step's update g / (|g| + eps)
#: normalises each element: at the default eps 1e-8 an element whose
#: gradient is itself ~1e-8 moves by anything up to lr in one package and
#: not the other.  At eps 1e-4 that noise moves a parameter by lr * 1e-4
#: at most, while the elements that carry the gradient (1e-3 to 1e-2)
#: still take normalised steps.
EPS = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's side: on these reduced models
    torch's thread pool costs more than it saves (a 64-wide matmul takes
    milliseconds with 8 threads on a shared host, microseconds with one)
    and competes with the other test workers' processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("sched", ["warmup_cosine", "constant_lr"])
def test_schedules_equal_jax(sched):
    args = (3e-4, 5, 20) if sched == "warmup_cosine" else (3e-4,)
    jfn, tfn = getattr(jsched, sched)(*args), getattr(tsched, sched)(*args)
    for step in range(0, 25):
        want, got = float(jfn(step)), float(tfn(step))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step


def _tree(seed: int):
    """A small parameter-shaped tree (norms, biases named ``b`` and
    ``bias``, 1-D leaves, stacked 2-D/3-D weights, a list node) as numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"embed": {"table": f(16, 8)},
            "blocks": {"attn_norm": {"scale": f(2, 8)},
                       "attn": {"q": {"w": f(2, 8, 8), "b": f(2, 8)}},
                       "ssm": {"a_log": f(2, 8, 4), "conv_w": f(2, 4, 8),
                               "d_skip": f(2, 8)},
                       "tm": {"ln_x_scale": f(2, 8), "bias_x": f(2, 8)}},
            "dense_blocks": [{"mlp": {"up": {"w": f(8, 8)}}}],
            "final_norm": {"scale": f(8)}, "vec": f(8)}


def _to_torch(tree):
    return tadamw.tree_map(lambda _, a: torch.from_numpy(a.copy()), tree)


def _flat_port(tree) -> dict:
    out = {}
    tadamw.tree_map(lambda path, t: out.__setitem__(path, to_np(t)), tree)
    return out


def test_adamw_update_and_decay_mask_equal_jax():
    """Three updates of a tree with norms, biases and 1-D leaves (one
    with a gradient large enough to clip), and the decay mask path by
    path: ``a_log`` and ``conv_w`` (2-D a layer) decay, norms, scales,
    ``bias`` and 1-D leaves do not, a stacked ``b`` does (its path holds
    none of the mask's words, in both packages)."""
    params = _tree(0)
    cfg_j = jadamw.AdamWConfig(weight_decay=0.1, clip_norm=1.0)
    cfg_t = tadamw.AdamWConfig(weight_decay=0.1, clip_norm=1.0)
    jp = jax.tree.map(jnp.asarray, params)
    tp = _to_torch(params)
    js, ts = jadamw.adamw_init(jp, cfg_j), tadamw.adamw_init(tp, cfg_t)
    for i in range(3):
        grads = _tree(10 + i)
        grads["vec"] *= 50.0  # global norm far above clip_norm
        jp, js = jadamw.adamw_update(jp, jax.tree.map(jnp.asarray, grads),
                                     js, cfg_j, 1e-2)
        tp, ts = tadamw.adamw_update(tp, _to_torch(grads), ts, cfg_t, 1e-2)
    want = dict(_flatten(jp)[0])
    got = _flat_port(tp)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    jmask = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path): jadamw._decay_mask(path, leaf)
             for path, leaf in flat}
    tmask = {}
    tadamw.tree_map(lambda path, t: tmask.__setitem__(
        path, tadamw._decay_mask(path, t)), tp)
    assert tmask == jmask
    assert tmask["blocks/ssm/a_log"] and tmask["blocks/ssm/conv_w"]
    assert tmask["blocks/attn/q/b"] and not tmask["blocks/tm/bias_x"]
    assert not tmask["blocks/attn_norm/scale"] and not tmask["vec"]
    assert int(ts["step"]) == int(js["step"]) == 3


def test_compress_decompress_equal_jax():
    """Codes (the dequantized values over the scale) equal, residuals
    within 1e-7, over three steps of error feedback, ties included."""
    rng = np.random.default_rng(3)
    shapes = {"a": (64,), "b": (8, 16), "c": (3, 4, 5)}
    js = jgc.compressor_init({k: jnp.zeros(s) for k, s in shapes.items()})
    ts = tgc.compressor_init({k: torch.zeros(s) for k, s in shapes.items()})
    for step in range(3):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        g["a"][:4] = [127.0, 0.5, -0.5, 1.5]  # scale 1: exact .5 ties
        jd, js = jgc.compress_decompress(jax.tree.map(jnp.asarray, g), js)
        td, ts = tgc.compress_decompress(_to_torch(g), ts)
        for k in shapes:
            want, got = np.asarray(jd[k]), to_np(td[k])
            scale = np.abs(want).max() / 127.0
            np.testing.assert_array_equal(np.round(got / scale),
                                          np.round(want / scale))
            np.testing.assert_allclose(to_np(ts[k]), np.asarray(js[k]),
                                       atol=1e-7, rtol=0)
    q, _ = tgc._quantize_leaf(torch.tensor([0.5, 1.5, 2.5, -0.5, 127.0]))
    assert q.tolist() == [0, 2, 2, 0, 127]  # half to even


@pytest.mark.parametrize("cfg", [dict(vocab=256, seq_len=40, batch=3),
                                 dict(vocab=50, seq_len=97, batch=2,
                                      motif_len=8, seed=5)])
def test_lm_batch_equal_jax(cfg):
    for step, shard in ((0, 0), (7, 1), (123, 3)):
        want = jax_lm_batch(JaxDataConfig(**cfg), step, shard, 4)
        got = lm_batch(SyntheticLMConfig(**cfg), step, shard, 4)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("t", [40, 1100])
def test_chunked_ce_loss_equal_jax(t):
    """One piece, and T > LOSS_CHUNK with a padded last piece and a mask
    that drops some positions."""
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, t, 16)).astype(np.float32)
    w = rng.standard_normal((16, 37)).astype(np.float32)
    labels = rng.integers(0, 37, (2, t)).astype(np.int32)
    mask = (rng.random((2, t)) > 0.2).astype(np.float32)
    want = float(jax_chunked_ce(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(labels), jnp.asarray(mask)))
    got = float(tlm.chunked_ce_loss(torch.from_numpy(x), torch.from_numpy(w),
                                    torch.from_numpy(labels).long(),
                                    torch.from_numpy(mask)))
    assert t <= tlm.LOSS_CHUNK or t % tlm.LOSS_CHUNK
    assert got == pytest.approx(want, rel=1e-6)


def _batches(vocab: int, n: int, batch: int = 4, seq: int = 16):
    dcfg = SyntheticLMConfig(vocab=vocab, seq_len=seq, batch=batch)
    return [lm_batch(dcfg, i) for i in range(n)]


@functools.lru_cache(maxsize=None)
def _jax_run(arch: str, microbatches: int, compress: bool):
    """JAX ``make_train_step`` (jitted) for STEPS steps from the shared
    init: (losses, final flat params)."""
    jcfg, _, _ = jax_side(arch)
    tcfg = JaxTrainConfig(optimizer=jadamw.AdamWConfig(eps=EPS),
                          microbatches=microbatches, grad_compress=compress,
                          warmup_steps=0, base_lr=1e-3)
    state = jax_init_train_state(jcfg, tcfg, jax.random.PRNGKey(0))
    step = jax.jit(jax_make_train_step(jcfg, tcfg))
    losses = []
    for b in _batches(jcfg.vocab, STEPS):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses, {k: np.asarray(v) for k, v in
                    _flatten(state["params"])[0]}


def _port_run(arch: str, microbatches: int, compress: bool, remat=None):
    tcfg, _, tparams = torch_side(arch)
    if remat is not None:
        import dataclasses

        tcfg = dataclasses.replace(tcfg, remat=remat)
    trc = TrainConfig(optimizer=tadamw.AdamWConfig(eps=EPS),
                      microbatches=microbatches, grad_compress=compress,
                      warmup_steps=0, base_lr=1e-3)
    state = init_train_state(tcfg, trc, device="cpu", params=tparams)
    step = make_train_step(tcfg, trc, device="cpu")
    losses = []
    for b in _batches(tcfg.vocab, STEPS):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return losses, _flat_port(state["params"])


CASES = [(a, 1, False) for a in ARCHS] + [("olmo-1b-reduced", 2, False),
                                          ("olmo-1b-reduced", 1, True)]


@pytest.mark.parametrize("arch,microbatches,compress", CASES)
def test_train_steps_equal_jax(arch, microbatches, compress):
    """Three steps (no warm-up, lr 1e-3 cosine, AdamW with eps ``EPS``):
    every loss within rtol 1e-5 and every parameter within 1e-5 of the JAX
    step's, every leaf moved.  Under int8 gradient compression a gradient
    element within float32 noise of a rounding tie takes the neighbouring
    code in one package (``test_compress_decompress_equal_jax`` holds the
    codes on equal inputs): there at most 1 in 1,000 elements of a leaf
    may leave 1e-5, by at most 2 lr a step."""
    want_l, want_p = _jax_run(arch, microbatches, compress)
    got_l, got_p = _port_run(arch, microbatches, compress)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    assert set(got_p) == set(want_p)
    for k in want_p:
        if not compress:
            np.testing.assert_allclose(got_p[k], want_p[k], rtol=0,
                                       atol=1e-5, err_msg=k)
            continue
        diff = np.abs(got_p[k] - want_p[k])
        assert (diff > 1e-5).mean() <= 1e-3, k
        assert diff.max() <= 2 * 1e-3 * STEPS, k
    start = _flat_port(torch_side(arch)[2])
    assert all(not np.array_equal(got_p[k], start[k]) for k in start)


@pytest.mark.parametrize("arch", ["hymba-1.5b-reduced", "rwkv6-1.6b-reduced"])
def test_remat_keeps_the_numbers(arch):
    """``cfg.remat`` (every block under ``torch.utils.checkpoint``)
    changes no loss and no parameter."""
    off_l, off_p = _port_run(arch, 1, False, remat="none")
    on_l, on_p = _port_run(arch, 1, False, remat="full")
    assert on_l == off_l
    for k in off_p:
        np.testing.assert_array_equal(on_p[k], off_p[k], err_msg=k)


def test_train_path_takes_no_kernel(monkeypatch):
    """The training loss does not reach the WKV scan's wrapper, which the
    forward does on every device: the wrapper is replaced by a function
    that fails, the forward fails and the loss still comes out (the plain
    WKV, and on the card the plain attention, are chosen by the explicit
    ``train`` argument)."""
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.kernels import rwkv6_scan as rsk

    def boom(*a, **k):
        raise AssertionError("an inference kernel on the training path")

    monkeypatch.setattr(fak, "flash_attention", boom)
    monkeypatch.setattr(rsk, "rwkv6_scan", boom)
    for arch in ("olmo-1b-reduced", "rwkv6-1.6b-reduced"):
        tcfg, tapi, tparams = torch_side(arch)
        b = {k: torch.as_tensor(v).long()
             for k, v in _batches(tcfg.vocab, 1)[0].items()}
        if tcfg.rwkv:
            with pytest.raises(AssertionError, match="inference kernel"):
                tapi.forward(tparams, b)
        assert torch.isfinite(tapi.train_loss(tparams, b))
