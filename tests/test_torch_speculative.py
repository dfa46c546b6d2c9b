"""The port's self-verifying speculative decode
(``repro_torch.serving.speculative`` through the engine): the counterparts
of tests/test_speculative.py (``test_plan_diff_checkpoint_gate``'s is in
tests/test_torch_runtime.py, beside the checkpoints it reads), and parity
with the JAX engine on one trace — the same emitted tokens and the same
drafted, accepted, round and draft-call counts, on both KV layouts.

One float init (JAX's, carried across by the bridge) packed twice: the
``int8`` preset verifies, ``serve-default`` (perforated m=2 + CV) on
``backend: "pallas"`` drafts — the kernels' plain versions here, interpret
mode on the JAX side.  Every token comparison is exact: the emitted stream
must equal a sequential exact-int8 greedy decode.
"""

import numpy as np
import pytest
import torch

from repro.configs.base import EngineConfig as JaxEngineConfig
from repro.core.policy import ApproxPolicy as JaxPolicy
from repro.launch import serve as jserve
from repro.launch.serve import ServeConfig as JaxServeConfig
from repro.launch.serve import build_serving_params as jax_build
from repro.numerics.presets import get_preset as jax_get_preset
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import EngineConfig
from repro_torch.core.policy import ApproxPolicy
from repro_torch.launch import serve as tserve
from repro_torch.launch.serve import ServeConfig, build_serving_params
from repro_torch.numerics import get_preset
from repro_torch.serving import ServingEngine

from _torch_port import RWKV_ARCH, jax_side, torch_side

MAX_LEN = 64
_PACKS = {}


def _draft_spec(get, policy_cls, use_cv=True):
    return get("serve-default", policy=policy_cls(
        "perforated", 2, use_cv=use_cv, backend="pallas"))


def _port(name):
    """The port's packs of the shared init: "verify" (int8), "draft"
    (serve-default on the kernel), "draft-nocv"."""
    if name not in _PACKS:
        cfg, _, raw = torch_side()
        spec = (get_preset("int8") if name == "verify" else _draft_spec(
            get_preset, ApproxPolicy, use_cv=name == "draft"))
        _PACKS[name] = build_serving_params(raw, cfg, ServeConfig(spec=spec),
                                            device="cpu")
    return _PACKS[name]


def _sequential(params, prompt, gen):
    """Exact greedy decode of one request alone: the whole prompt in one
    call, then thin steps."""
    _, api, _ = torch_side()
    cache = api.init_slot_cache(1, MAX_LEN, torch.float32)
    logits, _ = api.decode_slots(params, torch.tensor([prompt]), cache,
                                 [len(prompt)])
    out = [int(logits[0, -1].argmax())]
    for _ in range(gen - 1):
        logits, _ = api.decode_slots(params, torch.tensor([[out[-1]]]), cache,
                                     [1])
        out.append(int(logits[0, 0].argmax()))
    return out


def _trace(vocab, n=6, seed=3):
    rng = np.random.default_rng(seed)
    trace = []
    for i in range(n):
        plen = [3, 17, 33, 9, 25, 5][i % 6] + int(rng.integers(0, 3))
        gen = int(rng.integers(4, 12))
        trace.append((rng.integers(0, vocab, plen).tolist(), gen))
    return trace


def _ecfg(k, layout="contiguous", block_size=16, slots=3):
    return dict(slots=slots, max_len=MAX_LEN, prefill_chunk=16,
                cache_dtype="float32", speculative_k=k, kv_layout=layout,
                kv_block_size=block_size)


def _spec_engine(draft, k, layout="contiguous", block_size=16, slots=3,
                 label="serve-default"):
    cfg, api, _ = torch_side()
    return ServingEngine(cfg, _port("verify"), EngineConfig(
        **_ecfg(k, layout, block_size, slots)), api=api, draft_params=draft,
        draft_numerics=label)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_speculative_token_identical(layout):
    """For every draft depth the speculative engine emits exactly the
    sequential exact-int8 greedy tokens, accepts a nonzero share of drafts
    and dispatches two (parameters, shape) pairs: the draft pack at the
    thin shape, the exact pack at the chunk shape."""
    cfg, _, _ = torch_side()
    trace = _trace(cfg.vocab)
    base = [_sequential(_port("verify"), p, g) for p, g in trace]
    for k in (1, 2, 4):
        eng = _spec_engine(_port("draft"), k, layout=layout,
                           block_size=8 if layout == "paged" else 16)
        reqs = [eng.submit(p, g) for p, g in trace]
        assert len(eng.run()) == len(trace)
        for r, want in zip(reqs, base):
            assert r.finished and r.generated == want, (layout, k, r.rid)
        assert eng.compile_count() == 2, (layout, k)
        snap = eng.snapshot()
        assert snap["speculative_k"] == k
        assert snap["drafted_tokens"] > 0 and snap["spec_rounds"] > 0
        assert snap["acceptance_rate"] > 0, (layout, k)
        assert snap["draft_numerics"] == "serve-default"


def test_paged_rollback_at_block_boundary():
    """A drafter packed from other weights proposes near-junk, so almost
    every round rejects and rolls the cursors back over drafted positions,
    with block size 4 repeatedly across block boundaries: the output still
    equals the baseline."""
    cfg, api, _ = torch_side()
    junk = build_serving_params(api.init(42), cfg, ServeConfig(
        spec=_draft_spec(get_preset, ApproxPolicy)), device="cpu")
    rng = np.random.default_rng(5)
    trace = [(rng.integers(0, cfg.vocab, 7).tolist(), 12),
             (rng.integers(0, cfg.vocab, 19).tolist(), 10)]
    eng = _spec_engine(junk, 4, layout="paged", block_size=4, slots=2,
                       label="junk")
    reqs = [eng.submit(p, g) for p, g in trace]
    eng.run()
    snap = eng.snapshot()
    assert 0 <= snap["accepted_draft_tokens"] < snap["drafted_tokens"]
    for r, (p, g) in zip(reqs, trace):
        assert r.generated == _sequential(_port("verify"), p, g), r.rid
    assert eng.pool.lengths().tolist() == eng.pool.cache["lengths"].tolist()


def test_drafted_eos_never_finishes():
    """A junk drafter whose first proposal lies outside the exact greedy
    continuation, with eos_id set to that proposal: the verifier rejects
    it, so the request runs its whole budget ('length')."""
    cfg, api, _ = torch_side()
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab, 9).tolist()
    gen = 8
    verify = _port("verify")
    base = _sequential(verify, prompt, gen)
    junk = d1 = None
    for seed in (9, 13, 21, 34):
        cand = build_serving_params(api.init(seed), cfg, ServeConfig(
            spec=_draft_spec(get_preset, ApproxPolicy)), device="cpu")
        cache = api.init_slot_cache(1, MAX_LEN, torch.float32)
        api.decode_slots(verify, torch.tensor([prompt]), cache, [len(prompt)])
        logits, _ = api.decode_slots(cand, torch.tensor([[base[0]]]), cache,
                                     [1])
        tok = int(logits[0, 0].argmax())
        if tok not in base:
            junk, d1 = cand, tok
            break
    assert junk is not None, "no drafter proposed outside the baseline"
    eng = _spec_engine(junk, 4, slots=2, label="junk")
    r = eng.submit(prompt, gen, eos_id=d1)
    eng.run()
    assert r.generated == base and r.finish_reason == "length"


def test_cv_acceptance_at_least_no_cv():
    cfg, _, _ = torch_side()
    trace = _trace(cfg.vocab)
    rates = {}
    for label in ("draft", "draft-nocv"):
        eng = _spec_engine(_port(label), 4, label=label)
        for p, g in trace:
            eng.submit(p, g)
        eng.run()
        rates[label] = eng.snapshot()["acceptance_rate"]
    assert rates["draft"] >= rates["draft-nocv"], rates


def test_speculative_construction_guards_with_the_reference_messages():
    cfg, api, tparams = torch_side()
    jcfg, _, jparams = jax_side()
    ek = dict(slots=2, max_len=32, prefill_chunk=8, cache_dtype="float32",
              speculative_k=2)
    with pytest.raises(ValueError, match="draft_params") as got:
        ServingEngine(cfg, tparams, EngineConfig(**ek), api=api)
    with pytest.raises(ValueError) as want:
        JaxEngine(jcfg, jparams, JaxEngineConfig(**ek))
    assert str(got.value).replace("repro_torch", "repro") == str(want.value)
    rcfg, rapi, rparams = torch_side(RWKV_ARCH)
    rjcfg, _, rjparams = jax_side(RWKV_ARCH)
    with pytest.raises(NotImplementedError, match="roll back") as got:
        ServingEngine(rcfg, rparams, EngineConfig(**ek), api=rapi,
                      draft_params=rparams)
    with pytest.raises(NotImplementedError) as want:
        JaxEngine(rjcfg, rjparams, JaxEngineConfig(**ek),
                  draft_params=rjparams)
    assert str(got.value) == str(want.value)
    # a float draft buys nothing: the CLI refuses it as the reference's does
    flags = ["--speculative-k", "2", "--mode", "float"]
    with pytest.raises(SystemExit) as got:
        tserve.main(flags + ["--device", "cpu"])
    with pytest.raises(SystemExit) as want:
        jserve.main(flags)
    assert str(got.value) == str(want.value) and "float drafting" in str(
        got.value)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_speculative_tokens_and_counts_equal_jax_engine(layout):
    jcfg, _, jparams = jax_side()
    cfg, api, _ = torch_side()
    jverify = jax_build(jparams, jcfg, JaxServeConfig(
        spec=jax_get_preset("int8")))
    jdraft = jax_build(jparams, jcfg, JaxServeConfig(
        spec=_draft_spec(jax_get_preset, JaxPolicy)))
    trace = _trace(cfg.vocab, n=4, seed=8)
    ek = _ecfg(3, layout, block_size=8)
    jeng = JaxEngine(jcfg, jverify, JaxEngineConfig(**ek),
                     draft_params=jdraft, draft_numerics="d")
    teng = ServingEngine(cfg, _port("verify"), EngineConfig(**ek), api=api,
                         draft_params=_port("draft"), draft_numerics="d")
    jreqs = [jeng.submit(p, g) for p, g in trace]
    treqs = [teng.submit(p, g) for p, g in trace]
    jeng.run()
    teng.run()
    for j, t in zip(jreqs, treqs):
        assert t.finished and j.finished
        assert t.generated == j.generated, (t.rid, t.generated, j.generated)
    js, ts = jeng.metrics.snapshot(), teng.snapshot()
    for key in ("drafted_tokens", "accepted_draft_tokens", "spec_rounds",
                "draft_calls", "generated_tokens", "prompt_tokens",
                "acceptance_rate"):
        want = js[key]
        got = ts[key] if key != "acceptance_rate" else round(ts[key], 4)
        assert got == want, key
    assert teng.compile_count() == jeng.compile_count() == 2


def test_speculative_through_the_cli(capsys):
    tserve.main(["--device", "cpu", "--requests", "3", "--slots", "2",
                 "--max-len", "64", "--chunk", "8", "--speculative-k", "3",
                 "--assert-acceptance", "--kv-layout", "paged"])
    out = capsys.readouterr().out
    assert "finished 3/3 requests, 2 compiled shapes" in out
    assert "numerics=int8 " in out and "speculative_k=3 draft=" in out
    assert "speculative: acceptance_rate=" in out
