"""The port's continuous-batching engine: token identity with a sequential
one-request decode in the port, and with the JAX engine on the same
weights, trace and spec (``backend: "pallas"``; interpret mode on the JAX
side, the kernels' plain versions on the port's), for olmo-1b-reduced with
a float32 or int8 KV cache and for rwkv6-1.6b-reduced's recurrent slot
state."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import EngineConfig as JaxEngineConfig
from repro.launch.serve import mixed_trace as jax_mixed_trace
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import EngineConfig
from repro_torch.core.policy import ApproxPolicy
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import mixed_trace
from repro_torch.numerics import get_preset
from repro_torch.serving import (AdmissionController, Request, RequestQueue,
                                 RequestState, ServingEngine, SlotScheduler)

from _torch_port import RWKV_ARCH, jax_side, packed_pair, torch_side

PALLAS = ("perforated", 2, True, "pallas")


def _trace(vocab, n, seed=3):
    rng = np.random.default_rng(seed)
    lens = [3, 17, 33, 9, 25, 5, 40, 12]
    return [(rng.integers(0, vocab, lens[i % 8] + int(rng.integers(0, 3))).tolist(),
             int(rng.integers(2, 10))) for i in range(n)]


def _sequential(api, params, prompt, gen, max_len):
    """One request alone: the whole prompt in one call, then thin steps."""
    cache = api.init_slot_cache(1, max_len, torch.float32)
    logits, _ = api.decode_slots(params, torch.tensor([prompt]), cache,
                                 [len(prompt)])
    out = [int(logits[0, -1].argmax())]
    for _ in range(gen - 1):
        logits, _ = api.decode_slots(params, torch.tensor([[out[-1]]]), cache,
                                     [1])
        out.append(int(logits[0, 0].argmax()))
    return out


@pytest.mark.parametrize("policy", [None, PALLAS], ids=["float", "pallas-perf2"])
def test_engine_token_identical_to_sequential(policy):
    _, tparams = packed_pair(policy)
    cfg, api, _ = torch_side()
    max_len = 64
    trace = _trace(cfg.vocab, 6)
    eng = ServingEngine(cfg, tparams, EngineConfig(
        slots=3, max_len=max_len, prefill_chunk=16, cache_dtype="float32"),
        api=api)
    reqs = [eng.submit(p, g) for p, g in trace]
    finished = eng.run()
    assert len(finished) == len(trace)
    snap = eng.snapshot()
    assert snap["requests_finished"] == len(trace)
    assert snap["generated_tokens"] == sum(g for _, g in trace)
    assert snap["mixed_steps"] > 0 and snap["decode_steps"] > 0
    for r, (prompt, gen) in zip(reqs, trace):
        assert r.finished and r.finish_reason == "length"
        assert r.generated == _sequential(api, tparams, prompt, gen, max_len)


def test_engine_tokens_equal_jax_engine():
    jparams, tparams = packed_pair(PALLAS)
    jcfg, _, _ = jax_side()
    cfg, api, _ = torch_side()
    trace = _trace(cfg.vocab, 4, seed=5)
    ek = dict(slots=3, max_len=64, prefill_chunk=8)
    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(**ek))
    teng = ServingEngine(cfg, tparams, EngineConfig(**ek), api=api)
    jreqs = [jeng.submit(p, g) for p, g in trace]
    treqs = [teng.submit(p, g) for p, g in trace]
    jeng.run()
    teng.run()
    for j, t in zip(jreqs, treqs):
        assert t.finished and j.finished
        assert t.generated == j.generated, (t.rid, t.generated, j.generated)
    js, ts = jeng.metrics.snapshot(), teng.snapshot()
    for key in ("prefill_steps", "mixed_steps", "decode_steps",
                "generated_tokens", "prompt_tokens"):
        assert ts[key] == js[key], key


def test_mixed_trace_matches_reference():
    jcfg, _, _ = jax_side()
    cfg, _, _ = torch_side()
    assert mixed_trace(cfg, 8, 256, 32, seed=0) == jax_mixed_trace(
        jcfg, 8, 256, 32, seed=0)


def _req(rid, plen=4, gen=4, priority=0):
    return Request(rid=rid, prompt=list(range(plen)), max_new_tokens=gen,
                   priority=priority)


def test_admission_queue_and_mixed_batches():
    adm = AdmissionController(max_queue=2, max_len=32, prefill_chunk=8)
    q = RequestQueue()
    assert "empty" in adm.check(q, _req(0, plen=0))[1]
    assert "exceeds slot capacity" in adm.check(q, _req(1, plen=30, gen=4))[1]
    assert "padded" in adm.check(q, _req(2, plen=33, gen=1))[1]
    q.push(_req(4, priority=1))
    q.push(_req(5, priority=1))
    ok, _, evicted = adm.admit(q, _req(6, priority=0))
    assert ok and evicted.rid == 5  # newest lowest-priority job makes room
    q.push(_req(6, priority=0))
    assert "queue full" in adm.check(q, _req(7, priority=1))[1]

    class Pool:
        def __init__(self):
            self._free = [1, 0]
            self.n_free = 2

        def acquire_for(self, req):
            self.n_free -= 1
            return self._free.pop()

    sched = SlotScheduler(slots=2, prefill_chunk=8)
    active = {}
    q = RequestQueue()
    for r in (_req(0, plen=11), _req(1, plen=3)):
        q.push(r)
    a, b = sched.admit(q, Pool(), active)
    assert (a.slot, b.slot) == (0, 1) and a.state == RequestState.PREFILL
    b.state = RequestState.DECODE
    b.generated = [42]
    batch = sched.next_batch(active)
    assert batch.kind == "mixed" and batch.tokens.shape == (2, 8)
    assert batch.n_valid.tolist() == [8, 1] and batch.tokens[1, 0] == 42
    assert batch.row_kinds == ["prefill", "decode"]


def test_serve_cli_with_pallas_spec_json(tmp_path, capsys):
    spec = get_preset("serve-default", policy=ApproxPolicy(*PALLAS[:2],
                                                           backend="pallas"))
    path = tmp_path / "spec.json"
    path.write_text(spec.to_json())
    serve_main(["--device", "cpu", "--requests", "3", "--slots", "2",
                "--max-len", "64", "--chunk", "16", "--spec-json", str(path)])
    out = capsys.readouterr().out
    assert "finished 3/3 requests" in out
    assert f"numerics={spec.name}" in out
    snap = json.loads(out[out.index("{"):out.rindex("}") + 1])
    assert snap["requests_finished"] == 3 and snap["gen_tok_per_s"] > 0


# ---------------------------------------------------------------------------
# the int8 KV cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_cache_casts_bit_equal_to_reference(dtype):
    """``_to_cache``/``_from_cache`` against the reference's: values on the
    1/16 grid and half-way between (round half to even), past the +-127
    clip, and the round trip back."""
    from repro.nn import attention as jattn
    from repro_torch.nn import attention as tattn

    rng = np.random.default_rng(4)
    x = np.concatenate([rng.normal(0, 3, 500), np.arange(-40, 40) / 32.0,
                        [7.9, 7.97, -7.97, 8.0, -8.0, 9.5, -100.0, 0.0]])
    x = x.astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    assert tattn.KV_INT8_SCALE == jattn.KV_INT8_SCALE
    jq, tq = jattn._to_cache(jx, jnp.int8), tattn._to_cache(tx, torch.int8)
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq.min() == -127 and tq.max() == 127
    back_j = np.asarray(jattn._from_cache(jq, jx.dtype), np.float32)
    back_t = tattn._from_cache(tq, tx.dtype)
    assert back_t.dtype == tx.dtype
    assert back_t.float().numpy().tobytes() == back_j.tobytes()
    # a float cache is a plain cast both ways
    assert torch.equal(tattn._to_cache(tx, torch.float32), tx.float())


def test_int8_cache_engine_tokens_equal_jax_engine():
    jparams, tparams = packed_pair(PALLAS)
    jcfg, _, _ = jax_side()
    cfg, api, _ = torch_side()
    trace = _trace(cfg.vocab, 4, seed=6)
    ek = dict(slots=3, max_len=64, prefill_chunk=8, cache_dtype="int8")
    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(**ek))
    teng = ServingEngine(cfg, tparams, EngineConfig(**ek), api=api)
    assert teng.pool.cache["k"].dtype == torch.int8
    jreqs = [jeng.submit(p, g) for p, g in trace]
    treqs = [teng.submit(p, g) for p, g in trace]
    jeng.run()
    teng.run()
    for j, t in zip(jreqs, treqs):
        assert t.finished and j.finished
        assert t.generated == j.generated, (t.rid, t.generated, j.generated)
    # the cache holds the reference's int8 codes, not a cast of floats
    np.testing.assert_array_equal(teng.pool.cache["k"].numpy(),
                                  np.asarray(jeng.pool.cache["k"]))


# ---------------------------------------------------------------------------
# RWKV6 through the engine
# ---------------------------------------------------------------------------


def _rwkv_sequential(api, params, prompt, gen):
    """The recurrent form the engine serves, one request alone: every
    prompt token through the lock-step ``decode_step``, then greedy
    steps."""
    cache = api.init_cache(1, 0, torch.float32)
    for t in prompt:
        logits, cache = api.decode_step(params, torch.tensor([[t]]), cache)
    out = [int(logits[0].argmax())]
    for _ in range(gen - 1):
        logits, cache = api.decode_step(params, torch.tensor([[out[-1]]]),
                                        cache)
        out.append(int(logits[0].argmax()))
    return out


@pytest.mark.parametrize("policy", [None, PALLAS],
                         ids=["float", "pallas-perf2"])
def test_rwkv_engine_tokens_equal_jax_engine_and_sequential(policy):
    jparams, tparams = packed_pair(policy, RWKV_ARCH)
    jcfg, _, _ = jax_side(RWKV_ARCH)
    cfg, api, _ = torch_side(RWKV_ARCH)
    trace = _trace(cfg.vocab, 5, seed=7)
    ek = dict(slots=2, max_len=64, prefill_chunk=16, cache_dtype="float32")
    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(**ek))
    teng = ServingEngine(cfg, tparams, EngineConfig(**ek), api=api)
    jreqs = [jeng.submit(p, g) for p, g in trace]
    treqs = [teng.submit(p, g) for p, g in trace]
    assert len(jeng.run()) == len(teng.run()) == len(trace)
    for j, t, (prompt, gen) in zip(jreqs, treqs, trace):
        assert t.finished and len(t.generated) == gen
        assert t.generated == j.generated, (t.rid, t.generated, j.generated)
        assert t.generated == _rwkv_sequential(api, tparams, prompt, gen)
    js, ts = jeng.metrics.snapshot(), teng.snapshot()
    for key in ("prefill_steps", "mixed_steps", "decode_steps",
                "generated_tokens", "prompt_tokens"):
        assert ts[key] == js[key], key


def test_rwkv_decode_slots_masks_state_per_row():
    """Rows past their valid length keep their state bit-exact (a row with
    n_valid 0 untouched, a row with 2 of 4 advanced by exactly 2 steps), and
    logits match the reference's step."""
    from repro.models import rwkv_lm as jrwkv

    jparams, tparams = packed_pair(PALLAS, RWKV_ARCH)
    jcfg, _, _ = jax_side(RWKV_ARCH)
    cfg, api, _ = torch_side(RWKV_ARCH)
    rng = np.random.default_rng(8)
    cache = api.init_slot_cache(3, 0, torch.float32)
    api.decode_slots(tparams, torch.from_numpy(rng.integers(
        0, cfg.vocab, (3, 4))), cache, [4, 4, 4])
    before = {k: v.clone() for k, v in cache.items()}
    jcache = {k: jnp.asarray(v.numpy()) for k, v in before.items()}
    toks = rng.integers(0, cfg.vocab, (3, 4))
    nv = np.array([0, 2, 4], np.int32)
    tl, _ = api.decode_slots(tparams, torch.from_numpy(toks), cache, nv)
    jl, jc = jrwkv.decode_slots(jparams, jnp.asarray(toks, jnp.int32), jcache,
                                jcfg, jnp.asarray(nv))
    assert cache["lengths"].tolist() == [4, 6, 8]
    for key in ("shift_tm", "shift_cm", "wkv"):
        assert torch.equal(cache[key][:, 0], before[key][:, 0]), key
        assert not torch.equal(cache[key][:, 1], before[key][:, 1]), key
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jc[key]),
                                   rtol=0, atol=1e-4, err_msg=key)
    assert tl.shape == (3, 4, cfg.vocab) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    # row 1 after two steps equals a run of just those two tokens
    two = {k: v.clone() for k, v in before.items()}
    short = np.zeros((3, 2), np.int64)
    short[1] = toks[1, :2]
    api.decode_slots(tparams, torch.from_numpy(short), two, [0, 2, 0])
    for key in ("shift_tm", "shift_cm", "wkv"):
        assert torch.equal(cache[key][:, 1], two[key][:, 1]), key


def test_slot_pool_zeroes_recurrent_state_on_acquire():
    from repro_torch.serving.kv_pool import SlotPool

    cfg, api, _ = torch_side(RWKV_ARCH)
    pool = SlotPool(api, slots=2, max_len=32, cache_dtype="float32")
    for key, leaf in pool.cache.items():
        leaf.fill_(1)
    pool.cache["lengths"].copy_(torch.tensor([4, 7]))
    slot = pool.acquire(rid=0)
    for key, leaf in pool.cache.items():
        if key == "lengths":
            assert leaf[slot] == 0 and leaf[1 - slot] == 7
        else:  # (L, slots, ...)
            assert not leaf[:, slot].any(), key
            assert bool((leaf[:, 1 - slot] == 1).all()), key


@pytest.mark.parametrize("arch,cache_dtype", [
    ("qwen3-4b-reduced", "int8"), ("rwkv6-1.6b-reduced", "bfloat16"),
    ("deepseek-67b-reduced", "bfloat16")])
def test_serve_cli_engine_new_archs(arch, cache_dtype, capsys):
    serve_main(["--device", "cpu", "--arch", arch, "--cache-dtype",
                cache_dtype, "--requests", "3", "--slots", "2", "--max-len",
                "64", "--chunk", "16"])
    out = capsys.readouterr().out
    assert "finished 3/3 requests" in out
    assert f"arch={arch} " in out and f"kv={cache_dtype} " in out


# ---------------------------------------------------------------------------
# request deadlines and the engine surface (load, reset_metrics,
# compile_count), the plan subcommand
# ---------------------------------------------------------------------------


def _lockstep(jeng, teng, jreqs, treqs, hooks):
    """Step both engines together until idle; ``hooks[i]`` runs on the
    (jax, port) request pairs after step i."""
    i = 0
    jfin, tfin = [], []
    while not (jeng.idle and teng.idle):
        jfin += jeng.step()
        tfin += teng.step()
        if i in hooks:
            hooks[i](jreqs, treqs)
        i += 1
    return jfin, tfin


def test_deadlines_expire_in_the_queue_and_mid_run_like_jax():
    """A request whose deadline passes while queued is purged before it
    takes a slot; one whose deadline passes mid-prompt stops at its next
    chunk, and one mid-decode at its next token (partial output kept):
    finish reasons, tokens and counts equal the JAX engine's.  Running
    requests get their budget cut to 0 ms between two steps, so the run
    is deterministic."""
    jparams, tparams = packed_pair(PALLAS)
    jcfg, _, _ = jax_side()
    cfg, api, _ = torch_side()
    rng = np.random.default_rng(12)
    plan = [(3, 8, 1e9), (33, 5, 1e9), (5, 4, 0.0), (9, 3, None),
            (4, 6, None)]
    trace = [(rng.integers(0, cfg.vocab, p).tolist(), g, d)
             for p, g, d in plan]
    ek = dict(slots=2, max_len=64, prefill_chunk=16)
    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(**ek))
    teng = ServingEngine(cfg, tparams, EngineConfig(**ek), api=api)
    jreqs = [jeng.submit(p, g, deadline_ms=d) for p, g, d in trace]
    treqs = [teng.submit(p, g, deadline_ms=d) for p, g, d in trace]

    def expire(i):
        def hook(js, ts):
            js[i].deadline_ms = ts[i].deadline_ms = 0.0
        return hook

    # after step 0: request 1 is mid-prompt (16 of 33); after step 2,
    # request 0 is decoding
    jfin, tfin = _lockstep(jeng, teng, jreqs, treqs,
                           {0: expire(1), 2: expire(0)})
    assert len(tfin) == len(jfin) == len(trace)
    for j, t in zip(jreqs, treqs):
        assert t.finish_reason == j.finish_reason, t.rid
        assert t.generated == j.generated, t.rid
        assert t.prefilled == j.prefilled, t.rid
    reasons = [t.finish_reason for t in treqs]
    assert reasons == ["deadline", "deadline", "deadline", "length", "length"]
    assert treqs[2].slot is None and not treqs[2].generated  # never served
    assert treqs[1].prefilled == 32 and not treqs[1].generated
    assert 0 < len(treqs[0].generated) < 8
    js, ts = jeng.metrics.snapshot(), teng.snapshot()
    assert ts["requests_deadline_expired"] == \
        js["requests_deadline_expired"] == 3


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_engine_load_reset_metrics_and_compile_count(layout):
    jparams, tparams = packed_pair(PALLAS)
    jcfg, _, _ = jax_side()
    cfg, api, _ = torch_side()
    trace = _trace(cfg.vocab, 5, seed=9)
    ek = dict(slots=2, max_len=64, prefill_chunk=16, kv_layout=layout,
              kv_block_size=8)
    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(**ek), numerics="sd")
    teng = ServingEngine(cfg, tparams, EngineConfig(**ek), api=api,
                         numerics="sd")
    for p, g in trace:
        jeng.submit(p, g)
        teng.submit(p, g)
    for _ in range(3):
        jeng.step()
        teng.step()
        jl, tl = jeng.load(), teng.load()
        jl.pop("ttft_mean_s")
        assert set(tl) == set(jl) | {"ttft_mean_s"}
        assert {k: tl[k] for k in jl} == jl
    jeng.run()
    teng.run()
    assert teng.compile_count() == jeng.compile_count() == 2
    assert teng.load()["pending"] == 0 and teng.load()["ttft_mean_s"] > 0
    assert teng.snapshot()["generated_tokens"] > 0
    teng.reset_metrics()
    snap = teng.snapshot()
    assert snap["numerics"] == "sd" and snap["kv_layout"] == layout
    assert snap["generated_tokens"] == 0 and snap["requests_finished"] == 0
    if layout == "paged":
        assert snap["cow_copies"] is None  # no step in the new window yet
        r = teng.submit(trace[0][0], 2)
        teng.run()
        snap = teng.snapshot()
        assert snap["cow_copies"] == 0 and r.finished
        assert snap["peak_blocks_in_use"] <= teng.pool.blocks_total


@pytest.mark.parametrize("flags", [[], ["--json"], ["--preset", "int8"],
                                   ["--mode", "truncated", "--m", "6",
                                    "--no-cv", "--json"]],
                         ids=["table", "json", "int8", "trunc-json"])
@pytest.mark.parametrize("arch", ["olmo-1b-reduced", "qwen3-4b"])
def test_plan_subcommand_prints_the_jax_cli_output(arch, flags, capsys):
    """``plan`` resolves over parameters on the meta device (qwen3-4b at
    full width allocates nothing) and prints the reference CLI's table or
    JSON, byte for byte."""
    from repro.launch.serve import main as jax_serve_main

    serve_main(["plan", "--arch", arch] + flags)
    got = capsys.readouterr().out
    jax_serve_main(["plan", "--arch", arch] + flags)
    want = capsys.readouterr().out
    assert got == want
    if "--json" in flags:
        assert json.loads(got)["entries"]
    else:
        assert "power-%" in got and "bytes total" in got


def test_plan_refuses_diff_checkpoint_and_float(tmp_path):
    # ``--diff-checkpoint`` is served now (tests/test_torch_runtime.py::
    # test_plan_diff_checkpoint_gate); float serving has nothing to plan
    with pytest.raises(SystemExit, match="nothing to plan"):
        serve_main(["plan", "--mode", "float"])


def test_serve_cli_deadline_and_submit_retries_flags(capsys):
    """``--deadline-ms`` below any step's time: every request expires in
    the queue, none is served."""
    serve_main(["--device", "cpu", "--requests", "3", "--slots", "2",
                "--max-len", "64", "--chunk", "16", "--deadline-ms", "1e-6",
                "--submit-retries", "0"])
    out = capsys.readouterr().out
    snap = json.loads(out[out.index("{"):out.rindex("}") + 1])
    assert snap["requests_deadline_expired"] == 3
    assert snap["generated_tokens"] == 0
    assert "[deadline]" in out
