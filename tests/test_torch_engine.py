"""The port's continuous-batching engine: token identity with a sequential
one-request decode in the port, and with the JAX engine on the same
weights, trace and spec (``backend: "pallas"``; interpret mode on the JAX
side, the kernels' plain versions on the port's)."""

import json

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

from _torch_port import jax_side, packed_pair, torch_side

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
