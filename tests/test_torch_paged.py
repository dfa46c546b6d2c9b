"""The port's paged KV layout (``repro_torch.serving.paged`` and the block
path of ``models.lm.decode_slots``): the counterparts of
tests/test_paged_kv.py (the MLA case waits for the MLA arch), then parity
with the JAX package on one trace — paged tokens equal the JAX paged
engine's, equal the port's contiguous tokens at block sizes 1, 4 and 16,
and the pool's counters (blocks allocated, prefix hits and hit tokens,
copy-on-write copies, evictions) equal the JAX pool's.

Model: olmo-1b-reduced, initialised once in JAX and carried across by the
bridge, packed under ``serve-default`` on ``backend: "pallas"`` (the
kernels' plain versions here, interpret mode on the JAX side), float32 KV
cache unless a test says otherwise.  Token comparisons are exact; the
paged step's attention reads a gathered view of the contiguous layout's
key length, so its arithmetic has the contiguous step's shapes.
"""

import numpy as np
import pytest
import torch

from repro.configs.base import EngineConfig as JaxEngineConfig
from repro.models import build_model as jax_build_model
from repro.serving import ServingEngine as JaxEngine
from repro.serving import paged as jpaged
from repro_torch.configs import EngineConfig
from repro_torch.serving import RequestState, ServingEngine
from repro_torch.serving.paged import (NULL_BLOCK, BlockAllocator,
                                       PagedKVPool, PrefixCache,
                                       block_hashes)

from _torch_port import RWKV_ARCH, jax_side, packed_pair, torch_side

PALLAS = ("perforated", 2, True, "pallas")
MAX_LEN = 64

# ---------------------------------------------------------------------------
# units (no model)
# ---------------------------------------------------------------------------


def test_allocator_refcounts_and_null_block():
    a = BlockAllocator(5)  # ids 1..4 usable; 0 reserved NULL
    got = [a.alloc() for _ in range(4)]
    assert sorted(got) == [1, 2, 3, 4] and NULL_BLOCK not in got
    assert a.n_free == 0 and a.n_used == 4 and a.peak_used == 4
    with pytest.raises(RuntimeError):
        a.alloc()
    a.incref(got[0])
    assert not a.decref(got[0])  # still shared
    assert a.decref(got[0])  # now freed
    assert a.n_free == 1 and a.refcount(got[0]) == 0
    assert a.alloc() == got[0]  # recycled


def test_block_hashes_chain_commits_to_prefix_and_equal_jax():
    h1 = block_hashes([1, 2, 3, 4, 5, 6, 7], 4)
    assert len(h1) == 1  # only FULL blocks are hashed
    h2 = block_hashes([1, 2, 3, 4, 9, 9, 9, 9], 4)
    assert h1[0] == h2[0]
    h3 = block_hashes([0, 2, 3, 4, 9, 9, 9, 9], 4)
    assert h3[0] != h2[0] and h3[1] != h2[1]  # every downstream hash moves
    assert block_hashes([1, 2, 3], 4) == []
    toks = np.random.default_rng(0).integers(0, 256, 50).tolist()
    for bs in (1, 4, 16):
        assert block_hashes(toks, bs) == jpaged.block_hashes(toks, bs)


def test_prefix_cache_match_register_lru():
    a = BlockAllocator(8)
    c = PrefixCache()
    hs = block_hashes(list(range(12)), 4)  # 3 full blocks
    bids = [a.alloc() for _ in range(3)]
    for h, b in zip(hs, bids):
        assert c.register(h, b, a)
        assert not c.register(h, b, a)  # idempotent, refresh only
    assert a.refcount(bids[0]) == 2  # the cache holds its own reference
    assert c.match(hs) == bids
    other = block_hashes(list(range(8)) + [99, 99, 99, 99], 4)
    assert c.match(other) == bids[:2]
    assert not c.evict_lru(a)  # live requests hold every block
    for b in bids:
        a.decref(b)
    c.touch(hs[:2])
    assert c.evict_lru(a)
    assert c.match(hs) == bids[:2]  # the chain now stops before block 2
    assert a.refcount(bids[2]) == 0
    assert c.evict_lru(a) and c.evict_lru(a)
    assert c.match(hs) == [] and not c.evict_lru(a)
    assert a.refcount(bids[0]) == 0 and a.n_free == 7


# ---------------------------------------------------------------------------
# pool-level behavior
# ---------------------------------------------------------------------------


class _Req:
    def __init__(self, rid, prompt, gen):
        self.rid, self.prompt, self.max_new_tokens = rid, prompt, gen
        self.prefix_hit_tokens = 0
        self.block_hashes = None


def _pool(slots=2, blocks=0, bs=8, dtype="float32"):
    _, api, _ = torch_side()
    return PagedKVPool(api, EngineConfig(
        slots=slots, max_len=MAX_LEN, prefill_chunk=16, cache_dtype=dtype,
        kv_layout="paged", kv_block_size=bs, kv_blocks=blocks))


def _mirror_agrees(pool):
    assert pool.lengths().tolist() == pool.cache["lengths"].tolist()


def test_pool_reserves_upfront_and_stalls_on_block_exhaustion():
    pool = _pool(slots=4, blocks=10)
    s0 = pool.acquire_for(_Req(0, list(range(1, 41)), 8))  # 6 blocks
    assert s0 is not None and pool.allocator.n_used == 6
    assert pool.n_free == 3
    assert pool.acquire_for(_Req(1, list(range(1, 41)), 8)) is None
    pool.release(s0)
    assert pool.allocator.n_used == 0  # nothing published: all freed
    assert pool.acquire_for(_Req(2, list(range(1, 41)), 8)) is not None


def test_pool_cow_swaps_shared_block_and_copies_its_content():
    pool = _pool()
    prompt = list(range(1, 17))  # exactly 2 full blocks
    s0 = pool.acquire_for(_Req(0, prompt, 4))
    for key in ("k", "v"):  # stand-in for the prefill's writes
        for lb, bid in enumerate(pool._tables[s0].blocks[:2]):
            pool.cache[key][:, bid] = 1.0 + lb
    pool.advance(np.asarray([16, 0]))
    pool.register_prefix(s0, len(prompt), 16)
    r1 = _Req(1, prompt, 4)
    s1 = pool.acquire_for(r1)
    assert r1.prefix_hit_tokens == 15  # full match, capped one token early
    shared = pool._tables[s1].blocks[1]
    assert shared == pool._tables[s0].blocks[1]
    assert pool.allocator.refcount(shared) == 3  # owner + cache + sharer
    pool.ensure_writable(s1, 1)  # the capped re-prefill writes block 1
    assert pool.cow_copies == 1
    dst = pool._tables[s1].blocks[1]
    assert dst != shared and pool._tables[s0].blocks[1] == shared
    assert pool.allocator.refcount(shared) == 2
    assert pool._pending_copies == [(shared, dst)]
    pool.flush_copies()
    assert not pool._pending_copies
    for key in ("k", "v"):
        assert torch.equal(pool.cache[key][:, dst], pool.cache[key][:, shared])
        assert not pool.cache[key][:, NULL_BLOCK].any()
    used_before = pool.allocator.n_used
    pool.release(s1)
    assert pool.allocator.n_used < used_before


def test_pool_release_while_shared_keeps_blocks_alive():
    pool = _pool()
    prompt = list(range(1, 25))  # 3 full blocks
    s0 = pool.acquire_for(_Req(0, prompt, 2))
    pool.advance(np.asarray([24, 0]))
    pool.register_prefix(s0, 24, 24)
    r1 = _Req(1, prompt + [99] * 8, 2)
    s1 = pool.acquire_for(r1)
    assert r1.prefix_hit_tokens == 24
    shared = list(pool._tables[s0].blocks[:3])
    assert pool._tables[s1].blocks[:3] == shared
    pool.release(s0)
    assert all(pool.allocator.refcount(b) == 2 for b in shared)
    pool.release(s1)
    assert all(pool.allocator.refcount(b) == 1 for b in shared)
    while pool.prefix.evict_lru(pool.allocator):
        pass
    assert all(pool.allocator.refcount(b) == 0 for b in shared)
    assert pool.allocator.n_used == 0


def test_host_cursor_mirror_agrees_after_rollback_release_and_reuse():
    pool = _pool(slots=3)
    slots = [pool.acquire_for(_Req(i, list(range(1, 20)), 8))
             for i in range(2)]
    _mirror_agrees(pool)
    pool.cache["lengths"] += torch.tensor([7, 3, 0], dtype=torch.int32)
    pool.advance([7, 3, 0])
    _mirror_agrees(pool)
    pool.set_lengths(np.asarray([5, 2, 0]))  # a rollback across a block
    _mirror_agrees(pool)
    pool.release(slots[0])
    r = _Req(5, list(range(30, 50)), 4)
    assert pool.acquire_for(r) == slots[0]  # the slot is reused
    _mirror_agrees(pool)
    assert pool.lengths()[slots[0]] == r.prefix_hit_tokens == 0


def test_paged_pool_rejects_recurrent_arch_with_the_reference_message():
    cfg, api, _ = torch_side(RWKV_ARCH)
    jcfg, _, _ = jax_side(RWKV_ARCH)
    ek = dict(slots=2, max_len=32, kv_layout="paged")
    with pytest.raises(NotImplementedError) as got:
        PagedKVPool(api, EngineConfig(**ek))
    with pytest.raises(NotImplementedError) as want:
        jpaged.PagedKVPool(jax_build_model(jcfg), JaxEngineConfig(**ek))
    assert str(got.value) == str(want.value)


def test_engine_rejects_unknown_layout():
    cfg, api, tparams = torch_side()
    with pytest.raises(ValueError):
        ServingEngine(cfg, tparams, EngineConfig(kv_layout="interleaved"),
                      api=api)


# ---------------------------------------------------------------------------
# token identity: paged vs contiguous vs sequential
# ---------------------------------------------------------------------------


def _engine(layout, params=None, bs=8, blocks=0, prefix=True, slots=3,
            chunk=16, mixed=True, cache_dtype="float32"):
    cfg, api, _ = torch_side()
    if params is None:
        params = packed_pair(PALLAS)[1]
    return ServingEngine(cfg, params, EngineConfig(
        slots=slots, max_len=MAX_LEN, prefill_chunk=chunk,
        cache_dtype=cache_dtype, mixed_batches=mixed, kv_layout=layout,
        kv_block_size=bs, kv_blocks=blocks, prefix_cache=prefix), api=api)


def _sequential(prompt, gen, cache_dtype=torch.float32):
    """One request alone on the contiguous layout: the whole prompt in one
    call, then thin steps."""
    _, api, _ = torch_side()
    params = packed_pair(PALLAS)[1]
    cache = api.init_slot_cache(1, MAX_LEN, cache_dtype)
    logits, _ = api.decode_slots(params, torch.tensor([prompt]), cache,
                                 [len(prompt)])
    out = [int(logits[0, -1].argmax())]
    for _ in range(gen - 1):
        logits, _ = api.decode_slots(params, torch.tensor([[out[-1]]]), cache,
                                     [1])
        out.append(int(logits[0, 0].argmax()))
    return out


def _serve(eng, trace):
    reqs = [eng.submit(p, g) for p, g in trace]
    assert len(eng.run()) == len(trace)
    return reqs


_TRACE = [(3, 4), (17, 6), (33, 5), (9, 8), (40, 3)]


@pytest.mark.parametrize("block_size", [1, 4, 8, 12, 16],
                         ids=lambda b: f"bs{b}")
def test_paged_token_identical_across_block_sizes(block_size):
    """The mixed-length trace (multi-chunk prompts, varied generation
    budgets) comes out of the paged engine token for token as out of the
    contiguous one, for any block size — 12 divides neither the chunk
    (16) nor max_len (64), so chunk writes straddle blocks and the last
    block's excess is cut from the gathered view — and the NULL block
    stays zero."""
    cfg, _, _ = torch_side()
    rng = np.random.default_rng(3)
    trace = [(rng.integers(0, cfg.vocab, p).tolist(), g) for p, g in _TRACE]
    cont = [r.generated for r in _serve(_engine("contiguous"), trace)]
    eng = _engine("paged", bs=block_size)
    paged = [r.generated for r in _serve(eng, trace)]
    assert paged == cont, block_size
    assert eng.compile_count() == 2
    for key in ("k", "v"):
        assert not eng.pool.cache[key][:, NULL_BLOCK].any(), key
    if block_size == 16:
        for r, (prompt, gen) in zip(paged, trace):
            assert r == _sequential(prompt, gen)


def test_paged_mixed_batches_token_identical():
    """Decode rows riding chunk calls while another slot prefills, in both
    scheduler modes, under the paged layout."""
    cfg, _, _ = torch_side()
    rng = np.random.default_rng(23)
    prompt_a = rng.integers(0, cfg.vocab, 6).tolist()
    prompt_b = rng.integers(0, cfg.vocab, 35).tolist()
    outs = {}
    for mixed in (True, False):
        eng = _engine("paged", slots=2, mixed=mixed)
        ra = eng.submit(prompt_a, 12)
        eng.step()  # A decodes while B's multi-chunk prefill arrives
        assert ra.state == RequestState.DECODE
        rb = eng.submit(prompt_b, 5)
        eng.run()
        assert eng.compile_count() <= 2
        outs[mixed] = [ra.generated, rb.generated]
    assert outs[True] == outs[False]
    assert outs[True][0] == _sequential(prompt_a, 12)
    assert outs[True][1] == _sequential(prompt_b, 5)


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_paged_cursor_at_block_boundary_writes(cache_dtype):
    """decode_slots directly: a chunk ending on a block boundary, then two
    single-token writes starting a fresh block.  The paged blocks equal the
    contiguous cache bit for bit on the logical view, the logits equal,
    and the NULL block and unowned blocks stay untouched."""
    cfg, api, _ = torch_side()
    params = packed_pair(PALLAS)[1]
    dt = getattr(torch, cache_dtype)
    bs, s = 8, 32
    nb = s // bs
    cont = api.init_slot_cache(2, s, dt)
    paged = api.init_paged_cache(2 * nb + 1, bs, 2, dt)
    bt = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    rng = np.random.default_rng(0)
    toks = np.zeros((2, 16), np.int64)
    toks[0] = rng.integers(0, cfg.vocab, 16)
    lg_c, _ = api.decode_slots(params, torch.from_numpy(toks), cont, [16, 0])
    lg_p, _ = api.decode_slots(params, torch.from_numpy(toks), paged, [16, 0],
                               block_tables=bt, kv_len=s)
    assert torch.equal(lg_c[0], lg_p[0])
    for _ in range(2):
        t = np.zeros((2, 1), np.int64)
        t[0] = rng.integers(0, cfg.vocab)
        lg_c, _ = api.decode_slots(params, torch.from_numpy(t), cont, [1, 0])
        lg_p, _ = api.decode_slots(params, torch.from_numpy(t), paged, [1, 0],
                                   block_tables=bt, kv_len=s)
        assert torch.equal(lg_c[0], lg_p[0])
    assert paged["lengths"].tolist() == [18, 0]
    for key in ("k", "v"):
        pool = paged[key]  # (L, NB, H, BS, d)
        view = torch.cat([pool[:, b] for b in bt[0]], dim=2)
        assert torch.equal(view, cont[key][:, 0])
        assert not pool[:, NULL_BLOCK].any()
        assert not pool[:, 5:].any()  # slot 1 wrote nothing
    # a valid write whose table entry is the NULL block is refused
    bad = bt.copy()
    bad[0, 2] = NULL_BLOCK
    with pytest.raises(ValueError, match="NULL block"):
        api.decode_slots(params, torch.from_numpy(t), paged, [1, 0],
                         block_tables=bad, kv_len=s)


def test_paged_int8_cache_token_identical_to_contiguous():
    cfg, _, _ = torch_side()
    rng = np.random.default_rng(9)
    trace = [(rng.integers(0, cfg.vocab, p).tolist(), g) for p, g in _TRACE]
    cont = _serve(_engine("contiguous", cache_dtype="int8"), trace)
    eng = _engine("paged", bs=4, cache_dtype="int8")
    assert eng.pool.cache["k"].dtype == torch.int8
    paged = _serve(eng, trace)
    assert [r.generated for r in paged] == [r.generated for r in cont]


# ---------------------------------------------------------------------------
# copy-on-write and prefix reuse through the engine
# ---------------------------------------------------------------------------


def test_engine_prefix_hit_skips_prefill_and_cow_diverges():
    cfg, _, _ = torch_side()
    rng = np.random.default_rng(7)
    shared = rng.integers(0, cfg.vocab, 32).tolist()  # 4 blocks of 8
    eng = _engine("paged")
    warm = eng.submit(shared, 2)
    eng.run()
    assert warm.prefix_hit_tokens == 0
    base_shared = _sequential(shared, 4)
    assert warm.generated == base_shared[:2]
    full = eng.submit(shared, 4)  # identical prompt
    suffixed = eng.submit(shared + rng.integers(0, cfg.vocab, 5).tolist(), 4)
    eng.run()
    assert full.prefix_hit_tokens == 31  # capped one token early
    assert suffixed.prefix_hit_tokens == 32
    assert eng.pool.cow_copies == 1  # only the capped re-prefill copies
    assert full.generated == base_shared
    assert suffixed.generated == _sequential(suffixed.prompt, 4)
    snap = eng.snapshot()
    assert snap["prefix_hits"] == 2 and snap["prefix_hit_tokens"] == 63
    assert snap["cow_copies"] == 1 and snap["kv_layout"] == "paged"
    assert snap["mean_block_utilization"] is not None
    assert 0 <= snap["mean_block_fragmentation"] <= 1
    again = eng.submit(shared, 3)  # the cache survived the COW
    eng.run()
    assert again.prefix_hit_tokens == 31
    assert again.generated == base_shared[:3]


def test_engine_concurrent_sharers_decode_correctly():
    cfg, _, _ = torch_side()
    rng = np.random.default_rng(13)
    shared = rng.integers(0, cfg.vocab, 16).tolist()
    eng = _engine("paged")
    eng.submit(shared, 2)
    eng.run()
    rs = [eng.submit(shared + rng.integers(0, cfg.vocab, 3).tolist(), 6)
          for _ in range(2)]
    eng.run()
    assert all(r.prefix_hit_tokens == 16 for r in rs)
    for r in rs:
        assert r.generated == _sequential(r.prompt, 6)


def test_engine_no_capacity_stall_metric():
    cfg, _, _ = torch_side()
    eng = _engine("paged", blocks=8, prefix=False, slots=2)
    rng = np.random.default_rng(5)
    ra = eng.submit(rng.integers(0, cfg.vocab, 40).tolist(), 8)
    rb = eng.submit(rng.integers(0, cfg.vocab, 40).tolist(), 8)
    fin = eng.run()
    assert {r.rid for r in fin} == {ra.rid, rb.rid}
    snap = eng.snapshot()
    assert snap["no_capacity_stalls"] > 0 and snap["requests_rejected"] == 0
    for r in (ra, rb):
        assert r.generated == _sequential(r.prompt, 8)


def test_engine_rejects_request_larger_than_block_pool():
    cfg, _, _ = torch_side()
    eng = _engine("paged", blocks=5, prefix=False, slots=2)
    rng = np.random.default_rng(4)
    r = eng.submit(rng.integers(0, cfg.vocab, 40).tolist(), 8)  # 6 > 5
    assert r.state == RequestState.REJECTED and "KV blocks" in r.reject_reason
    ok = eng.submit(rng.integers(0, cfg.vocab, 24).tolist(), 8)
    assert len(eng.run()) == 1 and ok.finished
    with pytest.raises(ValueError):
        eng.pool.acquire_for(_Req(99, list(range(1, 41)), 8))


def test_eviction_skips_entries_still_referenced():
    pool = _pool(slots=3, blocks=10)
    resident = _Req(0, list(range(1, 17)), 8)  # 3 blocks, stays active
    s0 = pool.acquire_for(resident)
    pool.advance(np.asarray([16, 0, 0]))
    pool.register_prefix(s0, 16, 16)
    other = _Req(1, [7] * 16, 8)
    s1 = pool.acquire_for(other)
    pool.advance(np.asarray([0, 16, 0]))
    pool.register_prefix(s1, 16, 16)
    pool.release(s1)
    assert len(pool.prefix) == 4 and pool.allocator.n_used == 5
    big = _Req(2, list(range(100, 140)), 8)  # needs 6 of 5 free
    assert pool.acquire_for(big) is not None
    assert pool.prefix_evictions == 1
    assert pool.prefix.match(resident.block_hashes) == \
        pool._tables[s0].blocks[:2]


def test_prefix_cache_eviction_under_pressure():
    cfg, _, _ = torch_side()
    eng = _engine("paged", blocks=10, slots=2)
    rng = np.random.default_rng(19)
    for p in [rng.integers(0, cfg.vocab, 24).tolist() for _ in range(4)]:
        r = eng.submit(p, 2)
        eng.run()
        assert r.finished and r.generated == _sequential(p, 2)
    assert eng.pool.prefix_evictions > 0
    assert eng.snapshot()["prefix_evictions"] > 0


# ---------------------------------------------------------------------------
# parity with the JAX package on one trace
# ---------------------------------------------------------------------------


def test_paged_engine_tokens_and_pool_counters_equal_jax():
    """One trace with a warmed shared prefix (a block-aligned hit, a
    capped full-prompt hit that copies on write) through a pool small
    enough to evict: the port's paged engine emits the JAX paged engine's
    tokens, and its pool counts what the JAX pool counts."""
    jparams, tparams = packed_pair(PALLAS)
    jcfg, _, _ = jax_side()
    cfg, api, _ = torch_side()
    rng = np.random.default_rng(11)
    shared = rng.integers(0, cfg.vocab, 24).tolist()
    waves = [[(shared, 2)],
             [(shared, 3), (shared + rng.integers(0, cfg.vocab, 6).tolist(), 4),
              (rng.integers(0, cfg.vocab, 30).tolist(), 5)],
             [(rng.integers(0, cfg.vocab, 20).tolist(), 3),
              (shared + [1, 2], 3)]]
    ek = dict(slots=2, max_len=MAX_LEN, prefill_chunk=16,
              cache_dtype="float32", kv_layout="paged", kv_block_size=8,
              kv_blocks=8)
    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(**ek))
    teng = ServingEngine(cfg, tparams, EngineConfig(**ek), api=api)
    jreqs, treqs = [], []
    for wave in waves:
        jreqs += [jeng.submit(p, g) for p, g in wave]
        treqs += [teng.submit(p, g) for p, g in wave]
        jeng.run()
        teng.run()
    for j, t in zip(jreqs, treqs):
        assert t.finished and j.finished
        assert t.generated == j.generated, (t.rid, t.generated, j.generated)
        assert t.prefix_hit_tokens == j.prefix_hit_tokens, t.rid
    jp, tp = jeng.pool, teng.pool
    assert tp.allocator.n_used == jp.allocator.n_used
    assert tp.allocator.peak_used == jp.allocator.peak_used
    assert tp.cow_copies == jp.cow_copies >= 1
    assert tp.prefix_evictions == jp.prefix_evictions >= 1
    js, ts = jeng.metrics.snapshot(), teng.snapshot()
    for key in ("prefix_hits", "prefix_hit_tokens", "cow_copies",
                "prefix_evictions", "peak_blocks_in_use", "blocks_total",
                "prefix_cache_entries", "no_capacity_stalls",
                "generated_tokens", "prompt_tokens"):
        assert ts[key] == js[key], key
    assert ts["prefix_hits"] >= 2


def test_paged_layout_serves_through_the_cli(capsys):
    from repro_torch.launch.serve import main as serve_main

    serve_main(["--device", "cpu", "--requests", "3", "--slots", "2",
                "--max-len", "64", "--chunk", "8", "--kv-layout", "paged",
                "--block-size", "4", "--shared-prefix-pair"])
    out = capsys.readouterr().out
    assert "finished 3/3 requests, 2 compiled shapes" in out
    assert "layout=paged block_size=4 prefix_cache=True" in out
    assert "hit prefix_hit_tokens=32" in out  # min(4 chunks, max_len / 2)
