"""The port's fleet, held against the reference's on olmo-1b-reduced
(float32 compute and KV cache):

* the reference's router cases (``tests/test_fleet.py``) on the port's
  ``FleetRouter`` over the port's own copy of the stub engine: class
  routing, least-loaded with the TTFT tie-break, spill from approximate
  tiers only, round-robin and least-loaded ignoring class, validation;
* prefix export: the port pool's chain hashes equal the JAX pool's byte
  for byte, in the same order, and the block contents equal them in
  float32 to ``ATOL`` + ``RTOL`` (the packages' float32 GEMMs sum in
  different orders); import round trip (refcount 1, idempotent, LRU
  evictable), an import-then-serve hit equal to the exporter's tokens,
  and blocks exported by the JAX pool served by the port;
* fleet tokens under every routing policy equal the JAX fleet's and a
  single engine of each tier's; tier-scoped sharing across replicas;
* the ``--fleet`` CLI's counters equal the JAX CLI's."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.configs.base import EngineConfig as JaxEngineConfig
from repro.launch.serve import ServeConfig as JaxServeConfig
from repro.launch.serve import build_serving_params as jax_build_serving_params
from repro.launch.serve import main as jax_serve_main
from repro.numerics import get_preset as jax_get_preset
from repro.serving import ServingEngine as JaxEngine
from repro.serving import TierConfig as JaxTierConfig
from repro.serving import build_fleet as jax_build_fleet
from repro_torch.configs import EngineConfig
from repro_torch.launch.serve import ServeConfig, build_serving_params
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import build_model
from repro_torch.numerics import get_preset
from repro_torch.serving import (FleetReplica, FleetRouter, ServingEngine,
                                 TierConfig, build_fleet)

from _torch_port import jax_side, torch_side

#: tolerances of exported K/V blocks against the reference's
RTOL, ATOL = 1e-5, 1e-5
_TIERS = ("int8", "serve-default")

# ---------------------------------------------------------------------------
# router units (no model)
# ---------------------------------------------------------------------------


class _StubRequest:
    def __init__(self, rid):
        self.rid = rid


class _StubEngine:
    """The replica-handle surface the router touches, minus the model."""

    def __init__(self, numerics="int8", pending=0, ttft=None):
        self.numerics = numerics
        self.pending = pending
        self.ttft = ttft
        self.tracer = None
        self.submitted = []
        self._rid = 0

    def load(self):
        return {"queued": 0, "prefilling": 0, "decoding": 0,
                "pending": self.pending, "slots": 4, "slots_free": 4,
                "ttft_mean_s": self.ttft}

    def submit(self, prompt, max_new_tokens, priority=0, **kw):
        r = _StubRequest(self._rid)
        self._rid += 1
        self.submitted.append(r)
        self.pending += 1
        return r

    @property
    def idle(self):
        return True


def _stub_fleet(policy="spec-aware", spill_threshold=None):
    reps = [FleetReplica(_StubEngine("int8"),
                         TierConfig("exact", "int8", count=2), i, exact=True)
            for i in range(2)]
    reps += [FleetReplica(_StubEngine("serve-default"),
                          TierConfig("bulk", "serve-default", count=2), i,
                          exact=False) for i in range(2)]
    return FleetRouter(reps, policy=policy, spill_threshold=spill_threshold)


def test_spec_aware_routes_by_class_and_priority():
    fl = _stub_fleet()
    lat = fl.submit([1, 2], 4, klass="latency")
    blk = fl.submit([1, 2], 4, klass="bulk")
    assert lat.fleet_tier == "exact" and not lat.fleet_spill
    assert blk.fleet_tier == "bulk" and not blk.fleet_spill
    assert fl.routed_by_class == {"latency": 1, "bulk": 1}
    assert fl.submit([1], 4, priority=0).fleet_class == "latency"
    assert fl.submit([1], 4, priority=3).fleet_class == "bulk"


def test_least_loaded_within_home_tier_with_ttft_tiebreak():
    fl = _stub_fleet()
    exact = [r for r in fl.replicas if r.exact]
    exact[0].engine.pending = 3
    assert fl.submit([1], 4, klass="latency").fleet_replica == \
        exact[1].replica_id
    exact[0].engine.pending = exact[1].engine.pending
    exact[0].engine.ttft = 0.01
    exact[1].engine.ttft = 0.50
    assert fl.submit([1], 4, klass="latency").fleet_replica == \
        exact[0].replica_id


def test_bulk_spills_to_exact_past_threshold_latency_never():
    fl = _stub_fleet(spill_threshold=2)
    for r in fl.replicas:
        if not r.exact:
            r.engine.pending = 2  # bulk side saturated
    spilled = fl.submit([1], 4, klass="bulk")
    assert spilled.fleet_spill and spilled.fleet_tier == "exact"
    assert fl.spills == 1
    for r in fl.replicas:  # exact side at the threshold too: stay home
        r.engine.pending = 2
    stuck = fl.submit([1], 4, klass="bulk")
    assert not stuck.fleet_spill and stuck.fleet_tier == "bulk"
    for _ in range(4):
        assert not fl.submit([1], 4, klass="latency").fleet_replica \
            .startswith("bulk")


def test_one_sided_fleets():
    reps = [FleetReplica(_StubEngine("serve-default"),
                         TierConfig("bulk", "serve-default"), 0, exact=False)]
    fl = FleetRouter(reps)
    with pytest.raises(ValueError, match="exact tier"):
        fl.submit([1], 4, klass="latency")
    assert fl.submit([1], 4, klass="bulk").fleet_tier == "bulk"
    fl = FleetRouter([FleetReplica(_StubEngine("int8"),
                                   TierConfig("exact", "int8"), 0,
                                   exact=True)])
    r = fl.submit([1], 4, klass="bulk")
    assert r.fleet_tier == "exact" and not r.fleet_spill


def test_round_robin_and_least_loaded_ignore_class():
    fl = _stub_fleet(policy="round-robin")
    seen = [fl.submit([1], 4, klass="latency").fleet_replica
            for _ in range(4)]
    assert len(set(seen)) == 4
    fl = _stub_fleet(policy="least-loaded")
    for r in fl.replicas[:-1]:
        r.engine.pending = 5
    assert fl.submit([1], 4, klass="latency").fleet_replica == \
        fl.replicas[-1].replica_id


def test_router_and_tier_validation():
    with pytest.raises(ValueError, match="at least one replica"):
        FleetRouter([])
    reps = [FleetReplica(_StubEngine(), TierConfig("t", "int8"), 0, True)]
    with pytest.raises(ValueError, match="routing policy"):
        FleetRouter(reps, policy="nope")
    with pytest.raises(ValueError, match="spill_threshold"):
        FleetRouter(reps, spill_threshold=0)
    with pytest.raises(ValueError, match="count"):
        TierConfig("t", "int8", count=0)
    with pytest.raises(ValueError, match="request class"):
        FleetRouter(reps).submit([1], 4, klass="interactive")
    with pytest.raises(ValueError, match="at least one TierConfig"):
        build_fleet(None, None, [], EngineConfig(), lambda s: None,
                    api=object())
    with pytest.raises(ValueError, match="duplicate tier names"):
        build_fleet(None, None, [TierConfig("a", "int8")] * 2,
                    EngineConfig(), lambda s: None, api=object())
    assert get_preset("int8").is_exact
    assert not get_preset("serve-default").is_exact


class _BusyStub(_StubEngine):
    """Busy for ``busy`` steps, then idle; counts prefix exports."""

    def __init__(self, busy):
        super().__init__()
        self.busy = busy
        self.exports = 0

    @property
    def idle(self):
        return self.busy == 0

    def step(self):
        self.busy -= 1
        return []

    def export_prefix(self):
        self.exports += 1
        return []


def test_drain_counts_fleet_steps_and_shares_every_n():
    engines = [_BusyStub(7), _BusyStub(3)]
    fl = FleetRouter([FleetReplica(e, TierConfig("t", "int8"), i, True)
                      for i, e in enumerate(engines)])
    assert fl.drain(share_every=3) == [] and fl.idle
    assert fl.steps == 7  # the fleet iterates until its busiest replica idles
    assert [e.exports for e in engines] == [2, 2]  # after steps 3 and 6
    engines[1].busy = 2
    fl.drain(max_steps=1)
    assert fl.steps == 8 and not fl.idle


# ---------------------------------------------------------------------------
# prefix export and import (reduced model)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sides():
    jcfg, _, jparams = jax_side()
    tcfg, _, tparams = torch_side()
    jcfg = dataclasses.replace(jcfg, compute_dtype="float32")
    tcfg = dataclasses.replace(tcfg, compute_dtype="float32")
    packs = {name: (
        jax_build_serving_params(jparams, jcfg, JaxServeConfig(
            spec=jax_get_preset(name))),
        build_serving_params(tparams, tcfg, ServeConfig(
            spec=get_preset(name)), device="cpu"))
        for name in _TIERS}
    return jcfg, tcfg, packs, build_model(tcfg, "cpu")


def _ekw(layout="paged", slots=3, cache_dtype="float32"):
    return dict(slots=slots, max_len=64, prefill_chunk=16,
                cache_dtype=cache_dtype, kv_layout=layout, kv_block_size=8)


def _engines(sides, pack="int8", **kw):
    jcfg, tcfg, packs, api = sides
    return (ServingEngine(tcfg, packs[pack][1], EngineConfig(**_ekw(**kw)),
                          api=api, numerics=pack),
            JaxEngine(jcfg, packs[pack][0], JaxEngineConfig(**_ekw(**kw)),
                      numerics=pack))


def test_prefix_export_equals_reference_and_round_trips(sides):
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, sides[1].vocab, 24).tolist()  # 3 full blocks
    warm, jwarm = _engines(sides)
    for eng in (warm, jwarm):
        eng.submit(prompt, 2)
        eng.run()
    entries, jentries = warm.export_prefix(), jwarm.export_prefix()
    assert len(entries) == 3
    assert [h for h, _ in entries] == [h for h, _ in jentries]
    for (_, content), (_, jcontent) in zip(entries, jentries):
        assert content.keys() == jcontent.keys()
        for k, v in content.items():
            assert v.device.type == "cpu" and v.dtype == torch.float32
            np.testing.assert_allclose(v.float().numpy(),
                                       np.asarray(jcontent[k], np.float32),
                                       rtol=RTOL, atol=ATOL)
    cold, _ = _engines(sides)
    assert cold.import_prefix(entries) == 3
    assert cold.metrics.prefix_imports == cold.pool.prefix_imports == 3
    held = dict(cold.pool.prefix.items())
    for h, content in entries:
        bid = held[h]
        assert cold.pool.allocator.refcount(bid) == 1
        for k, v in content.items():
            assert torch.equal(cold.pool.cache[k][:, bid], v)
    assert cold.import_prefix(entries) == 0  # idempotent
    assert cold.snapshot()["prefix_imports"] == 3
    free = cold.pool.allocator.n_free
    for _ in range(3):
        assert cold.pool.prefix.evict_lru(cold.pool.allocator)
    assert not cold.pool.prefix.evict_lru(cold.pool.allocator)
    assert cold.pool.allocator.n_free == free + 3
    contiguous, _ = _engines(sides, layout="contiguous")
    assert contiguous.export_prefix() == []
    assert contiguous.import_prefix(entries) == 0


def test_import_then_serve_hits_and_matches_exporter(sides):
    """Blocks exported by the port pool, and by the JAX pool (converted to
    host tensors), serve a hit whose tokens equal the exporter's."""
    rng = np.random.default_rng(4)
    shared = rng.integers(0, sides[1].vocab, 24).tolist()
    suffix = rng.integers(0, sides[1].vocab, 4).tolist()
    warm, jwarm = _engines(sides)
    refs = []
    for eng in (warm, jwarm):
        eng.submit(shared, 2)
        eng.run()
        refs.append(eng.submit(shared + suffix, 5))
        eng.run()
    assert refs[0].generated == refs[1].generated
    jentries = [(h, {k: torch.from_numpy(np.array(v))
                     for k, v in c.items()})
                for h, c in jwarm.export_prefix()]
    for entries in (warm.export_prefix(), jentries):
        cold, _ = _engines(sides)
        assert cold.import_prefix(entries) > 0
        hit = cold.submit(shared + suffix, 5)
        cold.run()
        assert hit.prefix_hit_tokens == 24
        assert hit.generated == refs[0].generated


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
def test_prefix_round_trip_bit_equal_in_cache_dtype(sides, cache_dtype):
    """Blocks of a bf16 or int8 (with scales) cache travel through the host
    in the cache's own dtype: every imported leaf is bit-equal to the
    exporter's block, and the sibling's hit serves the exporter's tokens."""
    rng = np.random.default_rng(5)
    shared = rng.integers(0, sides[1].vocab, 24).tolist()
    suffix = rng.integers(0, sides[1].vocab, 4).tolist()
    warm, _ = _engines(sides, cache_dtype=cache_dtype)
    warm.submit(shared, 2)
    warm.run()
    entries = warm.export_prefix()
    assert len(entries) == 3
    cold, _ = _engines(sides, cache_dtype=cache_dtype)
    assert cold.import_prefix(entries) == 3
    src, dst = dict(warm.pool.prefix.items()), dict(cold.pool.prefix.items())
    assert src.keys() == dst.keys()
    for h in src:
        for k in warm.pool._block_keys:
            a = warm.pool.cache[k][:, src[h]].contiguous()
            b = cold.pool.cache[k][:, dst[h]].contiguous()
            assert a.dtype == b.dtype
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), k
    ref = warm.submit(shared + suffix, 5)
    warm.run()
    hit = cold.submit(shared + suffix, 5)
    cold.run()
    assert ref.prefix_hit_tokens == hit.prefix_hit_tokens == 24
    assert hit.generated == ref.generated


# ---------------------------------------------------------------------------
# fleet against the JAX fleet and single engines
# ---------------------------------------------------------------------------


def _jobs(vocab, n=4, seed=6):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(rng.integers(4, 22))).tolist(), 5)
            for _ in range(n)]


@pytest.fixture(scope="module")
def references(sides):
    """Per tier: the jobs served by ONE port engine under its pack."""
    _, tcfg, packs, api = sides
    jobs = _jobs(tcfg.vocab)
    refs = {}
    for name in _TIERS:
        eng = ServingEngine(tcfg, packs[name][1], EngineConfig(
            **_ekw("contiguous")), api=api)
        reqs = [eng.submit(p, g) for p, g in jobs]
        eng.run()
        refs[name] = [r.generated for r in reqs]
    return jobs, refs


@pytest.mark.parametrize("policy",
                         ["spec-aware", "least-loaded", "round-robin"])
def test_fleet_tokens_match_jax_fleet_and_single_engines(sides, references,
                                                         policy):
    jcfg, tcfg, packs, api = sides
    jobs, refs = references
    fleets = []
    for side, build, tier_cls, ecls in (
            (1, build_fleet, TierConfig, EngineConfig),
            (0, jax_build_fleet, JaxTierConfig, JaxEngineConfig)):
        get = (jax_get_preset, get_preset)[side]
        fleet = build(
            (jcfg, tcfg)[side], None, [tier_cls(n, n) for n in _TIERS],
            ecls(**_ekw("contiguous")),
            pack=lambda n, s=side, g=get: (packs[n][s], n, g(n)),
            api=api if side else None, policy=policy)
        placed = [fleet.submit(p, g, klass="bulk" if i % 2 else "latency")
                  for i, (p, g) in enumerate(jobs)]
        fleet.drain()
        fleets.append((fleet, placed))
    (fleet, placed), (jfleet, jplaced) = fleets
    for i, (r, j) in enumerate(zip(placed, jplaced)):
        assert (r.fleet_replica, r.fleet_class, r.fleet_spill) == \
            (j.fleet_replica, j.fleet_class, j.fleet_spill)
        assert r.finish_reason == "length"
        assert r.generated == j.generated == refs[r.fleet_tier][i]
        if policy == "spec-aware" and r.fleet_class == "latency":
            assert r.fleet_tier == "int8"
    snap, jsnap = fleet.snapshot(), jfleet.snapshot()
    assert snap["routing"] == jsnap["routing"]
    assert snap["replicas"] == jsnap["replicas"]
    assert snap["fleet"]["numerics"] == "mixed"
    assert snap["fleet"]["engines"] == 2
    for key in ("requests_finished", "generated_tokens", "prompt_tokens",
                "prefill_steps", "decode_steps", "mixed_steps"):
        assert snap["fleet"][key] == jsnap["fleet"][key], key
        for t in _TIERS:
            assert snap["tiers"][t][key] == jsnap["tiers"][t][key], (t, key)
    assert fleet.compile_count() <= 2 * len(fleet.replicas)


def test_fleet_shares_prefixes_within_a_tier(sides, tmp_path):
    """Two int8 replicas and one serve-default: a share carries the warm
    int8 replica's blocks to its sibling only (sharing is tier-scoped);
    traces a replica, each event carrying its engine id."""
    _, tcfg, packs, api = sides
    ecfg = EngineConfig(**_ekw(), trace=True)
    fleet = build_fleet(
        tcfg, None, [TierConfig("int8", "int8", count=2),
                     TierConfig("serve-default", "serve-default")], ecfg,
        pack=lambda n: (packs[n][1], n, get_preset(n)), api=api)
    r0, r1, r2 = fleet.replicas
    shared = np.random.default_rng(7).integers(0, tcfg.vocab, 24).tolist()
    warm = r0.engine.submit(shared, 4)
    r0.engine.drain()
    assert fleet.share_prefixes() == 3
    assert r2.engine.metrics.prefix_imports == 0
    hit = r1.engine.submit(shared, 4)
    r1.engine.drain()
    assert hit.prefix_hit_tokens == len(shared) - 1
    assert hit.generated == warm.generated
    assert fleet.share_prefixes() == 0  # converged
    snap = fleet.snapshot()
    assert snap["tiers"]["int8"]["prefix_imports"] == 3
    assert snap["fleet"]["prefix_imports"] == 3
    paths = fleet.write_traces(str(tmp_path))
    assert len(paths) == 3
    for path, rep in zip(paths, fleet.replicas):
        with open(path) as f:
            engines = {json.loads(ln)["engine"] for ln in f}
        # the serve-default replica served nothing: an empty trace
        assert engines == ({rep.replica_id} if rep.tier.name == "int8"
                           else set())
    kinds = {json.loads(ln)["kind"] for ln in open(paths[1])}
    assert "prefix_import" in kinds and "prefix_hit" in kinds


def _cli_counters(out: str) -> dict:
    lines = out.splitlines()
    pick = lambda key: [ln for ln in lines if key in ln]  # noqa: E731
    return {"tiers": pick("  tier "), "routing": pick("  routing:"),
            "finished": [ln.split(",")[0] for ln in pick("placed requests")],
            "share": pick("  prefix share:"), "replicas": pick("  replica ")}


def test_fleet_cli_counters_match_jax_cli(tmp_path, capsys):
    flags = ["--fleet", "--tier", "int8=1", "--tier", "serve-default=2",
             "--kv-layout", "paged", "--block-size", "8", "--requests", "6",
             "--slots", "2", "--max-len", "64", "--chunk", "16",
             "--spill-threshold", "1", "--assert-prefix-share"]
    serve_main(["--device", "cpu"] + flags + [
        "--trace-dir", str(tmp_path / "port"),
        "--prom-out", str(tmp_path / "port.prom")])
    tout = capsys.readouterr().out
    jax_serve_main(flags)
    jout = capsys.readouterr().out
    tc, jc = _cli_counters(tout), _cli_counters(jout)
    assert tc == jc and tc["share"] and tc["tiers"]
    assert len(list((tmp_path / "port").iterdir())) == 3
    assert "repro_prefix_imports" in (tmp_path / "port.prom").read_text()
