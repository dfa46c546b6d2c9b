"""Serving driver (port of the engine and lock-step parts of
``repro.launch.serve``).

A :class:`~repro_torch.numerics.NumericsSpec` (preset, JSON file, or built
in code) resolves against the float parameters into a plan, and
:func:`build_serving_params` executes it: float linears become packed
approximate modules, float leaves outside packs go bf16.  A spec whose
policy says ``"backend": "pallas"`` runs every approximate layer on the
hand-written CUDA kernel; the default CLI policy keeps the reference's
``"jnp"`` backend (the plain exact-integer path).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
        --spec-json spec.json --requests 8 --slots 4 --max-len 256

runs on the card (``--device cpu`` for the plain path on the CPU), for
every registered arch (``-reduced`` for the small CPU variant); the engine
keeps its KV cache in bf16, f32 or int8 (``--cache-dtype``) and refuses an
encoder-only arch (hubert-xlarge) and a sliding-window or parallel-SSM
arch (hymba-1.5b: ring caches and SSM state have no per-slot form), as the
reference's does.  ``--legacy`` runs the lock-step loop instead (one
prefill of a (B, T) token prompt, then G-1 greedy decode steps, the cache
in ``--cache-dtype``), for every ported arch:

    PYTHONPATH=src python -m repro_torch.launch.serve --legacy \
        --arch rwkv6-1.6b --spec-json spec.json --batch 4 --prompt-len 512

The engine takes the paged KV layout (``--kv-layout paged``, with
``--block-size``, ``--kv-blocks``, ``--no-prefix-cache`` and the warmed
``--shared-prefix-pair``), self-verifying speculative decode
(``--speculative-k K``: the numerics flags, or ``--draft-spec``, then
describe the draft; the verifier is the ``int8`` preset) and request
deadlines (``--deadline-ms``, with ``--submit-retries`` for queue-full
rejections) and the robustness layer: ``--error-probe-every N``
(approximate-vs-exact error moments of one served row every N steps),
``--governor --slo-err-var VAR`` (the accuracy-SLO ladder spec -> int8 ->
float, with ``--governor-window``, ``--governor-relax-after`` and
``--layer-slo PATTERN=VAR``), ``--inject-faults KIND@EVERY[@START-STOP]
[@LAYERS]`` with ``--fault-seed``, and ``--detect-faults`` (quarantine
replay of corrupted rows on the exact pack).  Observability:
``--trace-out FILE`` (the span trace, ``*.jsonl`` or Chrome JSON),
``--metrics-window SECONDS`` (the windowed time series, counter tracks in
the trace), ``--prom-out FILE`` (OpenMetrics text), ``--shadow-spec
NAME_OR_FILE --shadow-fraction F`` (A/B shadow replay, with
``--assert-shadow``) and ``--assert-layer-breach [PATTERN]`` (a governor
``layer_slo_breach`` present in the windowed per-layer series).
``--fleet`` serves through numerics tiers behind the spec-aware router
(``--tier SPEC=COUNT``, ``--route-policy``, ``--spill-threshold``,
``--share-prefixes-every``, ``--assert-prefix-share``, ``--trace-dir``):

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --fleet \
        --tier float=1 --tier serve-default=2 --kv-layout paged

The ``plan`` subcommand prints the per-layer assignment table (``--json``:
the PackPlan) from shapes alone, on the ``meta`` device:

    PYTHONPATH=src python -m repro_torch.launch.serve plan \
        --arch deepseek-67b --preset serve-default

``plan --diff-checkpoint SHARD`` also re-resolves the NumericsSpec saved in
a checkpoint shard's metadata (either package's) and exits with the number
of layers whose assignment differs from the CLI's spec.
"""

from __future__ import annotations

import argparse
import dataclasses
import fnmatch
import json
import sys
import time
from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.configs.registry import list_archs
from repro_torch.configs.base import ArchConfig, EngineConfig
from repro_torch.core.policy import ApproxPolicy
from repro_torch.models import build_model
from repro_torch.numerics import (NumericsSpec, PackPlan, apply_numerics,
                                  get_preset)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving numerics + cache configuration.  ``spec`` is the source of
    truth; ``policy`` alone is wrapped into the ``serve-default`` preset."""

    spec: NumericsSpec | None = None
    policy: ApproxPolicy | None = None
    act_range: tuple[float, float] = (-8.0, 8.0)  # default when uncalibrated
    cache_dtype: str = "bfloat16"
    fuse: bool = True  # fan-out fusion (Q|K|V, gate|up groups)

    def numerics_spec(self) -> NumericsSpec:
        if self.spec is not None:
            return self.spec
        return get_preset("serve-default", policy=self.policy)


def _to_device(tree: Any, dev: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):  # dense_blocks
        return type(tree)(_to_device(v, dev) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    return tree


def build_serving_params(params: Any, cfg: ArchConfig, scfg: ServeConfig,
                         act_ranges: dict | None = None,
                         plan: PackPlan | None = None, device=None) -> Any:
    """float params -> packed serving params on ``device`` (default
    ``cuda``; raises without it).  Only float leaves OUTSIDE packs go bf16;
    pack internals stay exact."""
    params = _to_device(params, resolve_device(device))
    if plan is None:
        plan = scfg.numerics_spec().resolve(params)
    packed = apply_numerics(params, plan, act_ranges=act_ranges,
                            default_range=scfg.act_range, fuse=scfg.fuse)

    def walk(node):
        if isinstance(node, nn.Module):
            return node
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):  # dense_blocks
            return type(node)(walk(v) for v in node)
        if (isinstance(node, torch.Tensor) and node.dtype == torch.float32
                and node.ndim >= 1):
            return node.to(torch.bfloat16)
        return node

    return walk(packed)


def build_serving_params_by_layer(cfg: ArchConfig, scfg: ServeConfig,
                                  seed: int = 0, device=None) -> Any:
    """``build_serving_params(api.init(seed), cfg, scfg)``, byte for byte,
    without the whole float32 tree: each layer is initialised on
    ``device`` in :func:`~repro_torch.models.lm.init_params`' order (the
    table, the scanned layers, the dense layers, the head) from one seeded
    generator, packed under its model path (``blocks`` or
    ``dense_blocks/i``) and cast, and its float leaves are freed before
    the next layer.  A float32 deepseek-v2-lite-16b (62.8 GB) and its
    serving copy do not fit on one 80 GB card together.  A layer's routed
    expert stacks, 3-D there and packable, are set aside float and stacked
    into the model's 4-D bf16 leaves, which the model's plan leaves float.
    The plan is resolved once on the ``meta`` tree; an ``auto`` rule,
    which needs the whole model's values, is refused by it.  Transformer
    archs only."""
    from repro_torch import seeded_generator
    from repro_torch.models import lm
    from repro_torch.nn.layers import init_norm

    dev = resolve_device(device)
    plan = scfg.numerics_spec().resolve(lm.init_params(cfg, seed, "meta"))

    def build(tree, prefix: str | None):
        """Pack ``tree`` with the plan's entries under ``prefix`` (None:
        the entries outside the layers)."""
        if prefix is None:
            entries = [e for e in plan.entries if not e.path.startswith(
                ("blocks/", "dense_blocks/"))]
        else:
            entries = [e for e in plan.entries if e.path.startswith(prefix)]
        return build_serving_params(
            tree, cfg, scfg, device=dev,
            plan=dataclasses.replace(plan, entries=tuple(entries)))

    gen = seeded_generator(dev, seed)
    d = cfg.d_model
    table = torch.randn(cfg.vocab, d, generator=gen, device=dev) * 0.02
    layers, experts = [], {}
    for i in range(cfg.n_scan_layers):
        bp = lm.init_block(cfg, gen, dev)
        if "experts" in bp["mlp"]:
            for name, leaf in bp["mlp"]["experts"].items():
                if name not in experts:
                    experts[name] = torch.empty(
                        (cfg.n_scan_layers,) + tuple(leaf["w"].shape),
                        dtype=torch.bfloat16, device=dev)
                experts[name][i] = leaf["w"]
            bp["mlp"]["experts"] = {}
        layers.append(build({"blocks": bp}, "blocks/")["blocks"])
        del bp
    blocks = lm.stack_layers(layers)
    del layers
    if experts:
        blocks["mlp"]["experts"] = {name: {"w": w}
                                    for name, w in experts.items()}
    out = {"embed": None, "blocks": blocks, "final_norm": None}
    if cfg.first_dense_layers:
        dense_cfg = dataclasses.replace(cfg, mlp="swiglu")
        out["dense_blocks"] = []
        for i in range(cfg.first_dense_layers):
            tree = [{}] * i + [lm.init_block(dense_cfg, gen, dev)]
            out["dense_blocks"].append(build(
                {"dense_blocks": tree}, f"dense_blocks/{i}/")[
                    "dense_blocks"][i])
            del tree
    top = {"embed": {"table": table},
           "final_norm": init_norm(cfg.norm, d, dev)}
    if not cfg.tie_embeddings:
        top["lm_head"] = {"w": torch.randn(d, cfg.vocab, generator=gen,
                                           device=dev) * d ** -0.5}
    del table
    out.update(build(top, None))
    return out


def _float_tree_fits(cfg: ArchConfig, dev: torch.device) -> bool:
    """Whether the float32 init and its serving copy (at most 2 bytes a
    parameter: bf16 leaves, 1-byte weight codes) fit in ``dev``'s free
    memory together; always on the CPU."""
    if dev.type != "cuda":
        return True
    return 6 * cfg.param_count() < torch.cuda.mem_get_info(dev)[0]


def _packed_init(cfg: ArchConfig, api, spec: NumericsSpec,
                 needs_float: list[str]) -> tuple[Any, Any]:
    """``(float init, its serving params)`` under ``spec``; where the two
    do not fit on the card together, the serving params alone, built a
    layer at a time, and None for the float init (refused when one of
    ``needs_float``, the flags that repack from it, was given)."""
    scfg = ServeConfig(spec=spec)
    if cfg.rwkv or _float_tree_fits(cfg, api.device):
        params = api.init(0)
        return params, build_serving_params(params, cfg, scfg,
                                            device=api.device)
    if needs_float:
        raise SystemExit(
            f"{', '.join(needs_float)} repack the float init of {cfg.name}, "
            f"which does not fit on {api.device} beside its serving copy; "
            "serve it without them")
    print(f"{cfg.name}: the float init and its serving copy do not fit on "
          f"{api.device} together; building the serving params a layer at "
          "a time")
    return None, build_serving_params_by_layer(cfg, scfg, device=api.device)


def _spec_from_args(args) -> NumericsSpec | None:
    """--spec-json wins, then --preset, then --mode/--m shorthand; None is
    float serving (no packing)."""
    if getattr(args, "spec_json", None):
        with open(args.spec_json) as f:
            return NumericsSpec.from_json(f.read())
    if getattr(args, "preset", None):
        return get_preset(args.preset)
    if args.mode == "float":
        return None
    policy = ApproxPolicy(args.mode, 0 if args.mode == "exact" else args.m,
                          use_cv=not args.no_cv)
    return get_preset("serve-default", policy=policy)


def _spec_by_name_or_file(text: str) -> NumericsSpec:
    """A preset name or a spec-JSON file path -> NumericsSpec."""
    from repro_torch.numerics import PRESETS

    if text in PRESETS:
        return get_preset(text)
    with open(text) as f:
        return NumericsSpec.from_json(f.read())


def _draft_spec_from_args(args) -> NumericsSpec:
    """The draft spec under speculation: ``--draft-spec`` (a preset name or
    a spec-JSON file), else what the numerics flags resolve to; the
    verifier is always the ``int8`` preset."""
    ds = getattr(args, "draft_spec", None)
    if ds:
        return _spec_by_name_or_file(ds)
    spec = _spec_from_args(args)
    if spec is None:
        raise SystemExit(
            "--speculative-k needs an approximate draft spec: float "
            "drafting buys nothing (pass --draft-spec, or --mode/--m)")
    return spec


def _prepare_speculative_params(params: Any, cfg: ArchConfig, args,
                               device=None):
    """The same float init packed twice: the ``int8`` preset verifies (and
    prefills), the draft spec proposes.  Returns ``(verify, verify label,
    draft, draft label)``."""
    verify_spec = get_preset("int8")
    draft_spec = _draft_spec_from_args(args)
    verify = build_serving_params(params, cfg, ServeConfig(spec=verify_spec),
                                  device=device)
    draft = build_serving_params(params, cfg, ServeConfig(spec=draft_spec),
                                 device=device)
    return verify, verify_spec.name, draft, draft_spec.name


def mixed_trace(cfg: ArchConfig, n_requests: int, max_len: int,
                prefill_chunk: int, seed: int = 0):
    """A heterogeneous request trace: short chat turns + long documents
    (the reference's generator: same seed, same trace)."""
    rng = np.random.default_rng(seed)
    trace = []
    for i in range(n_requests):
        if i % 3 == 2:  # long-document request
            plen = int(rng.integers(max_len // 2,
                                    max(max_len - 16, max_len // 2 + 1)))
        else:  # short chat turn
            plen = int(rng.integers(2, max(prefill_chunk, 3)))
        gen = int(rng.integers(4, 17))
        gen = min(gen, max_len - plen)
        plen = min(plen, max_len - gen)
        trace.append((rng.integers(0, cfg.vocab, plen).tolist(), gen))
    return trace


_CACHE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                 "int8": torch.int8}


def _cache_dt(scfg: ServeConfig) -> torch.dtype:
    try:
        return _CACHE_DTYPES[scfg.cache_dtype]
    except KeyError:
        raise ValueError(f"unknown cache_dtype {scfg.cache_dtype!r}; valid "
                         f"choices: {sorted(_CACHE_DTYPES)}") from None


def make_prefill_step(cfg: ArchConfig, max_len: int, mesh=None,
                      scfg: ServeConfig = ServeConfig(), device=None):
    api = build_model(cfg, device)

    def step(params, batch):
        return api.prefill(params, batch, max_len,
                           cache_dtype=_cache_dt(scfg), mesh=mesh)

    return step


def make_decode_step(cfg: ArchConfig, mesh=None,
                     scfg: ServeConfig = ServeConfig(), device=None):
    api = build_model(cfg, device)

    def step(params, tokens, cache):
        return api.decode_step(params, tokens, cache, mesh=mesh)

    return step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_legacy(args, params: Any = None) -> dict:
    """Lock-step batch loop: the prompt ``default_rng(0).integers(0, vocab,
    (batch, prompt_len))``, one prefill, ``gen - 1`` greedy decode steps,
    over a cache of ``args.cache_dtype`` (default bfloat16; the reference's
    loop always keeps bfloat16).  This is the path that serves the archs
    without a slot surface (hymba's ring caches and SSM state, hubert's
    encoder).  ``params`` are float parameters to serve instead of the
    seeded init.
    Returns the generated tokens (B, gen), the timings and the serving
    parameters."""
    cfg = get_config(args.arch)
    api = build_model(cfg, args.device)
    spec = _spec_from_args(args)
    label = "float"
    if spec is not None:
        if params is None:
            params = _packed_init(cfg, api, spec, [])[1]
        else:
            params = build_serving_params(params, cfg, ServeConfig(spec=spec),
                                          device=api.device)
        label = spec.name
    elif params is None:
        params = api.init(0)
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab,
                                          (args.batch, args.prompt_len)),
                             device=api.device)
    max_len = args.prompt_len + args.gen
    cache_dtype = getattr(args, "cache_dtype", "bfloat16")
    prefill = make_prefill_step(cfg, max_len,
                                scfg=ServeConfig(cache_dtype=cache_dtype),
                                device=api.device)
    decode = make_decode_step(cfg, device=api.device)

    _sync(api.device)
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": prompt})
    tok = torch.argmax(logits, -1)[:, None]
    _sync(api.device)
    t1 = time.perf_counter()
    outs = [tok]
    for _ in range(args.gen - 1):
        logits, cache = decode(params, tok, cache)
        tok = torch.argmax(logits, -1)[:, None]
        outs.append(tok)
    gen = torch.cat(outs, dim=1)
    _sync(api.device)
    t2 = time.perf_counter()
    dt = t2 - t0
    decode_s = (t2 - t1) / max(args.gen - 1, 1)
    print(f"arch={cfg.name} numerics={label} device={api.device}")
    print(f"generated {args.batch}x{args.gen} tokens in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print(f"prefill {args.batch}x{args.prompt_len}: {(t1 - t0) * 1e3:.1f} ms; "
          f"decode {decode_s * 1e3:.2f} ms/step")
    print("sample:", gen[0].cpu()[:16].tolist())
    return {"tokens": gen, "prefill_s": t1 - t0, "decode_s_per_step": decode_s,
            "tok_per_s": args.batch * args.gen / dt, "params": params,
            "numerics": label}


def _parse_layer_slos(items: list[str] | None) -> dict[str, float]:
    """``--layer-slo PATTERN=VAR`` (repeatable) -> {pattern: ceiling}."""
    out: dict[str, float] = {}
    for item in items or []:
        pattern, sep, var = item.partition("=")
        if not sep or not pattern:
            raise SystemExit(f"--layer-slo {item!r}: expected PATTERN=VAR "
                             "(e.g. 'blocks/0/*=1e-4')")
        try:
            out[pattern] = float(var)
        except ValueError:
            raise SystemExit(
                f"--layer-slo {item!r}: VAR must be a float") from None
    return out


def _robustness(args, cfg: ArchConfig, params_float, spec, label: str,
                device) -> tuple:
    """The governor (ladder spec -> int8 -> float over the float init, a
    ``pack_fn`` building each rung's pack), the fault injector and the
    exact pack quarantine replays run on, from the robustness flags.
    Returns ``(governor, pack_fn, injector, exact_params, probe_every)``."""
    governor = pack_fn = injector = exact_params = None
    probe_every = args.error_probe_every
    if args.governor:
        if spec is None:
            raise SystemExit(
                "--governor needs an approximate serving spec (float serving "
                "has nothing to degrade; speculative serving is exact "
                "already) — pass --mode/--m, --preset, or --spec-json")
        if args.slo_err_var is None:
            raise SystemExit("--governor needs --slo-err-var: the logits "
                             "error-variance ceiling the ladder enforces")
        from repro_torch.numerics import resolve_ladder
        from repro_torch.serving import GovernorConfig, NumericsGovernor

        rungs: list = [spec]
        if spec.name != "int8":
            rungs.append("int8")
        rungs.append("float")
        governor = NumericsGovernor(
            resolve_ladder(rungs, params_float), GovernorConfig(
                slo_err_var=args.slo_err_var,
                window_probes=args.governor_window,
                clean_windows_to_relax=args.governor_relax_after,
                layer_slo=_parse_layer_slos(args.layer_slo)))

        def pack_fn(s, _p=params_float):
            if s is None:
                return _p  # the "float" rung serves the raw init
            return build_serving_params(_p, cfg, ServeConfig(spec=s),
                                        device=device)

        if probe_every <= 0:
            probe_every = 4  # the governor consumes the probe; arm it
            print(f"governor: defaulting --error-probe-every to {probe_every}")
    if args.inject_faults:
        from repro_torch.quant.faults import FaultInjector, FaultSpec

        injector = FaultInjector(
            FaultSpec.parse(args.inject_faults, seed=args.fault_seed))
        if injector.spec.surface == "step" and label != "int8":
            # quarantine replays must run an exact pack; int8 IS exact
            exact_params = build_serving_params(
                params_float, cfg, ServeConfig(spec=get_preset("int8")),
                device=device)
    return governor, pack_fn, injector, exact_params, probe_every


def _report_robustness(eng, cfg: ArchConfig, finished, injector,
                       governor) -> None:
    """The fault and governor report lines (the reference CLI's format),
    with the no-corrupted-emission asserts of a step-surface campaign."""
    m = eng.metrics
    if injector is not None:
        print(f"  faults: injected={m.faults_injected} "
              f"detected={m.faults_detected} quarantines={m.quarantines} "
              f"replays={m.quarantine_replays}")
        if injector.spec.surface == "step":
            # every injected row was caught, rolled back and replayed on
            # the exact pack before emission
            assert m.faults_detected >= m.faults_injected, (
                m.faults_detected, m.faults_injected)
            assert m.quarantine_replays == m.faults_detected
            assert all(0 <= t < cfg.vocab for r in finished
                       for t in r.generated), "corrupted token emitted"
    if governor is not None:
        print(f"  governor: rung={eng.numerics} "
              f"switches={m.governor_switches} "
              f"(escalate {m.governor_escalations} / "
              f"relax {m.governor_relaxes})")
        for d in governor.decisions:
            dd = d.to_dict()
            print(f"    window {dd['window']}: {dd['action']} "
                  f"{dd['from']} -> {dd['to']} [{dd['reason']}] "
                  f"err_var={dd['err_var']} "
                  f"power_delta={dd['power_delta_pct']}%"
                  + (f" layer={dd['layer']}" if dd.get("layer") else ""))


def _report_observability(args, eng, label: str, shadow_label, governor
                          ) -> None:
    """The shadow verdict line and the ``--assert-shadow`` and
    ``--assert-layer-breach`` checks (the reference CLI's)."""
    verdict = eng.shadow_verdict()
    if verdict is not None:
        print(f"  shadow A/B [{label} vs {shadow_label}]: "
              f"{verdict['verdict']} — match "
              f"{verdict['token_match_rate']:.3f} over "
              f"{verdict['tokens']} tokens "
              f"({verdict['sampled_requests']} replays), "
              f"logits_err_var={verdict['logits_err_var']:.3g}, "
              f"power_delta={verdict['power_delta_pct']:+.2f}pp "
              f"[{verdict['reason']}]")
    if args.assert_shadow:
        # at least one finished request replayed and a verdict reached
        assert verdict is not None and verdict["sampled_requests"] >= 1, (
            f"shadow smoke expected >=1 sampled replay, got {verdict!r}")
    if args.assert_layer_breach is not None:
        pattern = args.assert_layer_breach or "*"
        # run_engine refused the flag up front without a governor
        breaches = [d.to_dict() for d in governor.decisions
                    if d.to_dict().get("reason") == "layer_slo_breach"]
        named = [d for d in breaches
                 if fnmatch.fnmatch(d.get("layer") or "", pattern)]
        assert named, (
            f"no governor escalation with reason=layer_slo_breach matching "
            f"layer pattern {pattern!r} (breaches seen: "
            f"{[d.get('layer') for d in breaches]})")
        # the breaching layer is visible in the windowed per-layer series
        layer = named[0]["layer"]
        windows_with = [s for s in eng.metrics.timeseries
                        if layer in (s.get("probe_layers") or {})]
        assert windows_with, (
            f"breaching layer {layer!r} absent from all "
            f"{len(eng.metrics.timeseries)} metrics_window samples")
        print(f"  layer-SLO breach: {layer} escalated "
              f"{named[0]['from']} -> {named[0]['to']}, present in "
              f"{len(windows_with)} window sample(s)")


def run_engine(args) -> dict:
    """Serve ``mixed_trace`` through the engine; returns the metrics
    snapshot."""
    from repro_torch.serving import ServingEngine

    if args.metrics_window < 0:
        raise SystemExit("--metrics-window: the windowed metrics interval "
                         f"must be >= 0 seconds, got {args.metrics_window}")
    if args.assert_layer_breach is not None and not (
            args.governor and args.layer_slo and args.metrics_window > 0):
        # checked up front: the assertion reads the governor's decisions
        # and the windowed per-layer series, which a run without them lacks
        raise SystemExit("--assert-layer-breach needs --governor with "
                         "--layer-slo and the windowed metrics "
                         "(--metrics-window > 0)")
    cfg = get_config(args.arch)
    api = build_model(cfg, args.device)
    spec_k = args.speculative_k
    draft = draft_label = None
    spec = None if spec_k else _spec_from_args(args)
    label = "float" if spec is None else spec.name
    if spec is not None:
        needs_float = [flag for flag, on in (
            ("--governor", args.governor),
            ("--inject-faults", args.inject_faults),
            ("--shadow-spec", args.shadow_spec)) if on]
        params_float, params = _packed_init(cfg, api, spec, needs_float)
    else:
        params_float = params = api.init(0)
    if spec_k:
        params, label, draft, draft_label = _prepare_speculative_params(
            params, cfg, args, device=api.device)
    governor, pack_fn, injector, exact_params, probe_every = _robustness(
        args, cfg, params_float, spec, label, api.device)
    # -- A/B shadow serving (repro_torch.serving.shadow) ---------------------
    shadow_params = shadow_label = None
    shadow_fraction = 0.0
    if args.shadow_spec:
        if spec_k:
            raise SystemExit("--shadow-spec is incompatible with "
                             "--speculative-k (the engine refuses mixed "
                             "draft/shadow dual-pack regimes)")
        if governor is not None:
            raise SystemExit("--shadow-spec is incompatible with --governor "
                             "(a hot-swapping primary makes the A/B verdict "
                             "a mixed-regime average)")
        shadow_spec = _spec_by_name_or_file(args.shadow_spec)
        shadow_params = build_serving_params(
            params_float, cfg, ServeConfig(spec=shadow_spec),
            device=api.device)
        shadow_label = shadow_spec.name
        shadow_fraction = args.shadow_fraction
    ecfg = EngineConfig(slots=args.slots, max_len=args.max_len,
                        prefill_chunk=args.chunk, cache_dtype=args.cache_dtype,
                        mixed_batches=not args.no_mixed,
                        kv_layout=args.kv_layout,
                        kv_block_size=args.block_size,
                        kv_blocks=args.kv_blocks,
                        prefix_cache=not args.no_prefix_cache,
                        trace=bool(args.trace_out),
                        metrics_window_s=args.metrics_window,
                        speculative_k=spec_k, error_probe_every=probe_every,
                        detect_faults=args.detect_faults,
                        shadow_fraction=shadow_fraction)
    eng = ServingEngine(cfg, params, ecfg, api=api, numerics=label,
                        draft_params=draft, draft_numerics=draft_label,
                        governor=governor, pack_fn=pack_fn,
                        fault_injector=injector, exact_params=exact_params,
                        shadow_params=shadow_params,
                        shadow_numerics=shadow_label)
    print(f"arch={cfg.name} numerics={label} slots={ecfg.slots} "
          f"max_len={ecfg.max_len} chunk={ecfg.prefill_chunk} "
          f"kv={ecfg.cache_dtype} mixed={ecfg.mixed_batches} "
          f"layout={ecfg.kv_layout}"
          + (f" block_size={ecfg.kv_block_size} "
             f"prefix_cache={ecfg.prefix_cache}"
             if ecfg.kv_layout == "paged" else "")
          + (f" speculative_k={spec_k} draft={draft_label}" if spec_k else "")
          + (f" governor=[{' -> '.join(r.name for r in governor.ladder)}] "
             f"slo_err_var={args.slo_err_var}" if governor else "")
          + (f" inject={injector.spec.kind}@{injector.spec.every} "
             f"seed={injector.spec.seed}" if injector else "")
          + (f" shadow={shadow_label} fraction={shadow_fraction}"
             if shadow_params is not None else "")
          + f" device={api.device}")
    trace = mixed_trace(cfg, args.requests, ecfg.max_len, ecfg.prefill_chunk)
    if args.shared_prefix_pair:
        # a warmed shared-prefix pair: the second request must attach to
        # the first one's cached blocks
        rng = np.random.default_rng(17)
        shared = rng.integers(
            0, cfg.vocab,
            min(4 * ecfg.prefill_chunk, ecfg.max_len // 2)).tolist()
        warm = eng.submit(shared, 2)
        eng.run()
        hit = eng.submit(shared + rng.integers(0, cfg.vocab, 4).tolist(), 4)
        eng.run()
        print(f"  shared-prefix pair: warm gen={len(warm.generated)} "
              f"hit prefix_hit_tokens={hit.prefix_hit_tokens}")
        if ecfg.kv_layout == "paged" and ecfg.prefix_cache:
            # sharing is full-block granular and capped one token early
            shareable = min(len(shared) // ecfg.kv_block_size
                            * ecfg.kv_block_size, len(shared) - 1)
            assert hit.prefix_hit_tokens >= shareable, (
                hit.prefix_hit_tokens, shareable)
    deadline = args.deadline_ms or None
    for prompt, gen in trace:
        r = eng.submit(prompt, gen, deadline_ms=deadline)
        # bounded retry with exponential backoff for queue-full rejections
        # only (a full queue drains; every other reason is permanent)
        attempt = 0
        while (r.state.value == "rejected"
               and (r.reject_reason or "").startswith("queue full")
               and attempt < args.submit_retries):
            for _ in range(2 ** attempt):  # backoff unit: one engine step
                eng.step()
            attempt += 1
            eng.metrics.requests_retried += 1
            r = eng.submit(prompt, gen, deadline_ms=deadline)
        if r.state.value == "rejected":
            print(f"  request {r.rid} rejected: {r.reject_reason}"
                  + (f" (after {attempt} retries)" if attempt else ""))
    finished = eng.run()
    snap = eng.snapshot()
    print(f"finished {len(finished)}/{len(trace)} requests, "
          f"{eng.compile_count()} compiled shapes")
    if args.assert_acceptance:
        acc = snap.get("acceptance_rate")
        assert acc is not None and acc > 0, (
            f"speculative smoke expected acceptance > 0, got {acc!r} "
            f"(drafted={snap.get('drafted_tokens')})")
        print(f"  speculative: acceptance_rate={acc} "
              f"drafted={snap['drafted_tokens']} "
              f"accepted={snap['accepted_draft_tokens']}")
    _report_robustness(eng, cfg, finished, injector, governor)
    _report_observability(args, eng, label, shadow_label, governor)
    print(json.dumps(snap, indent=2))
    if args.prom_out:
        from repro_torch.serving.prom import to_openmetrics

        with open(args.prom_out, "w") as f:
            f.write(to_openmetrics(snap, labels={"engine": eng.engine_id}))
        print(f"openmetrics: {args.prom_out}")
    if args.trace_out:
        eng.tracer.write(args.trace_out)
        print(f"trace: {len(eng.tracer)} spans "
              f"({eng.tracer.dropped} dropped) -> {args.trace_out}")
    for r in finished[:4]:
        print(f"  req {r.rid}: prompt {r.prompt_len:4d} -> gen "
              f"{len(r.generated):3d} [{r.finish_reason}] "
              f"sample {r.generated[:8]}")
    return snap


def _parse_tiers(items: list[str] | None) -> list:
    """``--tier SPEC=COUNT`` -> TierConfig list (tier name == spec name;
    SPEC is anything :func:`repro_torch.numerics.ladder_spec` resolves).
    Default: an exact-int8 latency tier and an approximate bulk tier, two
    replicas each."""
    from repro_torch.serving import TierConfig

    items = items or ["int8=2", "serve-default=2"]
    tiers = []
    for item in items:
        spec, sep, cnt = item.partition("=")
        if not spec:
            raise SystemExit(f"--tier {item!r}: expected SPEC=COUNT")
        try:
            count = int(cnt) if sep else 1
        except ValueError:
            raise SystemExit(
                f"--tier {item!r}: COUNT must be an integer") from None
        tiers.append(TierConfig(name=spec, spec=spec, count=count))
    return tiers


def run_fleet(args) -> dict:
    """``--fleet``: numerics tiers of replicas packed from ONE float init,
    behind the spec-aware router (:mod:`repro_torch.serving.fleet`).
    Serves ``mixed_trace`` classed: chat turns are latency traffic (exact
    tiers only), every third request, a long document, is bulk
    (approximate tiers, spilling into exact ones past
    ``--spill-threshold``).  Asserts that every latency request landed on
    an exact replica under ``spec-aware``; ``--assert-prefix-share``
    also asserts a cross-replica prefix-cache adoption.  Returns the fleet
    snapshot."""
    from repro_torch.numerics import ladder_spec
    from repro_torch.serving import build_fleet

    cfg = get_config(args.arch)
    tiers = _parse_tiers(args.tier)
    api = build_model(cfg, args.device)
    params_float = api.init(0)

    def pack(spec_name, _p=params_float):
        label, spec = ladder_spec(spec_name)
        if spec is None:
            return _p, label, None
        return (build_serving_params(_p, cfg, ServeConfig(spec=spec),
                                     device=api.device), label, spec)

    ecfg = EngineConfig(slots=args.slots, max_len=args.max_len,
                        prefill_chunk=args.chunk,
                        cache_dtype=args.cache_dtype,
                        mixed_batches=not args.no_mixed,
                        kv_layout=args.kv_layout,
                        kv_block_size=args.block_size,
                        kv_blocks=args.kv_blocks,
                        prefix_cache=not args.no_prefix_cache,
                        trace=bool(args.trace_dir))
    fleet = build_fleet(cfg, params_float, tiers, ecfg, pack, api=api,
                        policy=args.route_policy,
                        spill_threshold=args.spill_threshold or None)
    by_id = {r.replica_id: r for r in fleet.replicas}
    print(f"arch={cfg.name} fleet replicas={len(fleet.replicas)} "
          f"policy={fleet.policy} spill_threshold={fleet.spill_threshold} "
          f"layout={ecfg.kv_layout} device={api.device}")
    for rep in fleet.replicas:
        print(f"  replica {rep.replica_id}: numerics={rep.engine.numerics} "
              f"exact={rep.exact}")

    if args.assert_prefix_share:
        # warm ONE replica of a multi-replica tier, share, then a sibling
        # serves the same prompt from the imported blocks
        if ecfg.kv_layout != "paged" or not ecfg.prefix_cache:
            raise SystemExit("--assert-prefix-share needs --kv-layout "
                             "paged with the prefix cache enabled")
        pair = next((tuple(reps) for t in tiers
                     for reps in [[r for r in fleet.replicas
                                   if r.tier.name == t.name]]
                     if len(reps) >= 2), None)
        if pair is None:
            raise SystemExit("--assert-prefix-share needs a tier with "
                             ">= 2 replicas")
        warm_rep, cold_rep = pair[0], pair[1]
        rng = np.random.default_rng(17)
        shared = rng.integers(
            0, cfg.vocab,
            min(4 * ecfg.prefill_chunk, ecfg.max_len // 2)).tolist()
        warm_rep.engine.submit(shared, 2)
        warm_rep.engine.drain()
        imported = fleet.share_prefixes()
        hit = cold_rep.engine.submit(
            shared + rng.integers(0, cfg.vocab, 4).tolist(), 4)
        cold_rep.engine.drain()
        shareable = min(len(shared) // ecfg.kv_block_size
                        * ecfg.kv_block_size, len(shared) - 1)
        assert imported > 0, "share_prefixes imported nothing"
        assert hit.prefix_hit_tokens >= shareable, (
            hit.prefix_hit_tokens, shareable)
        print(f"  prefix share: {imported} blocks "
              f"{warm_rep.replica_id} -> fleet; {cold_rep.replica_id} "
              f"hit {hit.prefix_hit_tokens} tokens")

    trace = mixed_trace(cfg, args.requests, ecfg.max_len, ecfg.prefill_chunk)
    placed = []
    for i, (prompt, gen) in enumerate(trace):
        klass = "bulk" if i % 3 == 2 else "latency"
        prio = 0 if klass == "latency" else 1
        r = fleet.submit(prompt, gen, priority=prio, klass=klass)
        attempt = 0
        while (r.state.value == "rejected"
               and (r.reject_reason or "").startswith("queue full")
               and attempt < args.submit_retries):
            for _ in range(2 ** attempt):
                fleet.step()
            attempt += 1
            r = fleet.submit(prompt, gen, priority=prio, klass=klass)
        if r.state.value == "rejected":
            print(f"  request {r.rid} rejected: {r.reject_reason}")
        else:
            placed.append(r)
    finished = fleet.drain(share_every=args.share_prefixes_every or None)

    # the routing contract: latency-class requests only on exact replicas
    for r in placed:
        if r.fleet_class == "latency" and fleet.policy == "spec-aware":
            assert by_id[r.fleet_replica].exact, (
                f"latency request {r.rid} on approximate replica "
                f"{r.fleet_replica}")
    snap = fleet.snapshot()
    print(f"finished {len(finished)}/{len(placed)} placed requests, "
          f"{fleet.compile_count()} compiled shapes across the fleet")
    for tname, ts in snap["tiers"].items():
        print(f"  tier {tname}: numerics={ts['numerics']} "
              f"engines={ts['engines']} finished={ts['requests_finished']} "
              f"gen_tok={ts['generated_tokens']} "
              f"prefix_imports={ts['prefix_imports']}")
    rt = snap["routing"]
    print(f"  routing: {rt['routed_by_class']} spills={rt['spills']}")
    print(json.dumps(snap["fleet"], indent=2))
    if args.trace_dir:
        paths = fleet.write_traces(args.trace_dir)
        print(f"traces: {len(paths)} replica files -> {args.trace_dir}")
    if args.prom_out:
        from repro_torch.serving.prom import to_openmetrics

        with open(args.prom_out, "w") as f:
            f.write(to_openmetrics(snap["fleet"], labels={"fleet": "all"}))
        print(f"openmetrics: {args.prom_out}")
    return snap


def _plan_diff(plan: PackPlan, params, ckpt_path: str) -> int:
    """Compare a resolved plan against the NumericsSpec a checkpoint was
    saved with (its ``numerics`` metadata), re-resolved over the same
    shape-only parameters.  Prints per-layer drift rows; returns the number
    of drifted layers (the plan subcommand's exit code), so 0 == the
    checkpoint really will serve under the numerics the CLI describes."""
    from repro_torch.checkpoint.manager import read_meta

    meta = read_meta(ckpt_path)
    nd = (meta or {}).get("numerics")
    if nd is None:
        raise SystemExit(f"{ckpt_path}: checkpoint metadata carries no "
                         "numerics spec (saved before numerics persistence, "
                         "or not via save_pytree/CheckpointManager?)")
    ck_spec = NumericsSpec.from_dict(nd)
    ck_plan = ck_spec.resolve(params)
    mine = {e.path: e.label for e in plan.entries}
    theirs = {e.path: e.label for e in ck_plan.entries}
    drift = [(p, mine.get(p), theirs.get(p))
             for p in sorted(set(mine) | set(theirs))
             if mine.get(p) != theirs.get(p)]
    print(f"checkpoint spec: {ck_spec.name!r} ({ckpt_path})")
    if not drift:
        print(f"plan matches checkpoint: {len(mine)} layers, no drift")
        return 0
    print(f"PLAN DRIFT: {len(drift)} layer(s) differ (cli vs checkpoint)")
    for path, a, b in drift:
        print(f"  {path}: {a or '<absent>'} != {b or '<absent>'}")
    return len(drift)


def run_plan(args) -> PackPlan:
    """The ``plan`` subcommand: resolve and print the per-layer assignment
    table without packing.  The parameters are built on the ``meta``
    device (shapes only, the counterpart of ``jax.eval_shape``), so even
    deepseek-67b allocates nothing."""
    cfg = get_config(args.arch)

    def key_order(node):
        # the reference's eval_shape returns a pytree, whose dicts come
        # back in key order; the table lists layers in that order
        if isinstance(node, dict):
            return {k: key_order(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(key_order(v) for v in node)
        return node

    params = key_order(build_model(cfg, "meta").init(0))
    spec = _spec_from_args(args)
    if spec is None:
        raise SystemExit("nothing to plan for float serving (pick --preset, "
                         "--spec-json, or --mode/--m)")
    plan = spec.resolve(params)
    if args.json:
        print(plan.to_json(indent=2))
    else:
        print(f"arch={cfg.name} spec={spec.name}")
        print(plan.table())
    if getattr(args, "diff_checkpoint", None):
        drifted = _plan_diff(plan, params, args.diff_checkpoint)
        if drifted:
            raise SystemExit(drifted)
    return plan


def _add_numerics_flags(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--arch", default="olmo-1b-reduced",
                    choices=[a + sfx for a in list_archs()
                             for sfx in ("", "-reduced")])
    ap.add_argument("--mode", default="perforated",
                    choices=["float", "exact", "perforated", "recursive",
                             "truncated"])
    ap.add_argument("--m", type=int, default=2)
    ap.add_argument("--no-cv", action="store_true")
    ap.add_argument("--preset", default=None, help="numerics preset name")
    ap.add_argument("--spec-json", default=None, metavar="FILE",
                    help="serve under a NumericsSpec JSON file (the same "
                    "payload the reference package reads)")


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "plan":
        ap = argparse.ArgumentParser(prog="repro_torch.launch.serve plan")
        _add_numerics_flags(ap)
        ap.add_argument("--json", action="store_true",
                        help="emit the PackPlan as JSON instead of a table")
        ap.add_argument("--diff-checkpoint", default=None, metavar="PATH",
                        help="compare the plan with the NumericsSpec a "
                        "checkpoint shard was saved under; exits with the "
                        "number of drifted layers")
        run_plan(ap.parse_args(argv[1:]))
        return 0

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    _add_numerics_flags(ap)
    ap.add_argument("--engine", action="store_true",
                    help="continuous-batching engine (the default path; "
                    "--legacy wins when both are given)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--cache-dtype", default="bfloat16",
                    choices=sorted(_CACHE_DTYPES),
                    help="engine KV cache storage (int8: fixed point, steps "
                    "of 1/16)")
    ap.add_argument("--no-mixed", action="store_true",
                    help="alternate prefill and decode batches instead of "
                    "mixing decode rows into chunk-shaped calls")
    ap.add_argument("--kv-layout", default="contiguous",
                    choices=["contiguous", "paged"],
                    help="KV memory model: a max_len stripe a slot, or "
                    "blocks of a shared pool with prefix reuse")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens a KV block (paged layout)")
    ap.add_argument("--kv-blocks", type=int, default=0,
                    help="usable blocks in the pool (0 = the contiguous "
                    "layout's capacity)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable the content-hash shared-prefix cache")
    ap.add_argument("--shared-prefix-pair", action="store_true",
                    help="serve a warmed shared-prefix request pair first "
                    "and assert the prefix hit (paged layout)")
    ap.add_argument("--speculative-k", type=int, default=0, metavar="K",
                    help="self-verifying speculative decode: draft up to K "
                    "greedy tokens a slot through the approximate "
                    "parameters and verify them in one exact-int8 chunk "
                    "call (0 disables); the numerics flags then describe "
                    "the DRAFT spec")
    ap.add_argument("--draft-spec", default=None, metavar="NAME_OR_FILE",
                    help="draft NumericsSpec: a preset name or a spec-JSON "
                    "file (default: what --mode/--m/--preset resolve to)")
    ap.add_argument("--assert-acceptance", action="store_true",
                    help="fail unless the verifier accepted at least one "
                    "draft token")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request latency budget in ms from submission "
                    "(0 = none); expired queued requests are purged, "
                    "running ones stop with finish_reason 'deadline'")
    ap.add_argument("--submit-retries", type=int, default=3, metavar="N",
                    help="retry budget for queue-full submissions "
                    "(exponential backoff in engine steps: 1, 2, 4 ...)")
    ap.add_argument("--error-probe-every", type=int, default=0, metavar="N",
                    help="every N engine steps re-run one scheduled batch "
                    "row through the exact-int8 path and record "
                    "approx-vs-exact error moments (0 disables)")
    ap.add_argument("--governor", action="store_true",
                    help="attach the accuracy-SLO numerics governor: the "
                    "error probe's running variance estimate walks the "
                    "degradation ladder (CLI spec -> int8 -> float), "
                    "hot-swapping the live pack on breach and relaxing "
                    "back after clean windows")
    ap.add_argument("--slo-err-var", type=float, default=None, metavar="VAR",
                    help="accuracy SLO: max acceptable running logits "
                    "error variance (approx vs exact; required with "
                    "--governor)")
    ap.add_argument("--governor-window", type=int, default=4,
                    metavar="PROBES",
                    help="probe reports per governor window")
    ap.add_argument("--governor-relax-after", type=int, default=3,
                    metavar="WINDOWS",
                    help="consecutive clean windows before relaxing one "
                    "rung back down")
    ap.add_argument("--layer-slo", action="append", metavar="PATTERN=VAR",
                    help="per-layer accuracy SLO for the governor: fnmatch "
                    "layer-path pattern -> max probe err-var (e.g. "
                    "'blocks/0/*=1e-4'); first match wins; repeatable")
    ap.add_argument("--inject-faults", default=None, metavar="SPEC",
                    help="deterministic fault injection, "
                    "KIND@EVERY[@START-STOP][@LAYERS] with KIND in "
                    "nan|inf|spike|dense-noise (e.g. 'nan@8', "
                    "'dense-noise@2@10-50'); step-surface kinds corrupt "
                    "served logits and must be fully quarantined "
                    "(asserted), dense-noise corrupts the probe's "
                    "observation and drives the governor")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="fault injector RNG seed")
    ap.add_argument("--detect-faults", action="store_true",
                    help="NaN/divergence detection + quarantine replay even "
                    "without an injector")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="write the request-span trace here: *.jsonl for "
                    "JSONL, anything else for Chrome trace_event JSON "
                    "(opens in Perfetto); enables tracing")
    ap.add_argument("--metrics-window", type=float, default=0.0,
                    metavar="SECONDS",
                    help="windowed time-series sample interval (0 disables; "
                    "samples ride the trace as counters)")
    ap.add_argument("--shadow-spec", default=None, metavar="NAME_OR_FILE",
                    help="A/B shadow serving: replay a deterministic sample "
                    "of finished requests teacher-forced through a second "
                    "pack built under this spec (preset name or spec-JSON "
                    "path) and diff tokens, logits and modeled power; "
                    "incompatible with --speculative-k and --governor")
    ap.add_argument("--shadow-fraction", type=float, default=0.25,
                    metavar="F",
                    help="fraction of finished requests replayed through the "
                    "shadow pack (every-Nth sampling; default %(default)s)")
    ap.add_argument("--assert-shadow", action="store_true",
                    help="fail unless the shadow replayed >= 1 request and "
                    "reached a verdict")
    ap.add_argument("--assert-layer-breach", nargs="?", const="*",
                    default=None, metavar="PATTERN",
                    help="fail unless the governor escalated with reason "
                    "layer_slo_breach on a layer matching PATTERN (default "
                    "any) AND that layer appears in the windowed per-layer "
                    "err-var samples (needs --governor --layer-slo "
                    "--metrics-window)")
    ap.add_argument("--prom-out", default=None, metavar="FILE",
                    help="write the final metrics snapshot (engine, or the "
                    "merged fleet with --fleet) as OpenMetrics text")
    ap.add_argument("--fleet", action="store_true",
                    help="serve through numerics tiers of replicas behind "
                    "the spec-aware router instead of one engine; the "
                    "numerics flags are ignored, --tier chooses each "
                    "tier's spec")
    ap.add_argument("--tier", action="append", metavar="SPEC=COUNT",
                    help="one fleet tier: COUNT replicas packed under SPEC "
                    "(a preset name, 'float', or a spec-JSON path); "
                    "repeatable (default: int8=2 serve-default=2)")
    ap.add_argument("--route-policy", default="spec-aware",
                    choices=["spec-aware", "least-loaded", "round-robin"],
                    help="fleet routing policy (spec-aware: latency class -> "
                    "exact tiers, bulk -> approximate tiers, least-loaded "
                    "within each)")
    ap.add_argument("--spill-threshold", type=int, default=0, metavar="N",
                    help="bulk traffic spills from a saturated approximate "
                    "tier into the exact tiers once the least-loaded bulk "
                    "replica has >= N pending requests (0 disables; latency "
                    "traffic never spills to approximate tiers)")
    ap.add_argument("--share-prefixes-every", type=int, default=4,
                    metavar="STEPS",
                    help="propagate prefix-cache blocks across each tier's "
                    "replicas every N fleet iterations while draining (0 "
                    "disables)")
    ap.add_argument("--assert-prefix-share", action="store_true",
                    help="warm one replica, share, and assert a sibling "
                    "replica's prefix-cache hit on the imported blocks "
                    "(needs --kv-layout paged and a tier of >= 2 replicas)")
    ap.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="fleet tracing: one JSONL span trace a replica in "
                    "DIR (tools/trace_report.py --trace ... reads them)")
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (cuda by default; cpu runs the "
                    "plain PyTorch path)")
    ap.add_argument("--legacy", action="store_true",
                    help="lock-step prefill + greedy decode loop instead of "
                    "the continuous-batching engine")
    ap.add_argument("--batch", type=int, default=4, help="--legacy batch")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="--legacy prompt length")
    ap.add_argument("--gen", type=int, default=32,
                    help="--legacy tokens generated per row")
    args = ap.parse_args(argv)
    if args.cache_dtype == "int8" and get_config(args.arch).attn == "mla":
        raise SystemExit(
            f"--cache-dtype int8 is refused on {args.arch}: the reference "
            "writes MLA's RMS-normed latent with a raw int8 cast, which "
            "zeroes most of it (ROADMAP queue 3); use bfloat16 or float32")
    if args.legacy:
        run_legacy(args)
    elif args.fleet:
        run_fleet(args)
    else:
        run_engine(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
