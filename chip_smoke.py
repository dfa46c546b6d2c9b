"""Card check for the PyTorch/CUDA port: `python3 chip_smoke.py`.

Drives the port (`src/repro_torch`, no JAX) on one CUDA card:

1. device: name and power limit; TF32 off;
2. build: compiles the CUDA kernels from the checkout's sources;
3. kernels: every kernel against its plain PyTorch version on the card,
   for every multiplier mode, at the serving shapes, plus exact-integer
   accumulator checks;
4. main path: full-width olmo-1b served by the port's continuous-batching
   engine with `backend: "pallas"` packs; checks completion, the kernel
   launch count the schedule implies, device placement, determinism and
   that the control variate reaches the logits;
5. kernel times at the path's shapes (kernel, plain, library, bound).

Prints the card line and one `kernels` JSON line before the last line, and
ends with `{"ok": true, "device": {...}}`.  Any failure exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: data-sheet peaks by card name: (memory bytes/s, dense int8 ops/s)
CARD_PEAKS = {
    "H100 80GB HBM3": (3.35e12, 1979e12),  # SXM5
    "H100 PCIe": (2.0e12, 1513e12),
    "H100 NVL": (3.9e12, 1671e12),
}

#: kernel comparison tolerance: the kernel and its plain version run the
#: same float32 epilogue operations in the same order (the kernel is built
#: with -fmad=false), so they agree to rounding; rtol on the value, plus an
#: absolute floor of the same size relative to the output's scale for
#: outputs that cancel to near zero
RTOL = 2e-5

MODES = [("perforated", 1), ("perforated", 2), ("perforated", 4),
         ("recursive", 2), ("recursive", 4), ("truncated", 5),
         ("truncated", 7), ("exact", 0)]
#: (K, N) of the packed layers at olmo-1b width: fused qkv, o/q/k/v,
#: fused gate|up, down; decode steps run gate and up as (2048, 8192)
PATH_KN = [(2048, 6144), (2048, 2048), (2048, 16384), (8192, 2048)]
DECODE_KN = [(2048, 2048)] * 4 + [(2048, 8192)] * 2 + [(8192, 2048)]
PREFILL_KN = PATH_KN


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def peaks(name: str) -> tuple[float, float]:
    for key, val in CARD_PEAKS.items():
        if key in name:
            return val
    fail(f"no data-sheet peaks for card {name!r}: add it to CARD_PEAKS")


# ---------------------------------------------------------------------------
# pack construction at a given shape (random codes, realistic constants)
# ---------------------------------------------------------------------------


def random_pack(torch, k: int, n: int, mode: str, m: int, gen, dev,
                fused_members: int = 1):
    """A blocked pack from random float weights through the port's own
    packing path (pack_linear -> concat_packs -> build_blocked_layout)."""
    from repro_torch.quant.quantize import (build_blocked_layout,
                                            calibrate_minmax, concat_packs,
                                            pack_linear)

    widths = [n // fused_members] * fused_members
    packs = [pack_linear(torch.randn(k, w, generator=gen, device=dev)
                         * k ** -0.5, None, mode, m) for w in widths]
    pack = packs[0] if len(packs) == 1 else concat_packs(packs)
    a_qp = calibrate_minmax(-4.0, 4.0, device=dev)
    return pack, a_qp, build_blocked_layout(pack, a_qp)


def close(torch, got, want) -> float:
    """Max abs error; fails unless |got - want| <= RTOL*(|want| + scale)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    scale = float(want.abs().max()) if want.numel() else 0.0
    bad = err > RTOL * (want.abs() + scale)
    if bool(bad.any()):
        fail(f"kernel disagrees with its plain version: max abs err "
             f"{float(err.max())} at scale {scale}")
    return float(err.max()) if err.numel() else 0.0


def check_kernels(torch, dev) -> dict:
    """Phase 3: both kernels against their plain versions on the card."""
    from repro_torch.kernels import approx_matmul as amk
    from repro_torch.core import multipliers as am

    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"approx_matmul_cv_fused": 0.0, "approx_matmul_cv": 0.0}
    shapes = [(mm, k, n) for mm in (4, 128) for k, n in PATH_KN] + [(5, 200, 48)]
    n_cases = 0
    for mode, m in MODES:
        for mm, k, n in shapes:
            pack, a_qp, blocked = random_pack(torch, k, n, mode, m, gen, dev,
                                              fused_members=3 if n == 6144 else 1)
            for dt in (torch.bfloat16, torch.float32):
                x = (torch.randn(mm, k, generator=gen, device=dev) * 1.5).to(dt)
                got = amk.approx_matmul_cv_fused(
                    x, blocked.w_qb, blocked.epilogue, blocked.meta, k=k, n=n,
                    mode=mode, m=m, use_cv=True)
                want = amk.approx_matmul_cv_fused_plain(
                    x, blocked.w_qb, blocked.epilogue, blocked.meta, k=k, n=n,
                    mode=mode, m=m, use_cv=True)
                torch.cuda.synchronize()
                if got.dtype != dt or got.shape != (mm, n):
                    fail(f"fused kernel output {got.dtype} {tuple(got.shape)}")
                errs["approx_matmul_cv_fused"] = max(
                    errs["approx_matmul_cv_fused"], close(torch, got, want))
                n_cases += 1
            # codes-in kernel on the same pack (per-tensor quant params are
            # exact for an unfused pack; use the first member's for fused)
            a_q = torch.randint(0, 256, (mm, k), generator=gen, device=dev,
                                dtype=torch.uint8)
            meta = torch.tensor([0.015, 0.02, 7.0, 131.0, float(k)],
                                device=dev)
            bias = torch.randn(n, generator=gen, device=dev)
            args = (a_q, pack.w_q, pack.c, pack.c0, pack.sum_qw, bias, meta)
            got = amk.approx_matmul_cv(*args, mode=mode, m=m)
            want = amk.approx_matmul_cv_plain(*args, mode=mode, m=m)
            torch.cuda.synchronize()
            errs["approx_matmul_cv"] = max(errs["approx_matmul_cv"],
                                           close(torch, got, want))
            n_cases += 1
        # exact integer accumulators: sa = sw = 1, za = zw = 0, no bias, no
        # CV, integer x in [0, 255] (codes == x); K <= 258 keeps the f32
        # output an exact integer, so it must equal the scalar oracle
        for mm in (4, 128):
            k, n = 258, 96
            w_q = torch.randint(0, 256, (k, n), generator=gen, device=dev,
                                dtype=torch.uint8)
            a_q = torch.randint(0, 256, (mm, k), generator=gen, device=dev,
                                dtype=torch.uint8)
            want = am.approx_matmul_ref(a_q, w_q, mode, m).to(torch.float32)
            epi = torch.zeros(8, n, device=dev)
            epi[4] = 1.0  # EPI_SW
            meta = torch.zeros(1, 8, device=dev)
            meta[0, 0], meta[0, 2] = 1.0, float(k)  # sa, true_k
            got1 = amk.approx_matmul_cv_fused(
                a_q.float(), w_q, epi, meta, k=k, n=n, mode=mode, m=m,
                use_cv=False)
            zeros = torch.zeros(n, device=dev)
            got2 = amk.approx_matmul_cv(
                a_q, w_q, zeros, zeros, torch.zeros(n, dtype=torch.int32,
                                                    device=dev), zeros,
                torch.tensor([1.0, 1.0, 0.0, 0.0, float(k)], device=dev),
                mode=mode, m=m, use_cv=False)
            torch.cuda.synchronize()
            for name, got in (("fused", got1), ("codes", got2)):
                if not torch.equal(got, want):
                    fail(f"{name} kernel accumulator not exact for {mode} m={m}"
                         f" M={mm}: max diff {float((got - want).abs().max())}")
            n_cases += 2
    print(f"kernels: {n_cases} cases agree with their plain versions "
          f"(rtol {RTOL}); max abs err {errs}", flush=True)
    return errs


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_calls(torch, fns, reps: int = 21) -> float:
    """Median device seconds per call: the calls of ``fns`` (distinct
    operand copies, so the 50 MB L2 cannot serve one call's weights from
    the previous one) are captured once into a CUDA graph, and each of
    ``reps`` graph replays is timed with CUDA events.  The graph removes the
    host's launch overhead, which would otherwise be what is timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns:  # warm-up outside the capture
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for f in fns:
            f()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / 1e3 / len(fns))
    del graph
    return statistics.median(times)


def kernel_times(torch, dev, card: str) -> list[dict]:
    """Phase 5: per-shape times of both kernels, their plain versions, the
    library matmul the approximate layer replaces, and the bound
    (perforated m=2 + CV, bf16 activations, as served)."""
    from repro_torch.kernels import approx_matmul as amk

    bw, int8_peak = peaks(card)
    mode, m = "perforated", 2
    n_planes = amk._mode_args(mode, m, True)[0]
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    shapes = sorted({(4, k, n) for k, n in DECODE_KN + PATH_KN}
                    | {(128, k, n) for k, n in PATH_KN})
    for mm, k, n in shapes:
        pack, a_qp, blocked = random_pack(torch, k, n, mode, m, gen, dev)
        w_bytes = blocked.w_qb.numel()
        # enough operand copies that the 50 MB L2 cannot serve one call's
        # weights from the previous call (as in a served step)
        copies = max(2, -(-(128 << 20) // w_bytes))
        blks = [blocked] + [type(blocked)(
            w_qb=blocked.w_qb.clone(), epilogue=blocked.epilogue.clone(),
            meta=blocked.meta.clone(), k=k, n=n, bk=blocked.bk, bn=blocked.bn)
            for _ in range(copies - 1)]
        wqs = [pack.w_q] + [pack.w_q.clone() for _ in range(copies - 1)]
        x = torch.randn(mm, k, generator=gen, device=dev).to(torch.bfloat16)
        a_q = torch.randint(0, 256, (mm, k), generator=gen, device=dev,
                            dtype=torch.uint8)
        meta5 = torch.tensor([0.015, 0.02, 7.0, 131.0, float(k)], device=dev)
        bias = torch.zeros(n, device=dev)
        fused = dict(
            kern=[lambda b=b: amk.approx_matmul_cv_fused(
                x, b.w_qb, b.epilogue, b.meta, k=k, n=n, mode=mode, m=m)
                for b in blks],
            plain=[lambda b=b: amk.approx_matmul_cv_fused_plain(
                x, b.w_qb, b.epilogue, b.meta, k=k, n=n, mode=mode, m=m)
                for b in blks[:2]],
            nbytes=(x.numel() * 2 + w_bytes + blocked.epilogue.numel() * 4
                    + blocked.meta.numel() * 4 + mm * n * 2))
        codes = dict(
            kern=[lambda w=w: amk.approx_matmul_cv(
                a_q, w, pack.c, pack.c0, pack.sum_qw, bias, meta5, mode=mode,
                m=m) for w in wqs],
            plain=[lambda w=w: amk.approx_matmul_cv_plain(
                a_q, w, pack.c, pack.c0, pack.sum_qw, bias, meta5, mode=mode,
                m=m) for w in wqs[:2]],
            nbytes=(mm * k + k * n + 4 * 4 * n + 4 * 5 + mm * n * 4))
        w_f = [torch.randn(k, n, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(copies)]
        t_lib = time_calls(torch, [lambda w=w: torch.matmul(x, w) for w in w_f])
        t_ops = 2.0 * mm * k * n * (1 + n_planes) / int8_peak
        for name, d in (("approx_matmul_cv_fused", fused),
                        ("approx_matmul_cv", codes)):
            t_bytes = d["nbytes"] / bw
            rows.append({"kernel": name, "M": mm, "K": k, "N": n,
                         "kernel_us": time_calls(torch, d["kern"]) * 1e6,
                         "plain_us": time_calls(torch, d["plain"], reps=5) * 1e6,
                         "library_us": t_lib * 1e6,
                         "bound_us": max(t_bytes, t_ops) * 1e6,
                         "bound_by": ("bytes" if t_bytes >= t_ops
                                      else "operations")})
            print("time " + json.dumps(rows[-1]), flush=True)
        del blks, wqs, w_f, fused, codes
    return rows


def step_entry(rows: list[dict], name: str, kn_list, mm) -> dict:
    """Sums over one layer's launches of one step kind."""
    by = {(r["kernel"], r["M"], r["K"], r["N"]): r for r in rows}
    sel = [by[(name, mm, k, n)] for k, n in kn_list]
    out = {key: sum(r[key] for r in sel)
           for key in ("kernel_us", "plain_us", "library_us", "bound_us")}
    by_bytes = sum(r["bound_us"] for r in sel if r["bound_by"] == "bytes")
    out["bound_by"] = ("bytes" if by_bytes >= out["bound_us"] / 2
                       else "operations")
    return out


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------


def run_main_path(torch, dev, n_layers: int) -> dict:
    """Phase 4: full-width olmo-1b through the port's engine."""
    import dataclasses

    from repro_torch.configs import EngineConfig, get_config
    from repro_torch.core.approx_linear import iter_tensors
    from repro_torch.core.policy import ApproxPolicy
    from repro_torch.kernels import approx_matmul as amk
    from repro_torch.launch.serve import (ServeConfig, build_serving_params,
                                          mixed_trace)
    from repro_torch.models import build_model
    from repro_torch.numerics import get_preset
    from repro_torch.serving import ServingEngine

    cfg = get_config("olmo-1b")
    if n_layers != cfg.n_layers:
        print(f"main: depth cut {cfg.n_layers} -> {n_layers} layers "
              "(widths unchanged)", flush=True)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    print(f"main: {cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"heads={cfg.n_heads} kv={cfg.kv_heads} head_dim={cfg.head_dim} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab} tied={cfg.tie_embeddings} "
          f"compute={cfg.compute_dtype}", flush=True)
    api = build_model(cfg, dev)
    t0 = time.perf_counter()
    params = api.init(0)

    def spec_for(use_cv):
        return get_preset("serve-default", policy=ApproxPolicy(
            "perforated", 2, use_cv=use_cv, backend="pallas"))

    spec = spec_for(True)
    packed = build_serving_params(params, cfg, ServeConfig(spec=spec), device=dev)
    packed_nocv = build_serving_params(params, cfg,
                                       ServeConfig(spec=spec_for(False)),
                                       device=dev)
    del params
    torch.cuda.synchronize()
    pack_bytes = sum(t.numel() * t.element_size() for t in iter_tensors(packed))
    print(f"main: init + pack {time.perf_counter() - t0:.1f} s; "
          f"serving params {pack_bytes / 2**30:.3f} GiB", flush=True)

    ecfg = EngineConfig(slots=4, max_len=256, prefill_chunk=32,
                        cache_dtype="bfloat16")
    trace = mixed_trace(cfg, 8, ecfg.max_len, ecfg.prefill_chunk, seed=0)
    # warm-up outside the measured run: one chunk-shaped and one thin call
    warm = api.init_slot_cache(ecfg.slots, ecfg.max_len, torch.bfloat16)
    for c in (ecfg.prefill_chunk, 1):
        api.decode_slots(packed, torch.zeros(ecfg.slots, c, dtype=torch.long,
                                             device=dev), warm,
                         [c] * ecfg.slots)
    del warm
    torch.cuda.synchronize()

    eng = ServingEngine(cfg, packed, ecfg, api=api, numerics=spec.name)
    torch.cuda.reset_peak_memory_stats()
    amk.approx_matmul_cv_fused.launches = 0
    amk.approx_matmul_cv.launches = 0
    reqs = [eng.submit(p, g) for p, g in trace]
    finished = eng.run()
    torch.cuda.synchronize()
    launches = {"approx_matmul_cv_fused": amk.approx_matmul_cv_fused.launches,
                "approx_matmul_cv": amk.approx_matmul_cv.launches}
    snap = eng.snapshot()
    peak = torch.cuda.max_memory_allocated()

    if len(finished) != len(trace) or not all(
            r.finished and len(r.generated) == g for r, (_, g) in zip(reqs, trace)):
        fail(f"main: finished {len(finished)}/{len(trace)} requests")
    if any(not 0 <= t < cfg.vocab for r in reqs for t in r.generated):
        fail("main: token id out of the vocabulary")
    chunk_steps = snap["prefill_steps"] + snap["mixed_steps"]
    expected = cfg.n_layers * (4 * chunk_steps + 7 * snap["decode_steps"])
    print(f"main: steps prefill={snap['prefill_steps']} mixed="
          f"{snap['mixed_steps']} decode={snap['decode_steps']}; wrapper "
          f"launches {launches} expected fused {expected} (each fused call "
          f"is two CUDA launches: quantize, then matmul)", flush=True)
    if launches["approx_matmul_cv_fused"] != expected:
        fail(f"main: {launches['approx_matmul_cv_fused']} fused launches, the "
             f"schedule implies {expected}")
    if launches["approx_matmul_cv_fused"] == 0:
        fail("main: the path never launched the kernel")
    off = [t.device for t in iter_tensors(packed) if t.device.type != "cuda"]
    off += [t.device for t in iter_tensors(eng.pool.cache)
            if t.device.type != "cuda"]
    if off:
        fail(f"main: {len(off)} parameter/cache tensors off the card: {off[:3]}")

    # determinism and the CV's reach: one chunk-shaped call on a fresh cache,
    # twice with the CV pack (equal logits), once without CV (different)
    g = torch.Generator(device=dev).manual_seed(5)
    toks = torch.randint(0, cfg.vocab, (ecfg.slots, ecfg.prefill_chunk),
                         generator=g, device=dev)
    nv = [ecfg.prefill_chunk] * ecfg.slots

    def chunk_logits(p):
        cache = api.init_slot_cache(ecfg.slots, ecfg.max_len, torch.bfloat16)
        return api.decode_slots(p, toks, cache, nv)[0]

    l1, l2, l3 = chunk_logits(packed), chunk_logits(packed), chunk_logits(packed_nocv)
    torch.cuda.synchronize()
    if l1.shape != (ecfg.slots, ecfg.prefill_chunk, cfg.vocab) \
            or l1.dtype != torch.float32 or not bool(torch.isfinite(l1).all()):
        fail(f"main: logits {l1.dtype} {tuple(l1.shape)} not finite f32")
    if not torch.equal(l1, l2):
        fail("main: two identical calls gave different logits")
    if torch.equal(l1, l3):
        fail("main: the no-CV pack gave the CV pack's logits")
    print(f"main: deterministic; CV moves logits by max "
          f"{float((l1 - l3).abs().max()):.4g}", flush=True)

    # the kernel path against the plain path on the same inputs: the whole
    # model again with the kernel wrappers swapped for their plain versions
    # (every other operation is the same deterministic GPU code), so the
    # logits of a chunk-shaped and a thin call must be equal
    import contextlib

    @contextlib.contextmanager
    def plain_kernels():
        """Swaps the fused wrapper for its plain version; fails unless the
        plain version ran and the kernel did not."""
        kern, before, calls = (amk.approx_matmul_cv_fused,
                               amk.approx_matmul_cv_fused.launches, [0])

        def plain(*a, **kw):
            calls[0] += 1
            return amk.approx_matmul_cv_fused_plain(*a, **kw)

        amk.approx_matmul_cv_fused = plain
        try:
            yield
        finally:
            amk.approx_matmul_cv_fused = kern
        if calls[0] == 0 or kern.launches != before:
            fail(f"main: plain run made {calls[0]} plain calls and "
                 f"{kern.launches - before} kernel launches")

    thin = toks[:, :1]
    lk_thin = api.decode_slots(packed, thin, api.init_slot_cache(
        ecfg.slots, ecfg.max_len, torch.bfloat16), [1] * ecfg.slots)[0]
    with plain_kernels():
        lp = chunk_logits(packed)
        lp_thin = api.decode_slots(packed, thin, api.init_slot_cache(
            ecfg.slots, ecfg.max_len, torch.bfloat16), [1] * ecfg.slots)[0]
    torch.cuda.synchronize()
    if not (torch.equal(l1, lp) and torch.equal(lk_thin, lp_thin)):
        fail(f"main: kernel path differs from the plain path by "
             f"{float((l1 - lp).abs().max())} (chunk), "
             f"{float((lk_thin - lp_thin).abs().max())} (thin)")
    print("main: full-depth logits through the kernels equal the plain "
          "path's (chunk-shaped and thin calls)", flush=True)

    breakdown = {kind: profile_call(torch, api, packed, ecfg, c)
                 for kind, c in (("thin", 1), ("chunk", ecfg.prefill_chunk))}

    main_line = json.dumps({
        "requests_finished": snap["requests_finished"],
        "generated_tokens": snap["generated_tokens"],
        "prompt_tokens": snap["prompt_tokens"],
        "elapsed_s": snap["elapsed_s"],
        "gen_tok_per_s": snap["gen_tok_per_s"],
        "total_tok_per_s": snap["total_tok_per_s"],
        "ttft_p50_s": snap["ttft_p50_s"], "ttft_p95_s": snap["ttft_p95_s"],
        "itl_p50_s": snap["itl_p50_s"], "itl_p95_s": snap["itl_p95_s"],
        "peak_mem_gib": peak / 2**30, "pack_gib": pack_bytes / 2**30,
        "launches": launches, "step_breakdown": breakdown})
    print("main: " + main_line, flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "main_path.json").write_text(main_line + "\n")
    return launches


def profile_call(torch, api, params, ecfg, c: int) -> dict:
    """Wall time of one (slots, c) model step (host clock around a
    synchronised call, median of 5) against its device time (the kernels'
    self time from torch.profiler), and the kernels that take the most."""
    from torch.profiler import ProfilerActivity, profile

    dev = api.device
    toks = torch.zeros(ecfg.slots, c, dtype=torch.long, device=dev)

    def call():
        cache = api.init_slot_cache(ecfg.slots, ecfg.max_len, torch.bfloat16)
        api.decode_slots(params, toks, cache, [c] * ecfg.slots)

    call()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    # host time by function (cProfile adds its own cost per Python call, so
    # only the shares are read from it)
    import cProfile
    import io
    import pstats

    cprof = cProfile.Profile()
    cprof.enable()
    call()
    torch.cuda.synchronize()
    cprof.disable()
    buf = io.StringIO()
    pstats.Stats(cprof, stream=buf).sort_stats("tottime").print_stats(25)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / f"host_profile_c{c}.txt").write_text(buf.getvalue())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            call()
        torch.cuda.synchronize()

    def dev_us(evt):
        return getattr(evt, "self_device_time_total",
                       getattr(evt, "self_cuda_time_total", 0.0))

    events = [e for e in prof.key_averages() if dev_us(e) > 0]
    device_s = sum(dev_us(e) for e in events) / 3 / 1e6
    wall_s = statistics.median(walls)
    top = sorted(events, key=dev_us, reverse=True)[:6]
    out = {"wall_ms": wall_s * 1e3,
           "device_ms": device_s * 1e3 if events else None,
           "device_idle_share": 1 - device_s / wall_s if events else None,
           "top_device_us": {e.key[:48]: dev_us(e) / 3 for e in top}}
    print(f"main: profile (slots, {c}) step: " + json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=16,
                    help="olmo-1b depth for the main path (widths are never "
                    "cut)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this check runs on the card only")
    import repro_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda")
    card = card_line()
    peaks(card)  # a card without data-sheet peaks fails here, not at the end
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {card}; allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    from repro_torch.kernels import approx_matmul as amk

    t0 = time.perf_counter()
    amk.build()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    if amk.BUILD_LOG:
        os.makedirs(ROOT / "chiprun_out", exist_ok=True)
        (ROOT / "chiprun_out" / "build.log").write_text(amk.BUILD_LOG["output"])
        for line in amk.BUILD_LOG["output"].splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas " + line.strip(), flush=True)

    errs = check_kernels(torch, dev)
    launches = run_main_path(torch, dev, args.layers)
    rows = kernel_times(torch, dev, card)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "kernel_times.json").write_text(
        json.dumps({"card": card, "rows": rows}, indent=1))
    entries = []
    for name, src_line in (("approx_matmul_cv_fused", 332),
                           ("approx_matmul_cv", 166)):
        dec = step_entry(rows, name, DECODE_KN, 4)
        pre = step_entry(rows, name, PREFILL_KN, 128)
        print(f"{name} per layer, decode step (7 launches, M=4): "
              + json.dumps(dec), flush=True)
        print(f"{name} per layer, prefill step (4 launches, M=128): "
              + json.dumps(pre), flush=True)
        entries.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/approx_matmul.cu",
            "replaces": f"src/repro/kernels/approx_matmul.py:{src_line}",
            # wrapper calls on the main path (a fused call runs the
            # quantize kernel and the matmul kernel)
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": (dec["kernel_us"] + pre["kernel_us"]) / 1e3,
            "plain_ms": (dec["plain_us"] + pre["plain_us"]) / 1e3,
            "bound_ms": (dec["bound_us"] + pre["bound_us"]) / 1e3,
            "bound_by": dec["bound_by"],
            "library_ms": (dec["library_us"] + pre["library_us"]) / 1e3,
        })
    print(card, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
