"""Cell runner ``lm_engine``: a decoder LM served through the port's
continuous-batching engine (``repro_torch.serving.engine.ServingEngine``:
``submit``/``step`` over the model's ``decode_slots``) under a
closed-loop mix.

Set-up makes the float weights from the seed on the card
(:mod:`port_bench.weights`), packs them through the program
(``launch.serve.build_serving_params`` under the configuration's
numerics spec), builds the engine with a proxy of the model API whose
``decode_slots`` records every call's token shape and ``n_valid``, and
warms up the engine's two shapes (chunk and thin) with requests of its
own.  The window then runs ``clients`` closed-loop clients for
``--seconds``; every request is stamped by the harness (submit, and each
token through ``on_token``).  With ``--trace 1`` the proxy also reads the
slots' cursors and synchronises at the end of each call, so the device
time of a step is charged to the model step, and the profiler traces the
middle ``TRACE_SECONDS`` of the window.

Correctness, once the window has closed, against the plain reference
(:mod:`port_bench.ref_lm`), which works everything out again from the
same tokens:

* the served logits: a sample of the requests finished in the window,
  drawn from the seed with the longest among them.  For each token
  served to them the proxy kept, on the card, the logits row that the
  model step returned for it (column ``n_valid - 1`` of the slot's row,
  in the compute type, which holds the head's output exactly).  The
  reference runs every layer, the final norm and the tied head over the
  prompt and the served tokens; the number is one minus the correlation
  of the two rows over the vocabulary, the mean over every served token.
  It covers all the layers and the head; the 8-bit activation codes turn
  rounding differences into noise over the 16 layers (PERF.md), so it
  catches a head or a layer run on the wrong rows or on garbage, not a
  small drift.
* the state the timed path wrote, the slot cache: for the requests in
  the slots at the window's close (a sample drawn from the seed, the
  longest among them), the keys and values of the first layers at every
  position a request holds, the RMS difference over the reference's RMS
  of the worst layer of a group.  The first layers cover the embedding,
  the norms, activation quantization, the approximate products and
  their CV epilogue at the engine's chunk and thin shapes, RoPE, the
  slot attention over the cache that the chunks wrote, the MLP and the
  cache writes at each row's cursor, before the codes' noise grows.
* every token served in the window has to be the greedy choice of the
  logits row that the model step returned for it (the proxy takes the
  argmax of every row a call returns, on the card), an exact comparison.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from port_bench import ref_lm, trace, traffic, weights
from port_bench.harness import stamp

#: seconds of the window that a ``--trace 1`` run profiles (its middle)
TRACE_SECONDS = 4.0
#: the check samples' streams of the seed (in the slots, finished)
_SAMPLE, _SAMPLE_DONE = 4, 6
_WARM = 5


@dataclasses.dataclass
class Stamped:
    """One request as the client saw it."""

    t_submit: float
    prompt: list
    max_new: int
    log: "StepLog"
    times: list = dataclasses.field(default_factory=list)
    #: (token, the model-step call that produced it, the request's slot)
    served: list = dataclasses.field(default_factory=list)
    req: object = None

    def on_token(self, req, token) -> None:
        self.times.append(time.perf_counter())
        self.served.append((int(token), len(self.log.calls) - 1, req.slot))


class StepLog:
    """The proxy of the model's ``decode_slots``: records each call while
    ``on``; ``timed`` reads the cursors before and synchronises after.
    ``keep`` is the type the served rows are kept in: the compute type,
    in which the head computes, so that it holds them exactly."""

    def __init__(self, fn, timed: bool, cuda: bool, keep: torch.dtype):
        self.fn, self.timed, self.cuda, self.keep = fn, timed, cuda, keep
        self.calls: list[dict] = []
        #: per recorded call, on the device: the argmax of every logits row
        #: it returned (one launch; the rows a token is read from are
        #: picked once the window has closed)
        self.greedy: list = []
        #: per recorded call, on the device: each slot's row at its column
        #: ``n_valid - 1`` (slots, vocab), the row a served token is read
        #: from; the column comes from the cursors on the device, so
        #: keeping it waits for nothing
        self.rows: list = []
        self.on = False
        self.in_trace = False

    def __call__(self, params, tokens, cache, n_valid, **kw):
        lengths = (cache["lengths"].cpu().numpy().astype(np.int64)
                   if self.timed else None)
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.decode_slots"):
            before = cache["lengths"].clone() if self.on else None
            out = self.fn(params, tokens, cache, n_valid, **kw)
            if self.on:
                logits = out[0]
                self.greedy.append(logits.argmax(-1))
                col = (cache["lengths"] - before - 1).clamp(min=0).long()
                slot = torch.arange(len(col), device=col.device)
                self.rows.append(logits[slot, col].to(self.keep))
            if self.timed and self.cuda:
                torch.cuda.synchronize()
        t1 = time.perf_counter()
        if self.on:
            self.calls.append({
                "shape": tuple(tokens.shape),
                "n_valid": np.asarray(n_valid, dtype=np.int64).copy(),
                "lengths": lengths, "t0": t0, "t1": t1,
                "traced": self.in_trace})
        return out


def not_greedy(stamped, log: StepLog) -> int:
    """Served tokens that are not the greedy choice of the logits row that
    the model step returned for them: column ``n_valid - 1`` of the
    slot's row, where the step returns every column."""
    if not log.greedy:
        return sum(len(s.served) for s in stamped)
    table = [g.cpu().numpy() for g in log.greedy]
    bad = 0
    for s in stamped:
        for tok, call, slot in s.served:
            g = table[call][slot]
            if g.ndim:
                g = g[max(int(log.calls[call]["n_valid"][slot]) - 1, 0)]
            bad += int(tok != g)
    return bad


def build(cell, dev):
    """(arch config, packed params, model api) of the cell's model."""
    from repro_torch.configs.base import ArchConfig
    from repro_torch.launch.serve import ServeConfig, build_serving_params
    from repro_torch.models import build_model
    from repro_torch.numerics import NumericsSpec

    arch = cell.config["arch"]
    cfg = ArchConfig(**arch)
    spec = NumericsSpec.from_dict(cell.config["numerics"])
    stamp(cell, "imports and the card")
    tree = weights.lm_tree(arch, cell.seed, dev)
    stamp(cell, "weights")
    scfg = ServeConfig(spec=spec, act_range=tuple(cell.config["act_range"]),
                       cache_dtype=cell.traffic["engine"]["cache_dtype"])
    packed = build_serving_params(tree, cfg, scfg, device=dev)
    del tree
    stamp(cell, "pack")
    return cfg, spec, packed, build_model(cfg, dev)


def warm_up(engine, ecfg, vocab: int, seed: int) -> None:
    """Every slot busy with a prompt of one chunk and one token (two
    chunk-shaped steps), then two thin decode steps: the engine's two
    token shapes and its postprocess, outside the window."""
    g = traffic.rng(seed, _WARM)
    for _ in range(ecfg.slots):
        engine.submit(g.integers(0, vocab, ecfg.prefill_chunk + 1).tolist(), 3)
    while not engine.idle:
        engine.step()


def closed_loop(engine, mix, seed, vocab, seconds, log: StepLog,
                profile: bool):
    """The window: ``clients`` closed-loop clients for ``seconds``.
    Returns (stamped requests, steps [(t0, t1, first call, end call)],
    t0, t1, the trace's summary or None)."""
    gen = traffic.requests(mix, seed, vocab)
    stamped: list[Stamped] = []

    def submit():
        prompt, n = next(gen)
        s = Stamped(time.perf_counter(), prompt, n, log)
        with torch.profiler.record_function("bench.submit"):
            s.req = engine.submit(prompt, n, on_token=s.on_token)
        stamped.append(s)

    steps = []
    tr_lo = max(0.0, (seconds - TRACE_SECONDS) / 2)
    box, tr_t0 = None, 0.0
    with contextlib.ExitStack() as stack:
        log.on = True
        t0 = time.perf_counter()
        for _ in range(mix["clients"]):
            submit()
        while True:
            now = time.perf_counter()
            if now - t0 >= seconds:
                break
            if profile and box is None and now - t0 >= tr_lo:
                box = stack.enter_context(trace.traced())
                log.in_trace, tr_t0 = True, time.perf_counter()
            elif log.in_trace and now - tr_t0 >= TRACE_SECONDS:
                stack.close()
                log.in_trace = False
            c0, ts = len(log.calls), time.perf_counter()
            with torch.profiler.record_function("bench.engine_step"):
                done = engine.step()
            steps.append((ts, time.perf_counter(), c0, len(log.calls)))
            for r in done:
                submit()
        t1 = time.perf_counter()
        log.on = False
    summary = trace.summarise(box["prof"]) if box is not None else None
    return stamped, steps, t0, t1, summary


def sample(items: list, size, n: int, seed: int, stream: int) -> list:
    """The item of largest ``size`` and ``n - 1`` others drawn from the
    seed, in their order."""
    if not items:
        return []
    longest = max(range(len(items)), key=lambda i: size(items[i]))
    rest = [i for i in range(len(items)) if i != longest]
    g = traffic.rng(seed, stream)
    pick = (g.choice(rest, size=min(n - 1, len(rest)), replace=False).tolist()
            if rest else [])
    return [items[i] for i in sorted([longest] + pick)]


def in_slots(engine, n: int, seed: int) -> list[tuple[int, list[int]]]:
    """(slot, tokens held in its cache) of the requests in the slots at the
    window's close: the longest and others drawn from the seed."""
    lengths = engine.pool.lengths()
    held = sorted((slot, (list(r.prompt) + list(r.generated))[
        :int(lengths[slot])]) for slot, r in engine.active.items()
        if lengths[slot] > 0)
    return sample(held, lambda h: len(h[1]), n, seed, _SAMPLE)


def finished(stamped: list, n: int, seed: int) -> list:
    """The requests finished in the window that the served-logit check
    reads: the longest and others drawn from the seed."""
    done = [s for s in stamped
            if s.req.state.value == "finished" and s.served]
    return sample(done, lambda s: len(s.prompt) + len(s.served), n, seed,
                  _SAMPLE_DONE)


def served_rows(log: StepLog, requests: list) -> torch.Tensor:
    """The logits rows the model step returned for the requests' served
    tokens, in order, float32 (tokens, vocab)."""
    return torch.stack([log.rows[call][slot] for s in requests
                        for _, call, slot in s.served]).to(torch.float32)


def teacher_seqs(requests: list) -> tuple[list, list]:
    """(prompt and served tokens but the last, the positions whose logits
    chose the served tokens) of each request."""
    seqs = [list(s.prompt) + [t for t, _, _ in s.served[:-1]]
            for s in requests]
    at = [list(range(len(s.prompt) - 1, len(s.prompt) - 1 + len(s.served)))
          for s in requests]
    return seqs, at


def decorrelation(got: torch.Tensor, want: torch.Tensor) -> list[float]:
    """Per row, one minus the correlation of two (rows, vocab) logits."""
    a = got - got.mean(-1, keepdim=True)
    b = want.to(got.device) - want.to(got.device).mean(-1, keepdim=True)
    corr = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))
    return (1.0 - corr).tolist()


def cache_kv(cache: dict, slot: int, n: int, layers: int) -> list:
    """The first ``layers`` layers' (k, v) of a slot's first ``n``
    positions, float32 (positions, kv_heads, head_dim), read through the
    program's cache format."""
    from repro_torch.nn.attention import _from_cache

    return [tuple(_from_cache(cache[key][layer, slot, :, :n],
                              torch.float32).transpose(0, 1).clone()
                  for key in ("k", "v")) for layer in range(layers)]


def teacher_forced_kv(api, packed, ecfg, seqs, layers, cache_dtype) -> list:
    """The program's own cache of each sequence, fed through its
    ``decode_slots`` in chunks (slot 0, the other slots idle) with a cache
    of ``cache_dtype``: the control's path."""
    out = []
    cache = api.init_slot_cache(ecfg.slots, ecfg.max_len, cache_dtype)
    ch = ecfg.prefill_chunk
    for seq in seqs:
        cache["lengths"].zero_()
        for lo in range(0, len(seq), ch):
            piece = seq[lo:lo + ch]
            toks = torch.zeros(ecfg.slots, ch, dtype=torch.long,
                               device=api.device)
            toks[0, :len(piece)] = torch.as_tensor(piece)
            nv = np.zeros(ecfg.slots, dtype=np.int64)
            nv[0] = len(piece)
            api.decode_slots(packed, toks, cache, nv)
        out.append(cache_kv(cache, 0, len(seq), layers))
    return out


def kv_errors(got: list, want: list) -> list[float]:
    """Per layer, the RMS of the difference of k and v over the RMS of the
    reference's, over every compared sequence."""
    errs = []
    for layer in range(len(want[0])):
        num = den = 0.0
        for g, w in zip(got, want):
            for a, b in zip(g[layer], w[layer]):
                num += float(((a - b.to(a.device)) ** 2).sum())
                den += float((b ** 2).sum())
        errs.append((num / den) ** 0.5)
    return errs


def run(cell):
    from repro_torch.configs.base import EngineConfig
    from repro_torch.serving.engine import ServingEngine
    from port_bench.harness import Outcome

    dev = torch.device(cell.device)
    cuda = dev.type == "cuda"
    cfg, spec, packed, api = build(cell, dev)
    ecfg = EngineConfig(**cell.traffic["engine"])
    fn = api.decode_slots
    if "decode_slots" in cell.hooks:
        fn = cell.hooks["decode_slots"](fn)
    log = StepLog(fn, timed=cell.trace, cuda=cuda,
                  keep=getattr(torch, cfg.compute_dtype))
    engine = ServingEngine(cfg, packed, ecfg,
                           api=dataclasses.replace(api, decode_slots=log),
                           numerics=spec.name, device=dev)
    if "emit_row" in cell.hooks:
        engine._emit_row = cell.hooks["emit_row"](engine._emit_row)
    vocab = cell.config["arch"]["vocab"]
    stamp(cell, "engine")
    warm_up(engine, ecfg, vocab, cell.seed)
    stamp(cell, "warm-up")
    if cell.trace:
        trace.warm()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - cell.t_start
    cpu0 = time.process_time()
    stamped, steps, t0, t1, summary = closed_loop(
        engine, cell.traffic, cell.seed, vocab, cell.seconds, log,
        profile=cell.trace)
    # the share of the window this process held a CPU: the engine's host
    # work is one thread, so a slower or shared host shows here
    host = {"process_cpu_share": (time.process_time() - cpu0) / (t1 - t0)}
    print("host: " + json.dumps(host), file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    rec = {"kind": "lm_engine", "setup_s": setup_s, "t0": t0, "t1": t1,
           "window_s": t1 - t0, "arch": cell.config["arch"],
           "requests": [{"t_submit": s.t_submit, "times": s.times,
                         "prompt_len": len(s.prompt),
                         "prefilled": s.req.prefilled,
                         "rejected": s.req.state.value == "rejected"}
                        for s in stamped],
           "calls": log.calls, "steps": steps, "timed": cell.trace,
           "host": host,
           "trace": summary, "x_bytes": 2 if cfg.compute_dtype == "bfloat16"
           else 4}
    failed = sum(r["rejected"] for r in rec["requests"])
    checks_cfg = cell.config["checks"]
    checks = {"token_not_greedy": (not_greedy(stamped, log),
                                   checks_cfg["token_not_greedy"])}
    groups = checks_cfg["kv"]
    layers = min(1 + max(max(g["layers"]) for g in groups), cfg.n_layers)
    held = in_slots(engine, cell.traffic["check"]["requests"], cell.seed)
    seqs = [toks for _, toks in held]
    got = [cache_kv(engine.pool.cache, slot, len(toks), layers)
           for slot, toks in held]
    done = finished(stamped, cell.traffic["check"]["finished"], cell.seed)
    rows = served_rows(log, done) if done else None
    control = None
    if "control_cache" in cell.hooks:
        # the program's lower-precision cache path, fed the same tokens
        control = teacher_forced_kv(api, packed, ecfg, seqs, layers, getattr(
            torch, cell.hooks["control_cache"]))
    del engine, packed, log
    if cuda:
        torch.cuda.empty_cache()
    hold = getattr(torch, cfg.compute_dtype)
    lseqs, at = teacher_seqs(done)

    def reference(hold):
        kv = (ref_lm.forward(cell.config, cell.seed, seqs, dev, hold=hold,
                             kv_layers=layers)["kv"] if held else None)
        logits = (torch.cat(ref_lm.forward(
            cell.config, cell.seed, lseqs, dev, hold=hold,
            logits_at=at)["logits"]) if done else None)
        return kv, logits

    def compare(prefix, kv, logits, want_kv, want_logits):
        if kv is not None:
            by_layer = kv_errors(kv, want_kv)
            rec[prefix + "kv_rel_err_by_layer"] = by_layer
            for g in groups:
                checks[prefix + g["name"]] = (
                    max(by_layer[i] for i in g["layers"]), g["limit"])
        if logits is not None:
            per_row = decorrelation(logits, want_logits)
            rec[prefix + "logit_decorr_rows"] = per_row
            checks[prefix + "logit_decorr"] = (
                sum(per_row) / len(per_row), checks_cfg["logit_decorr"])

    for g in groups:
        checks[g["name"]] = (float("inf"), g["limit"])
    checks["logit_decorr"] = (float("inf"), checks_cfg["logit_decorr"])
    want_kv, want_logits = reference(hold)
    compare("", got if held else None, rows, want_kv, want_logits)
    if control is not None and held:
        compare("control_cache_", control, None, want_kv, None)
    if "control_ref" in cell.hooks:
        # the reference in the program's place, its activations held in
        # the precision below the stated one
        compare("control_ref_", *reference(getattr(
            torch, cell.hooks["control_ref"])), want_kv, want_logits)
    rec["checked_positions"] = sum(len(s) for s in seqs)
    rec["checked_tokens"] = sum(len(s.served) for s in done)
    return Outcome(rec=rec, checks=checks, attempted=len(stamped),
                   failed=failed, memory_peak_bytes=peak, trace=summary)
