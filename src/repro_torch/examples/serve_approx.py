"""Serve a mixed-length request trace through the continuous-batching
engine on the approximate + CV array (port of ``examples/serve_approx.py``):
chunked prefill + slot decode with int8 weight codes, CV correction, and an
int8 KV pool.

Short chat turns and long-document prompts share the same fixed-shape
decode batch; tokens stream per request via the ``on_token`` callback.

    PYTHONPATH=src python -m repro_torch.examples.serve_approx --requests 10
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import EngineConfig, get_config
from repro_torch.core.policy import ApproxPolicy
from repro_torch.examples import example_device
from repro_torch.launch.serve import (ServeConfig, build_serving_params,
                                      mixed_trace)
from repro_torch.models import build_model
from repro_torch.numerics import get_preset
from repro_torch.serving import ServingEngine


def device_name(dev: torch.device) -> str:
    """What the throughput line says it ran on."""
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return f"{dev.type} plain path"


def serve_approx(cfg, params, device, mode: str = "perforated", m: int = 2,
                 requests: int = 10, slots: int = 4, max_len: int = 128,
                 chunk: int = 32, out=print) -> dict:
    """Packs the float ``params`` under ``serve-default`` with
    ``ApproxPolicy(mode, m, use_cv=True)`` and an int8 KV cache, serves
    ``mixed_trace(cfg, requests, max_len, chunk)`` through the engine on
    ``device`` and prints the example's lines through ``out``.  Returns
    the engine, the submitted requests, the finished ones, the rejected
    ones' (index, reason), the metrics snapshot and request 0's streamed
    tokens."""
    api = build_model(cfg, device)
    spec = get_preset("serve-default",
                      policy=ApproxPolicy(mode, m, use_cv=True))
    scfg = ServeConfig(spec=spec, cache_dtype="int8")
    packed = build_serving_params(params, cfg, scfg, device=api.device)
    out(f"arch={cfg.name}  numerics={spec.name}  kv=int8")

    ecfg = EngineConfig(slots=slots, max_len=max_len, prefill_chunk=chunk,
                        cache_dtype="int8")
    eng = ServingEngine(cfg, packed, ecfg, api=api, numerics=spec.name)

    # mixed trace: 2/3 short chat turns, 1/3 long documents, varied budgets
    stream_of: dict[int, list[int]] = {}

    def on_token(req, tok):  # streaming consumer (first request only, demo)
        if req.rid == 0:
            stream_of.setdefault(req.rid, []).append(tok)

    reqs, rejected = [], []
    for i, (prompt, gen) in enumerate(mixed_trace(cfg, requests, max_len,
                                                  chunk)):
        r = eng.submit(prompt, gen, on_token=on_token)
        reqs.append(r)
        if r.state.value == "rejected":
            rejected.append((i, r.reject_reason))
            out(f"request {i} rejected: {r.reject_reason}")

    finished = eng.run()
    snap = eng.snapshot()
    out(f"finished {len(finished)} requests "
        f"({eng.compile_count()} compiled shapes)")
    out(f"throughput: {snap['gen_tok_per_s']} gen tok/s "
        f"({snap['total_tok_per_s']} incl. prefill, "
        f"{device_name(api.device)})")
    out(f"TTFT mean/p50/max: {snap['ttft_mean_s']}/{snap['ttft_p50_s']}/"
        f"{snap['ttft_max_s']}s  occupancy={snap['mean_slot_occupancy']}")
    for r in sorted(finished, key=lambda r: r.rid)[:5]:
        out(f"  req {r.rid}: prompt {r.prompt_len:3d} -> "
            f"gen {len(r.generated):2d} [{r.finish_reason}] "
            f"{r.generated[:10]}")
    if 0 in stream_of:
        out(f"streamed req 0: {stream_of[0]}")
    return {"engine": eng, "requests": reqs, "finished": finished,
            "rejected": rejected, "snapshot": snap,
            "streamed": stream_of.get(0, [])}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-4b-reduced")
    ap.add_argument("--mode", default="perforated")
    ap.add_argument("--m", type=int, default=2)
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = example_device(args.device)

    cfg = get_config(args.arch)
    params = build_model(cfg, dev).init(0)
    serve_approx(cfg, params, dev, mode=args.mode, m=args.m,
                 requests=args.requests, slots=args.slots,
                 max_len=args.max_len, chunk=args.chunk)


if __name__ == "__main__":
    main()
