"""Dry run: the per-device profile of every (architecture x input shape x
mesh) cell at H100 constants (port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell for 512 placeholder devices
and reads memory, cost and collectives from XLA.  torch has no placeholder
devices, so the port runs rank 0's step of each cell on the ``meta``
device under a ``launch.mesh.TracingMesh`` of the production shape and
counts it (``launch/op_count.py``): the same step the card runs, with its
collectives reckoned from the placements that step uses.  It needs no
device and no process group.

Per cell:
    train    ``make_train_step(..., mesh=)`` on this rank's pieces of the
             train state (``train_state_shardings``; FSDP for granite-8b
             and deepseek-67b), the global batch split by
             ``batch_shardings``.
    prefill  ``make_prefill_step(..., mesh=)`` on the ``serve-default``
             packs (``approx_mode``/``approx_m`` with the CV, ``backend``
             "pallas" by default: the card's route through the
             hand-written approx kernel; the reference's cells use its jnp
             backend) on this rank's rows.
    decode   ``make_decode_step(..., mesh=)``, one token against a
             ``seq_len`` cache of this rank's rows.
The port's serving path shards no weight (each rank holds the whole
packs; an MoE arch's experts run expert-parallel over "model",
``moe_impl="ep_psum"``), so a serving cell's "model" ranks repeat their
data group's dense work.

Cells: the reference's, 10 archs x 4 shapes minus the assigned skips
(encoder-only decode, full-attention long_500k) = 31 runnable cells, each
on the single-pod (16, 16) mesh AND the multi-pod (2, 16, 16) mesh.  A
record has the reference's keys: memory per device split as arguments /
outputs / temporaries (``temp_size_in_bytes`` is the peak of the tensors
made inside the step), ``roofline`` (``launch/roofline.py``),
``model_flops_*`` and ``useful_flops_ratio``.  These are a model at H100
constants, not a measurement.

    python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k \\
        --multi-pod both
    python -m repro_torch.launch.dryrun --all [--workers 4]

Records go to ``artifacts/dryrun_torch/`` (gitignored) unless ``--out``
names another directory.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import get_config
from repro_torch.configs.registry import list_archs
from repro_torch.configs.base import ArchConfig
from repro_torch.launch import op_count
from repro_torch.launch.mesh import PRODUCTION, TracingMesh
from repro_torch.launch.roofline import model_flops_estimate
from repro_torch.models.registry import SHAPES, input_specs, shape_applicable
from repro_torch.parallel.sharding import batch_rows

ARTIFACT_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "..",
    "artifacts", "dryrun_torch"))


def _arch_for_run(cfg: ArchConfig) -> ArchConfig:
    """Launch-time overrides: EP MoE on the mesh."""
    if cfg.mlp == "moe":
        return dataclasses.replace(cfg, moe_impl="ep_psum")
    return cfg


def _depth(cfg: ArchConfig, d: int) -> ArchConfig:
    """``cfg`` with ``d`` stacked layers (its leading dense ones kept)."""
    return dataclasses.replace(cfg, n_layers=cfg.first_dense_layers + d)


def _train_cell(cfg, spec, mesh, microbatches, moments_bf16, dp_only):
    from repro_torch.launch.train import (TrainConfig, init_train_state,
                                          make_train_step,
                                          train_state_shardings)
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel.sharding import tree_shard

    fsdp = cfg.name in ("deepseek-67b", "granite-8b")
    tcfg = TrainConfig(fsdp=fsdp, microbatches=microbatches,
                       optimizer=AdamWConfig(moment_dtype="bfloat16"
                                             if moments_bf16 else "float32"))
    batch = input_specs(cfg, spec.name)["batch"]

    def make(d):
        c = _depth(cfg, d)
        sh = train_state_shardings(c, tcfg, mesh, dp_only=dp_only)
        local = tree_shard(init_train_state(c, tcfg, seed=0, device="meta"),
                           sh, mesh)
        step = make_train_step(c, tcfg, device="meta", mesh=mesh,
                               param_sh=sh["params"], dp_only=dp_only)
        return (lambda s: step(s, batch)), (local,)

    count = op_count.count_stack(make, cfg.n_scan_layers)
    # the step keeps this rank's rows of the global batch: count the rows'
    # bytes as its argument, as a sharded argument is on one device
    rows, _ = batch_rows(batch, mesh, dp_only)
    count.argument_bytes += sum(v.numel() * v.element_size()
                                for v in rows.values())
    return count


def _serving_params(cfg: ArchConfig, approx_mode: str, approx_m: int,
                    backend: str, cache_dtype: str):
    from repro_torch.core.policy import ApproxPolicy
    from repro_torch.launch.serve import ServeConfig, build_serving_params
    from repro_torch.models import build_model
    from repro_torch.numerics import get_preset

    spec = get_preset("serve-default", policy=ApproxPolicy(
        approx_mode, approx_m, use_cv=True, backend=backend))
    scfg = ServeConfig(spec=spec, cache_dtype=cache_dtype)
    params = build_serving_params(build_model(cfg, "meta").init(0), cfg,
                                  scfg, device="meta")
    return params, scfg


def _serve_cell(cfg, spec, mesh, approx_mode, approx_m, backend,
                cache_dtype):
    from repro_torch.launch.serve import make_decode_step, make_prefill_step
    from repro_torch.models import build_model

    inputs = input_specs(cfg, spec.name)

    def make(d):
        c = _depth(cfg, d)
        params, scfg = _serving_params(c, approx_mode, approx_m, backend,
                                       cache_dtype)
        if spec.kind == "prefill":
            batch, axes = batch_rows(inputs["batch"], mesh)
            step = make_prefill_step(c, max_len=spec.seq_len,
                                     mesh=mesh.with_batch_axes(axes),
                                     scfg=scfg, device="meta")
            return step, (params, batch)
        toks, axes = batch_rows({"tokens": inputs["tokens"]}, mesh)
        rows = toks["tokens"].shape[0]
        dt = {"bfloat16": torch.bfloat16, "int8": torch.int8}[cache_dtype]
        cache = build_model(c, "meta").init_cache(rows, spec.seq_len, dt)
        cache["pos"] = spec.seq_len - 1  # the last position of the context
        step = make_decode_step(c, mesh=mesh.with_batch_axes(axes),
                                scfg=scfg, device="meta")
        return step, (params, toks["tokens"], cache)

    return op_count.count_stack(make, cfg.n_scan_layers)


def run_cell(arch: str, shape: str, multi_pod: bool,
             approx_mode: str = "perforated", approx_m: int = 2,
             overrides: dict | None = None, backend: str = "pallas") -> dict:
    """Count one cell; returns its record.

    ``overrides`` replaces ArchConfig fields (e.g. sequence_parallel=True),
    and takes the reference's step options: microbatches, moments_bf16,
    dp_only, cache_dtype."""
    t_start = time.time()
    spec = SHAPES[shape]
    dims, axes = PRODUCTION[multi_pod]
    mesh = TracingMesh(dims, axes)
    base_cfg = get_config(arch)
    cfg = _arch_for_run(base_cfg)
    overrides = dict(overrides or {})
    microbatches = int(overrides.pop("microbatches", 1))
    moments_bf16 = bool(overrides.pop("moments_bf16", False))
    dp_only = bool(overrides.pop("dp_only", False))
    cache_dtype = overrides.pop("cache_dtype", "bfloat16")
    arch_overrides = overrides
    if arch_overrides:
        cfg = dataclasses.replace(cfg, **arch_overrides)

    record: dict = {
        "arch": arch, "shape": shape, "mesh": "x".join(map(str, dims)),
        "multi_pod": multi_pod, "chips": mesh.size, "kind": spec.kind,
        "backend": backend if spec.kind != "train" else None,
        "overrides": {**arch_overrides,
                      **({"microbatches": microbatches}
                         if microbatches > 1 else {}),
                      **({"moments_bf16": True} if moments_bf16 else {}),
                      **({"dp_only": True} if dp_only else {}),
                      **({"cache_dtype": cache_dtype}
                         if cache_dtype != "bfloat16" else {})},
    }
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        record.update(status="skip", reason=reason)
        return record

    if spec.kind == "train":
        count = _train_cell(cfg, spec, mesh, microbatches, moments_bf16,
                            dp_only)
    else:
        count = _serve_cell(cfg, spec, mesh, approx_mode, approx_m, backend,
                            cache_dtype)
    terms = count.terms()
    mf = model_flops_estimate(base_cfg, spec.kind, spec.seq_len,
                              spec.global_batch)
    mf_per_chip = mf / mesh.size
    record.update(
        status="ok",
        count_s=round(time.time() - t_start, 1),
        memory={"argument_size_in_bytes": count.argument_bytes,
                "output_size_in_bytes": count.output_bytes,
                "temp_size_in_bytes": count.peak_live_bytes,
                "generated_code_size_in_bytes": 0},
        roofline=terms.as_dict(),
        model_flops_global=mf,
        model_flops_per_chip=mf_per_chip,
        useful_flops_ratio=(mf_per_chip / terms.flops) if terms.flops
        else None,
    )
    return record


def device_gib(record: dict) -> float:
    """A record's per-device GiB: arguments + temporaries (the outputs of
    a step replace its arguments)."""
    mem = record["memory"]
    return (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]) \
        / 2**30


def cell_line(rec: dict, variant: str = "") -> str:
    label = f"{rec['arch']} {rec['shape']} multi_pod={rec['multi_pod']}"
    if variant:
        label += f" variant={variant}"
    if rec["status"] == "skip":
        return f"[skip] {label} ({rec['reason']})"
    if rec["status"] != "ok":
        return f"[{rec['status']}] {label}: {rec.get('error')}"
    r = rec["roofline"]
    return (f"[ok] {label} dominant={r['dominant']} "
            f"compute={r['compute_s']:.3e}s memory={r['memory_s']:.3e}s "
            f"collective={r['collective_s']:.3e}s "
            f"per-device={device_gib(rec):.2f}GiB "
            f"useful_flops_ratio={rec['useful_flops_ratio']:.3f} "
            f"count={rec['count_s']}s")


def _cell(args) -> dict:
    arch, shape, mp, kw = args
    torch.set_num_threads(1)
    try:
        return run_cell(arch, shape, mp, **kw)
    except Exception as e:  # a failure here is a bug in the system
        return {"arch": arch, "shape": shape, "multi_pod": mp,
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:]}


def _out_path(out_dir: str, arch: str, shape: str, multi_pod: bool,
              variant: str = "") -> str:
    """A cell's record; a ``variant``'s goes to the sibling ``perf``
    directory with ``__<variant>`` in its name, as the reference's."""
    if variant:
        out_dir = os.path.join(os.path.dirname(os.path.abspath(out_dir)),
                               "perf")
    os.makedirs(out_dir, exist_ok=True)
    pod = "multipod" if multi_pod else "singlepod"
    suffix = f"__{variant}" if variant else ""
    return os.path.join(out_dir, f"{arch}__{shape}__{pod}{suffix}.json")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=[None, *SHAPES])
    ap.add_argument("--multi-pod", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true",
                    help="recompute cached cells")
    ap.add_argument("--approx-mode", default="perforated")
    ap.add_argument("--approx-m", type=int, default=2)
    ap.add_argument("--variant", default="",
                    help="perf-variant artifact label")
    ap.add_argument("--backend", default="pallas", choices=["pallas", "jnp"])
    ap.add_argument("--set", action="append", default=[],
                    help="ArchConfig override, e.g. --set "
                    "sequence_parallel=true")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--workers", type=int, default=1,
                    help="cells counted in parallel processes")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = {"true": True, "false": False}.get(
            v.lower(), int(v) if v.lstrip("-").isdigit() else v)

    archs = (list_archs() if (args.all or args.arch is None)
             else [args.arch])
    shapes = list(SHAPES) if args.shape is None else [args.shape]
    pods = {"single": [False], "multi": [True],
            "both": [False, True]}[args.multi_pod]
    kw = dict(approx_mode=args.approx_mode, approx_m=args.approx_m,
              overrides=overrides or None, backend=args.backend)
    jobs = []
    for a in archs:
        for s in shapes:
            for mp in pods:
                if os.path.exists(_out_path(args.out, a, s, mp,
                                            args.variant)) \
                        and not args.force:
                    print(f"[cached] {a} {s} multi_pod={mp}")
                    continue
                jobs.append((a, s, mp, kw))
    t0 = time.time()
    failures, records = [], []

    def done(rec: dict) -> None:
        records.append(rec)
        with open(_out_path(args.out, rec["arch"], rec["shape"],
                            rec["multi_pod"], args.variant), "w") as f:
            json.dump(rec, f, indent=2)
        print(cell_line(rec, args.variant), flush=True)
        if rec["status"] == "error":
            failures.append(rec)

    if args.workers > 1:
        import multiprocessing as mp_

        with mp_.get_context("spawn").Pool(args.workers) as pool:
            for rec in pool.imap_unordered(_cell, jobs):
                done(rec)
    else:
        for job in jobs:
            done(_cell(job))
    print(f"dry run: {len(records)} cells in {time.time() - t0:.1f} s",
          flush=True)
    if failures:
        print(f"\nFAILED cells ({len(failures)}):")
        for rec in failures:
            print("  ", rec["arch"], rec["shape"], rec["multi_pod"])
            print(rec["traceback"])
        raise SystemExit(1)
    print("\nall requested cells complete")


if __name__ == "__main__":
    main()
