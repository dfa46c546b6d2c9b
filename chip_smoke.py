"""Card check for the PyTorch/CUDA port: `python3 chip_smoke.py`.

Drives the port (`src/repro_torch`, no JAX) on one CUDA card:

1. device: name and power limit; TF32 off;
2. build: compiles the three CUDA sources from the checkout, one `nvcc`
   each, all at once;
3. kernels: every kernel against its plain PyTorch version on the card:
   approx-matmul for every multiplier mode at the serving shapes (decode
   M=4, engine chunk M=128, olmo-1b prefill M=4096 at K=2048 and 8192,
   rwkv6-1.6b prefill M=2048 at K=7168, a ragged M=1000 with a K off the
   tile), decode rows at M=1 and 8, rwkv6-1.6b's decode shapes and head, a
   fused-group member reading a row slice of its group's codes, ragged
   decode calls, inputs on quantization ties, plus exact-integer
   accumulator checks (M=4, 128, 300), equal to the plain version on every
   matmul tile of the source, and every decode call twice bit-equal; flash
   attention
   at the olmo-1b prefill shape, the JAX kernel tests' shapes in float32
   and bfloat16 (GQA, window, non-causal, Tq < Tk at D=64 and 128) and a
   ragged length, each row held to its own scale; the RWKV6 scan (out and
   final state, and two calls bit-equal) at the rwkv6-1.6b prefill shape,
   the JAX tests' shapes, ragged and partial chunks, one head, Dk != Dv and
   the extreme decays;
4. engine path: full-width olmo-1b served by the port's continuous-batching
   engine with `backend: "pallas"` packs; checks completion, the kernel
   launch count the schedule implies, that the packs hold their codes only
   K-major (fused-group members as row slices of the group's), that a
   decode step's fused calls are one CUDA launch each, device placement,
   determinism and that the control variate reaches the logits;
5. lock-step paths (`launch.serve.run_legacy`): full-width olmo-1b (B=4,
   T=1024) and rwkv6-1.6b (B=4, T=512), 32 tokens each, `serve-default`
   with `backend: "pallas"`; checks finite logits, determinism, the launch
   counts the schedule implies, the packs and one launch a decode call as
   above, and the logit gap to the same prefill with the flash and scan
   kernels swapped for their plain versions;
6. kernel times at the paths' shapes (kernel, plain, library, bound),
   the approx-matmul also at both lock-step prefills' shapes and at
   rwkv6-1.6b's decode shapes and head.

Prints the card line and one `kernels` JSON line before the last line, and
ends with `{"ok": true, "device": {...}}`.  Any failure exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: data-sheet peaks by card name: (memory bytes/s, dense int8 ops/s, dense
#: bf16 tensor-core FLOP/s, float32 FLOP/s outside the tensor cores)
CARD_PEAKS = {
    "H100 80GB HBM3": (3.35e12, 1979e12, 989e12, 67e12),  # SXM5
    "H100 PCIe": (2.0e12, 1513e12, 756e12, 51e12),
    "H100 NVL": (3.9e12, 1671e12, 835e12, 60e12),
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
#: rwkv6-1.6b's packed layers of one layer's prefill: r, k, v, g, out,
#: receptance; key; value
RWKV_KN = [(2048, 2048)] * 6 + [(2048, 7168), (7168, 2048)]
#: rwkv6-1.6b's packed head (one call a step)
RWKV_HEAD_KN = (2048, 65536)
#: rows of one lock-step prefill call: B=4 x T
OLMO_PREFILL_M, RWKV_PREFILL_M = 4096, 2048
#: decode-row cases (M, K, N) beyond the path shapes: one and DECODE_M_MAX
#: rows at olmo-1b's shapes, rwkv6-1.6b's key and value projections and head,
#: a ragged call (K off 16 bytes, N off the 32-column tile)
DECODE_CASES = [(1, 2048, 2048), (8, 2048, 2048), (1, 8192, 2048),
                (8, 8192, 2048), (8, 2048, 8192), (4, 2048, 7168),
                (4, 7168, 2048), (4,) + RWKV_HEAD_KN, (3, 1000, 1000)]


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


@contextlib.contextmanager
def plain_swapped(what: str, swaps):
    """Swaps each ``(module, wrapper name, plain version)`` for the plain
    version inside the block; fails unless every plain version ran and no
    swapped kernel launched."""
    saved, calls = [], {}
    for mod, name, plain in swaps:
        kern = getattr(mod, name)
        saved.append((mod, name, kern, kern.launches))
        calls[name] = 0

        def counted(*a, _plain=plain, _name=name, **kw):
            calls[_name] += 1
            return _plain(*a, **kw)

        setattr(mod, name, counted)
    try:
        yield
    finally:
        for mod, name, kern, _ in saved:
            setattr(mod, name, kern)
    for mod, name, kern, before in saved:
        if calls[name] == 0 or kern.launches != before:
            fail(f"{what}: plain run made {calls[name]} calls of {name}'s "
                 f"plain version and {kern.launches - before} kernel launches")


def storage_gib(tensors) -> float:
    """GiB of the storages under ``tensors``, each storage counted once (a
    fused-group member's codes are a view of its group's)."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values()) / 2**30


def modules(tree):
    """Every module of a parameter tree (dicts of modules and tensors)."""
    import torch.nn as nn

    if isinstance(tree, nn.Module):
        yield from tree.modules()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from modules(v)


def k_major_gib(tree) -> float:
    """GiB of the packs' weight codes (``w_qbt``, K-major) in a parameter
    tree."""
    return storage_gib([b for m in modules(tree)
                        for name, b in m.named_buffers(recurse=False)
                        if name == "w_qbt" and b is not None])


def check_packs(label: str, tree) -> int:
    """Fails unless every pack holds its weight codes once, K-major: no
    module keeps a row-major ``w_qb`` buffer, and each fused-group member's
    ``w_qbt`` is a row slice of its group's (the same storage).  Returns
    the number of members checked."""
    from repro_torch.core.approx_linear import QuantizedDenseGroup

    members = 0
    for m in modules(tree):
        if "w_qb" in dict(m.named_buffers(recurse=False)):
            fail(f"{label}: a pack still holds row-major w_qb codes")
        if isinstance(m, QuantizedDenseGroup) and m.w_qbt is not None:
            for member in m.members:
                if member.w_qbt is None or member.w_qbt.untyped_storage(
                        ).data_ptr() != m.w_qbt.untyped_storage().data_ptr():
                    fail(f"{label}: a fused-group member holds its own copy "
                         "of the group's K-major codes")
                members += 1
    return members


def peaks(name: str) -> tuple[float, float, float, float]:
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


def close(torch, got, want, rtol: float = RTOL, per_row: bool = False
          ) -> float:
    """Max abs error; fails unless |got - want| <= rtol*(|want| + scale)
    everywhere (a NaN on either side fails).  ``scale`` is max |want| over
    the whole output, or with ``per_row`` over each row of its last axis,
    so that rows of small values are held to their own size."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if not want.numel():
        return 0.0
    scale = (want.abs().amax(dim=-1, keepdim=True) if per_row
             else want.abs().max())
    bad = ~(err <= rtol * (want.abs() + scale))
    if bool(bad.any()):
        fail(f"kernel disagrees with its plain version: max abs err "
             f"{float(err.max())} at scale {float(scale.max())} (rtol "
             f"{rtol}{', scale per row' if per_row else ''})")
    return float(err.max())


def check_kernels(torch, dev) -> dict:
    """Phase 3: both approx-matmul entries against their plain versions on
    the card, equal (max abs err 0) in every case, and every decode-row
    call of the fused entry made twice with bit-equal outputs; fails unless
    each entry was compared on every matmul tile the source instantiates
    (``approx_matmul.TILES``)."""
    import dataclasses

    from repro_torch.kernels import approx_matmul as amk
    from repro_torch.core import multipliers as am

    from repro_torch.quant.quantize import k_major

    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"approx_matmul_cv_fused": 0.0, "approx_matmul_cv": 0.0}
    tiles = {name: set() for name in errs}

    def equal(name, got, want, mm, k, n, mode, m):
        err = close(torch, got, want)
        if err != 0.0:
            fail(f"{name} {mode} m={m} ({mm}, {k}, {n}): max abs err {err} "
                 "against its plain version, not 0")
        errs[name] = max(errs[name], err)
        tiles[name].add(amk.tile(mm, k, n, mode, m))

    def fused(x, blocked, mode, m, label):
        """The fused kernel against its plain version; decode rows twice."""
        k, n = blocked.k, blocked.n
        args = (x, blocked.w_qbt, blocked.epilogue, blocked.meta)
        got = amk.approx_matmul_cv_fused(*args, k=k, n=n, mode=mode, m=m)
        again = (amk.approx_matmul_cv_fused(*args, k=k, n=n, mode=mode, m=m)
                 if x.shape[0] <= amk.DECODE_M_MAX else got)
        want = amk.approx_matmul_cv_fused_plain(*args, k=k, n=n, mode=mode,
                                                m=m)
        torch.cuda.synchronize()
        if got.dtype != x.dtype or got.shape != (x.shape[0], n):
            fail(f"fused kernel output {got.dtype} {tuple(got.shape)}")
        if not torch.equal(got, again):
            fail(f"fused kernel {label} {mode} m={m} ({x.shape[0]}, {k}, "
                 f"{n}): two calls on the same inputs differ")
        equal("approx_matmul_cv_fused", got, want, x.shape[0], k, n, mode, m)
        return got

    # decode and engine-chunk rows at every path shape; lock-step prefill
    # calls: olmo-1b's fused q|k|v and down projection (K=8192: the 128 x
    # 256 tile), rwkv6-1.6b's key projection; a ragged call whose K (2000)
    # is off the 128-byte K tile and whose M and N are off the row and
    # column tiles; the decode cases
    shapes = ([(mm, k, n) for mm in (4, 128) for k, n in PATH_KN]
              + [(5, 200, 48), (OLMO_PREFILL_M, 2048, 6144),
                 (OLMO_PREFILL_M, 8192, 2048), (RWKV_PREFILL_M, 7168, 2048),
                 (1000, 2000, 1000)] + DECODE_CASES)
    n_cases = n_twice = 0
    for mode, m in MODES:
        for mm, k, n in shapes:
            pack, a_qp, blocked = random_pack(torch, k, n, mode, m, gen, dev,
                                              fused_members=3 if n == 6144 else 1)
            for dt in (torch.bfloat16, torch.float32):
                x = (torch.randn(mm, k, generator=gen, device=dev) * 1.5).to(dt)
                got = fused(x, blocked, mode, m, "path")
                n_cases += 1
                n_twice += mm <= amk.DECODE_M_MAX
                if n == 6144 and mm <= amk.DECODE_M_MAX:
                    # a fused group's member (k of q|k|v) over its rows of
                    # the group's K-major codes, as packs serve it: equal to
                    # its plain version and to the group call's columns
                    member = dataclasses.replace(
                        blocked, n=2048, w_qbt=blocked.w_qbt[2048:4096],
                        epilogue=blocked.epilogue[:, 2048:4096].contiguous())
                    got_m = fused(x, member, mode, m, "member")
                    if not torch.equal(got_m, got[:, 2048:4096]):
                        fail(f"member slice {mode} m={m}: differs from the "
                             "group call's columns")
                    n_cases += 1
                    n_twice += 1
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
            equal("approx_matmul_cv", got, want, mm, k, n, mode, m)
            n_cases += 1
            del pack, blocked
        # exact integer accumulators: sa = sw = 1, za = zw = 0, no bias, no
        # CV, integer x in [0, 255] (codes == x); K <= 258 keeps the f32
        # output an exact integer, so it must equal the scalar oracle.  M=4
        # takes the split-K kernel; 128 and 300 the prefill tile (300 rows
        # and columns cross its row and column tiles, K=258 three K tiles)
        for mm, n in ((4, 96), (128, 96), (300, 300)):
            k = 258
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
                a_q.float(), k_major(w_q), epi, meta, k=k, n=n, mode=mode,
                m=m, use_cv=False)
            zeros = torch.zeros(n, device=dev)
            got2 = amk.approx_matmul_cv(
                a_q, w_q, zeros, zeros, torch.zeros(n, dtype=torch.int32,
                                                    device=dev), zeros,
                torch.tensor([1.0, 1.0, 0.0, 0.0, float(k)], device=dev),
                mode=mode, m=m, use_cv=False)
            torch.cuda.synchronize()
            for name, got in (("approx_matmul_cv_fused", got1),
                              ("approx_matmul_cv", got2)):
                if not torch.equal(got, want):
                    fail(f"{name} accumulator not exact for {mode} m={m}"
                         f" M={mm}: max diff {float((got - want).abs().max())}")
                tiles[name].add(amk.tile(mm, k, n, mode, m))
            n_cases += 2
    # quantization on ties: x within a few float32 ulps of (j + 1/2) * sa,
    # where the kernels' fast quotient hands over to the IEEE division; the
    # split-K kernel (M=4) and the prep kernel (M=64)
    for mm in (4, 64):
        _, _, blocked = random_pack(torch, 2048, 256, "perforated", 2, gen,
                                    dev)
        sa = float(blocked.meta[0, 0])
        half = (torch.randint(-300, 300, (mm, 2048), generator=gen,
                              device=dev).float() + 0.5) * sa
        ulps = torch.randint(-3, 4, (mm, 2048), generator=gen, device=dev)
        x = (half.view(torch.int32) + ulps.to(torch.int32)).view(torch.float32)
        for xx in (x, x.to(torch.bfloat16)):
            fused(xx, blocked, "perforated", 2, "ties")
            n_cases += 1
            n_twice += mm <= amk.DECODE_M_MAX
    for name, seen in tiles.items():
        if set(amk.TILES) - seen:
            fail(f"{name}: tiles {sorted(set(amk.TILES) - seen)} were never "
                 "compared with the plain version")
    print(f"kernels: {n_cases} approx-matmul cases equal their plain "
          f"versions (max abs err 0) on every tile {list(amk.TILES)}; "
          f"{n_twice} decode-row cases called twice, bit-equal", flush=True)
    return errs


#: flash attention against its plain version, each output row against its
#: own largest value: float32 inputs differ only in the order of float32
#: sums (2e-5, the JAX kernel tests' tolerance); a bfloat16 output is one
#: bf16 rounding (2^-7 relative) of float32 values that differ by the
#: rounding of P to bf16 (~2^-9 of the row's scale, averaged over the keys)
FLASH_RTOL = {"float32": 2e-5, "bfloat16": 2.0 ** -7}
#: the RWKV6 scan against its plain version: the same chunked float32
#: algebra with its sums in another order; the k / D_s terms reach e^8
#: within a chunk, so ulps of them show
SCAN_RTOL = 1e-4
#: (B, Hq, Hkv, Tq, Tk, D, causal, window, dtype): the olmo-1b prefill
#: shape, the JAX kernel tests' cases (tests/test_kernels.py) in float32
#: (CUDA-core route) and their GQA, window, non-causal and Tq < Tk cases in
#: bfloat16 at D=64 and 128 (tensor-core route), a ragged T
FLASH_CASES = [
    (4, 16, 16, 1024, 1024, 128, True, None, "bfloat16"),
    (2, 4, 4, 128, 128, 32, True, None, "float32"),
    (2, 8, 2, 128, 128, 32, True, None, "float32"),
    (2, 4, 4, 128, 128, 32, False, None, "float32"),
    (2, 4, 2, 128, 128, 32, True, 64, "float32"),
    (1, 4, 2, 64, 256, 64, True, None, "float32"),
    (4, 16, 16, 1000, 1000, 128, True, None, "bfloat16"),
] + [case for d in (64, 128) for case in (
    (2, 8, 2, 128, 128, d, True, None, "bfloat16"),
    (2, 4, 2, 128, 128, d, True, 64, "bfloat16"),
    (2, 4, 4, 128, 128, d, False, None, "bfloat16"),
    (1, 4, 2, 64, 256, d, True, None, "bfloat16"))]
#: (B, T, H, Dk, Dv, dtype of r/k/v, every decay at this value or None for
#: the JAX tests' distribution): the rwkv6-1.6b prefill shape (the timed
#: one), the JAX tests' cases, a ragged T; partial chunks (T = 1, 31, 33);
#: one (batch, head); Dk != Dv; widths that leave a block of the cluster a
#: partial or an empty value slice (40 / 24); the extreme decays.  Every
#: decay at e^-8 runs 10 steps: from the 11th step of a chunk k~ = k e^88
#: overflows float32 for |k| > 2, and the reference's chunked algebra
#: (which both sides follow) gives inf and NaN.
SCAN_CASES = [
    (4, 512, 32, 64, 64, "bfloat16", None),
    (2, 64, 2, 64, 64, "float32", None),
    (2, 96, 2, 32, 32, "float32", None),
    (4, 500, 32, 64, 64, "bfloat16", None),
    (2, 1, 3, 64, 64, "bfloat16", None),
    (2, 31, 3, 64, 64, "float32", None),
    (2, 33, 3, 64, 64, "bfloat16", None),
    (1, 200, 1, 64, 64, "bfloat16", None),
    (2, 96, 4, 64, 32, "float32", None),
    (2, 80, 4, 32, 64, "bfloat16", None),
    (2, 70, 2, 40, 24, "float32", None),
    (2, 10, 4, 64, 64, "bfloat16", math.exp(-8.0)),
    (2, 256, 4, 64, 64, "bfloat16", 0.9999),
]


def scan_inputs(torch, b, t, h, dk, dv, dtype, gen, dev, decay=None):
    """r, k, v in ``dtype``; float32 decays with the JAX tests'
    distribution (exp(-exp(N(-1, 1.5))) clipped to [e^-8, 0.9999]), or all
    equal to ``decay``."""
    r = torch.randn(b, t, h, dk, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, t, h, dk, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, t, h, dv, generator=gen, device=dev).to(dtype)
    w = torch.exp(-torch.exp(torch.randn(b, t, h, dk, generator=gen,
                                         device=dev) * 1.5 - 1.0))
    w = w.clamp(math.exp(-8.0), 0.9999)
    if decay is not None:
        w = torch.full_like(w, decay)
    u = torch.randn(h, dk, generator=gen, device=dev) * 0.5
    return r, k, v, w, u


def check_scan(torch, dev, gen) -> float:
    """The RWKV6 scan against its plain version in every case of
    ``SCAN_CASES`` (out and final state), and two calls on the same inputs
    bit-equal.  Returns the largest absolute error."""
    from repro_torch.kernels import rwkv6_scan as rsk

    worst = 0.0
    for b, t, h, dk, dv, dt, decay in SCAN_CASES:
        args = scan_inputs(torch, b, t, h, dk, dv, getattr(torch, dt), gen,
                           dev, decay)
        out, state = rsk.rwkv6_scan(*args)
        out2, state2 = rsk.rwkv6_scan(*args)
        out_p, state_p = rsk.rwkv6_scan_plain(*args)
        torch.cuda.synchronize()
        if out.shape != (b, t, h, dv) or state.shape != (b, h, dk, dv):
            fail(f"scan output {tuple(out.shape)} state {tuple(state.shape)}")
        if not (torch.equal(out, out2) and torch.equal(state, state2)):
            fail(f"scan B={b} T={t} H={h} Dk={dk} Dv={dv} {dt}: two calls "
                 "on the same inputs differ")
        err = max(close(torch, out, out_p, SCAN_RTOL),
                  close(torch, state, state_p, SCAN_RTOL))
        worst = max(worst, err)
        print(f"kernels: rwkv6_scan B={b} T={t} H={h} Dk={dk} Dv={dv} {dt}"
              f"{'' if decay is None else f' decays {decay:.6g}'}: max abs "
              f"err (out, state) {err:.3g} (rtol {SCAN_RTOL}), two calls "
              "bit-equal", flush=True)
    return worst


def check_attention_and_scan(torch, dev) -> dict:
    """Phase 3, second half: flash attention and the RWKV6 scan against
    their plain versions on the card."""
    from repro_torch.kernels import flash_attention as fak

    gen = torch.Generator(device=dev).manual_seed(2)
    errs = {"flash_attention": 0.0, "rwkv6_scan": 0.0}
    for b, hq, hkv, tq, tk, d, causal, window, dt in FLASH_CASES:
        dtype = getattr(torch, dt)
        q = torch.randn(b, hq, tq, d, generator=gen, device=dev).to(dtype)
        k = torch.randn(b, hkv, tk, d, generator=gen, device=dev).to(dtype)
        v = torch.randn(b, hkv, tk, d, generator=gen, device=dev).to(dtype)
        got = fak.flash_attention(q, k, v, causal=causal, window=window)
        want = fak.flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        if got.dtype != dtype or got.shape != want.shape:
            fail(f"flash output {got.dtype} {tuple(got.shape)}")
        err = close(torch, got, want, FLASH_RTOL[dt], per_row=True)
        errs["flash_attention"] = max(errs["flash_attention"], err)
        print(f"kernels: flash_attention B={b} Hq={hq} Hkv={hkv} Tq={tq} "
              f"Tk={tk} D={d} causal={causal} window={window} {dt}: max abs "
              f"err {err:.3g} (rtol {FLASH_RTOL[dt]:.3g})", flush=True)
    errs["rwkv6_scan"] = check_scan(torch, dev, gen)
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
    """Phase 6: per-shape times of both kernels, their plain versions, the
    library matmuls the approximate layer stands beside, and the bound
    (perforated m=2 + CV, bf16 activations, as served): decode rows (olmo-1b
    and rwkv6-1.6b, head included) and engine chunk rows for both entries,
    both lock-step prefills' rows for the fused entry (its plain version
    timed at one prefill shape only)."""
    from repro_torch.kernels import approx_matmul as amk
    from repro_torch.quant.quantize import BlockedPack

    bw, int8_peak, _, _ = peaks(card)
    mode, m = "perforated", 2
    # least work: one product per plane plus the main one (perforated and
    # exact: one; recursive: two; truncated: m + 1)
    products = 1 + len(amk.decomposition(mode, m)[1])
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    small = sorted({(4, k, n) for k, n in DECODE_KN + PATH_KN + RWKV_KN
                    + [RWKV_HEAD_KN]}
                   | {(128, k, n) for k, n in PATH_KN})
    prefill = sorted({(OLMO_PREFILL_M, k, n) for k, n in PREFILL_KN}
                     | {(RWKV_PREFILL_M, k, n) for k, n in RWKV_KN})
    plain_at = (OLMO_PREFILL_M, 2048, 2048)
    for mm, k, n in small + prefill:
        pack, a_qp, blocked = random_pack(torch, k, n, mode, m, gen, dev)
        # the weight bytes every call reads: the pack's K-major codes
        w_bytes = blocked.w_qbt.numel()
        # enough operand copies that the 50 MB L2 cannot serve one call's
        # weights from the previous call (as in a served step)
        copies = max(2, -(-(128 << 20) // w_bytes))
        blks = [blocked] + [BlockedPack(
            w_qbt=blocked.w_qbt.clone(), epilogue=blocked.epilogue.clone(),
            meta=blocked.meta.clone(), k=k, n=n, bk=blocked.bk, bn=blocked.bn)
            for _ in range(copies - 1)]
        x = torch.randn(mm, k, generator=gen, device=dev).to(torch.bfloat16)
        fused = dict(
            kern=[lambda b=b: amk.approx_matmul_cv_fused(
                x, b.w_qbt, b.epilogue, b.meta, k=k, n=n, mode=mode, m=m)
                for b in blks],
            plain=[lambda b=b: amk.approx_matmul_cv_fused_plain(
                x, b.w_qbt, b.epilogue, b.meta, k=k, n=n, mode=mode, m=m)
                for b in blks[:2]],
            nbytes=(x.numel() * 2 + w_bytes + blocked.epilogue.numel() * 4
                    + blocked.meta.numel() * 4 + mm * n * 2))
        entries = [("approx_matmul_cv_fused", fused)]
        if mm <= 128:
            wqs = [pack.w_q] + [pack.w_q.clone() for _ in range(copies - 1)]
            a_q = torch.randint(0, 256, (mm, k), generator=gen, device=dev,
                                dtype=torch.uint8)
            meta5 = torch.tensor([0.015, 0.02, 7.0, 131.0, float(k)],
                                 device=dev)
            bias = torch.zeros(n, device=dev)
            # as callers call it: the wrapper makes the K-major copy of w_q
            # each call, and that transpose is timed
            entries.append(("approx_matmul_cv", dict(
                kern=[lambda w=w: amk.approx_matmul_cv(
                    a_q, w, pack.c, pack.c0, pack.sum_qw, bias, meta5,
                    mode=mode, m=m) for w in wqs],
                plain=[lambda w=w: amk.approx_matmul_cv_plain(
                    a_q, w, pack.c, pack.c0, pack.sum_qw, bias, meta5,
                    mode=mode, m=m) for w in wqs[:2]],
                nbytes=(mm * k + k * n + 4 * 4 * n + 4 * 5 + mm * n * 4))))
        w_f = [torch.randn(k, n, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(copies)]
        t_lib = time_calls(torch, [lambda w=w: torch.matmul(x, w) for w in w_f])
        del w_f
        t_int8 = None
        if mm >= 32:  # torch._int_mm needs more than 16 rows
            x8 = torch.randint(-128, 128, (mm, k), generator=gen, device=dev,
                               dtype=torch.int8)
            w8 = [torch.randint(-128, 128, (k, n), generator=gen, device=dev,
                                dtype=torch.int8) for _ in range(copies)]
            t_int8 = time_calls(torch, [lambda w=w: torch._int_mm(x8, w)
                                        for w in w8])
            del w8, x8
        t_ops = 2.0 * mm * k * n * products / int8_peak
        for name, d in entries:
            t_bytes = d["nbytes"] / bw
            timed_plain = mm <= 128 or (mm, k, n) == plain_at
            rows.append({
                "kernel": name, "M": mm, "K": k, "N": n,
                "kernel_us": time_calls(torch, d["kern"]) * 1e6,
                "plain_us": (time_calls(torch, d["plain"], reps=3) * 1e6
                             if timed_plain else None),
                "library_us": t_lib * 1e6,
                "int8_library_us": None if t_int8 is None else t_int8 * 1e6,
                "bound_us": max(t_bytes, t_ops) * 1e6,
                "bound_by": ("bytes" if t_bytes >= t_ops else "operations")})
            print("time " + json.dumps(rows[-1]), flush=True)
        del blks, fused, entries
    return rows


def step_entry(rows: list[dict], name: str, kn_list, mm) -> dict:
    """Sums over one layer's launches of one step kind."""
    by = {(r["kernel"], r["M"], r["K"], r["N"]): r for r in rows}
    sel = [by[(name, mm, k, n)] for k, n in kn_list]
    out = {key: (None if any(r[key] is None for r in sel)
                 else sum(r[key] for r in sel))
           for key in ("kernel_us", "plain_us", "library_us",
                       "int8_library_us", "bound_us")}
    out["launches"] = len(sel)
    out["kernel_us_per_call"] = out["kernel_us"] / len(sel)
    out["bound_us_per_call"] = out["bound_us"] / len(sel)
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
    pack_gib = storage_gib(iter_tensors(packed))
    members = check_packs("main", packed)
    print(f"main: init + pack {time.perf_counter() - t0:.1f} s; "
          f"serving params {pack_gib:.3f} GiB, of which K-major weight codes "
          f"{k_major_gib(packed):.3f} GiB (no row-major copy; {members} "
          "fused-group members read row slices of their group's)", flush=True)

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
    wr = wrappers()
    for w in wr.values():
        w.launches = 0
    reqs = [eng.submit(p, g) for p, g in trace]
    finished = eng.run()
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in wr.items()}
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
          f"launches {launches} expected fused {expected} (a fused call is "
          f"one CUDA launch at decode rows, prep and matmul above)", flush=True)
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
    swaps = [(amk, "approx_matmul_cv_fused", amk.approx_matmul_cv_fused_plain)]
    thin = toks[:, :1]
    lk_thin = api.decode_slots(packed, thin, api.init_slot_cache(
        ecfg.slots, ecfg.max_len, torch.bfloat16), [1] * ecfg.slots)[0]
    with plain_swapped("main", swaps):
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
    check_one_launch("main: thin step", breakdown["thin"])

    main_line = json.dumps({
        "requests_finished": snap["requests_finished"],
        "generated_tokens": snap["generated_tokens"],
        "prompt_tokens": snap["prompt_tokens"],
        "elapsed_s": snap["elapsed_s"],
        "gen_tok_per_s": snap["gen_tok_per_s"],
        "total_tok_per_s": snap["total_tok_per_s"],
        "ttft_p50_s": snap["ttft_p50_s"], "ttft_p95_s": snap["ttft_p95_s"],
        "itl_p50_s": snap["itl_p50_s"], "itl_p95_s": snap["itl_p95_s"],
        "peak_mem_gib": peak / 2**30, "pack_gib": pack_gib,
        "k_major_gib": k_major_gib(packed),
        "launches": launches, "step_breakdown": breakdown})
    print("main: " + main_line, flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "main_path.json").write_text(main_line + "\n")
    return launches


def profile_fn(torch, label: str, call, host_profile: str) -> dict:
    """Wall time of ``call`` (host clock around a synchronised call, median
    of 5) against its device time (the sum of the CUDA kernels' times from
    torch.profiler; the CPU ops that launched them are not counted again),
    and the kernels that take the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    (ROOT / "chiprun_out" / host_profile).write_text(buf.getvalue())
    from repro_torch.kernels import approx_matmul as amk

    calls0 = amk.approx_matmul_cv_fused.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            call()
        torch.cuda.synchronize()
    fused_calls = amk.approx_matmul_cv_fused.launches - calls0

    def dev_us(evt):
        return getattr(evt, "self_device_time_total",
                       getattr(evt, "self_cuda_time_total", 0.0))

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    device_s = sum(dev_us(e) for e in kernels) / 3 / 1e6
    wall_s = statistics.median(walls)
    # kernels by name, instantiations of one template summed (their names
    # agree in the first 48 characters)
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.key[:48]] = by_name.get(e.key[:48], 0.0) + dev_us(e) / 3
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:6]
    # the approx-matmul source's CUDA launches in the profiled calls, by
    # kernel, beside the fused wrapper's calls there
    approx = {}
    for e in kernels:
        for kern in ("prep_kernel", "am_splitk_kernel", "am_wgmma_kernel"):
            if kern in e.key:
                approx[kern] = approx.get(kern, 0) + e.count
    out = {"wall_ms": wall_s * 1e3,
           "device_ms": device_s * 1e3 if kernels else None,
           "device_idle_share": 1 - device_s / wall_s if kernels else None,
           "top_device_us": dict(top),
           "fused_calls": fused_calls, "approx_launches": approx}
    print(f"{label}: " + json.dumps(out), flush=True)
    return out


def check_one_launch(label: str, prof: dict) -> None:
    """A decode step's fused calls (M <= DECODE_M_MAX) are one CUDA launch
    each: the step's profile holds no prep kernel and no prefill tile, and
    as many split-K launches as fused wrapper calls."""
    got = prof["approx_launches"]
    if set(got) - {"am_splitk_kernel"} or \
            got.get("am_splitk_kernel", 0) != prof["fused_calls"]:
        fail(f"{label}: {prof['fused_calls']} fused calls launched {got}, "
             "want one split-K launch each and nothing else")
    print(f"{label}: {prof['fused_calls']} fused calls, "
          f"{got.get('am_splitk_kernel', 0)} CUDA launches (split-K only, no "
          "prep kernel)", flush=True)


def profile_call(torch, api, params, ecfg, c: int) -> dict:
    """One (slots, c) engine model step on a fresh cache."""
    toks = torch.zeros(ecfg.slots, c, dtype=torch.long, device=api.device)

    def call():
        cache = api.init_slot_cache(ecfg.slots, ecfg.max_len, torch.bfloat16)
        api.decode_slots(params, toks, cache, [c] * ecfg.slots)

    return profile_fn(torch, f"main: profile (slots, {c}) step", call,
                      f"host_profile_c{c}.txt")


# ---------------------------------------------------------------------------
# lock-step paths
# ---------------------------------------------------------------------------

BATCH, GEN = 4, 32
#: arch: (prompt length, packed-layer wrapper calls per layer at prefill and
#: at decode, packed head calls per step).  olmo-1b runs its fused q|k|v
#: and gate|up groups at prefill rows and their members at decode rows
#: (M = 4 <= DECODE_M_MAX) and has a tied float head; rwkv6 has no fusable
#: group and a packed head.
LEGACY = {"olmo-1b": (1024, 4, 7, 0), "rwkv6-1.6b": (512, 8, 8, 1)}


def wrappers() -> dict:
    from repro_torch.kernels import approx_matmul as amk
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.kernels import rwkv6_scan as rsk

    return {"approx_matmul_cv_fused": amk.approx_matmul_cv_fused,
            "approx_matmul_cv": amk.approx_matmul_cv,
            "flash_attention": fak.flash_attention,
            "rwkv6_scan": rsk.rwkv6_scan}


def run_legacy_path(torch, dev, arch: str) -> dict:
    """Phase 5: one arch through ``launch.serve.run_legacy`` at full width
    and depth: B=4, the arch's prompt length, 32 greedy tokens."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.approx_linear import iter_tensors
    from repro_torch.core.policy import ApproxPolicy
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.kernels import rwkv6_scan as rsk
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.numerics import get_preset

    prompt_len, pre_calls, dec_calls, head_calls = LEGACY[arch]
    cfg = get_config(arch)
    print(f"legacy: {cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab} rwkv={cfg.rwkv} "
          f"compute={cfg.compute_dtype}; B={BATCH} T={prompt_len} G={GEN}",
          flush=True)
    spec = get_preset("serve-default", policy=ApproxPolicy(
        "perforated", 2, use_cv=True, backend="pallas"))
    spec_path = ROOT / "build" / "legacy_spec.json"
    spec_path.parent.mkdir(exist_ok=True)
    spec_path.write_text(spec.to_json())

    def args(gen):
        return argparse.Namespace(
            arch=arch, batch=BATCH, prompt_len=prompt_len, gen=gen,
            mode="perforated", m=2, no_cv=False, preset=None,
            spec_json=str(spec_path), device="cuda")

    api = build_model(cfg, dev)
    params = api.init(0)
    serve.run_legacy(args(2), params=params)  # warm-up, not counted
    torch.cuda.synchronize()
    wr = wrappers()
    for w in wr.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res = serve.run_legacy(args(GEN), params=params)
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in wr.items()}
    peak = torch.cuda.max_memory_allocated()
    packed = res["params"]
    del params
    check_packs(f"legacy {arch}", packed)

    per_prefill = cfg.n_layers
    expected = {
        "approx_matmul_cv_fused": cfg.n_layers * (pre_calls + dec_calls * (
            GEN - 1)) + head_calls * GEN,
        "approx_matmul_cv": 0,
        "flash_attention": 0 if cfg.rwkv else per_prefill,
        "rwkv6_scan": per_prefill if cfg.rwkv else 0}
    print(f"legacy: {arch} wrapper launches {launches}, the schedule implies "
          f"{expected} (one prefill, {GEN - 1} decode steps)", flush=True)
    if launches != expected:
        fail(f"legacy {arch}: launches {launches} != {expected}")
    toks = res["tokens"]
    if toks.shape != (BATCH, GEN) or not bool(
            ((toks >= 0) & (toks < cfg.vocab)).all()):
        fail(f"legacy {arch}: tokens {tuple(toks.shape)} out of range")

    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (BATCH, prompt_len)), device=dev)

    def last_logits():
        return api.prefill(packed, {"tokens": prompt}, prompt_len + GEN)[0]

    l1, l2 = last_logits(), last_logits()
    torch.cuda.synchronize()
    if l1.shape != (BATCH, cfg.vocab) or l1.dtype != torch.float32 \
            or not bool(torch.isfinite(l1).all()):
        fail(f"legacy {arch}: logits {l1.dtype} {tuple(l1.shape)} not finite")
    if not torch.equal(l1, l2):
        fail(f"legacy {arch}: two identical prefills gave different logits")
    first = []  # the first layer's scan inputs in the plain run

    def scan_plain(*a, **kw):
        if not first:
            first.append(a)
        return rsk.rwkv6_scan_plain(*a, **kw)

    swap = ([(rsk, "rwkv6_scan", scan_plain)] if cfg.rwkv else
            [(fak, "flash_attention", fak.flash_attention_plain)])
    with plain_swapped(f"legacy {arch}", swap):
        lp = last_logits()
    torch.cuda.synchronize()
    gap = float((l1 - lp).abs().max())
    agree = float((l1.argmax(-1) == lp.argmax(-1)).float().mean())
    print(f"legacy: {arch} deterministic; last-token prefill logits with "
          f"{swap[0][1]} swapped for its plain version: max gap {gap:.4g} "
          f"(logit scale {float(l1.abs().max()):.4g}), argmax agreement "
          f"{agree:.2f}", flush=True)
    flips = None
    if first:  # where the gap starts: the model casts the WKV output to bf16
        o_k, o_p = rsk.rwkv6_scan(*first[0])[0], rsk.rwkv6_scan_plain(
            *first[0])[0]
        diff = (o_k - o_p).abs()
        flips = int((o_k.bfloat16() != o_p.bfloat16()).sum())
        print(f"legacy: {arch} first layer's WKV output, kernel against plain "
              f"on the same inputs: max abs diff {float(diff.max()):.3g}, "
              f"median relative diff "
              f"{float((diff / o_p.abs().clamp_min(1e-30)).median()):.3g}; "
              f"{flips} of {o_p.numel()} values differ once rounded to "
              "bfloat16", flush=True)
    cache = api.prefill(packed, {"tokens": prompt}, prompt_len + GEN)[1]
    tok = torch.zeros(BATCH, 1, dtype=torch.long, device=dev)
    breakdown = {
        "prefill": profile_fn(torch, f"legacy: {arch} profile prefill",
                              last_logits, f"host_profile_{arch}_prefill.txt"),
        # one decode step after the prompt; the ten profiled steps stay
        # inside the cache's GEN free positions
        "decode": profile_fn(torch, f"legacy: {arch} profile decode step",
                             lambda: api.decode_step(packed, tok, cache),
                             f"host_profile_{arch}_decode.txt")}
    check_one_launch(f"legacy: {arch} decode step", breakdown["decode"])
    line = {"arch": arch, "layers": cfg.n_layers, "batch": BATCH,
            "prompt_len": prompt_len, "gen": GEN,
            "prefill_ms": res["prefill_s"] * 1e3,
            "pack_gib": storage_gib(iter_tensors(packed)),
            "k_major_gib": k_major_gib(packed),
            "decode_ms_per_token": res["decode_s_per_step"] * 1e3,
            "tok_per_s": res["tok_per_s"], "peak_mem_gib": peak / 2**30,
            "plain_gap": gap, "plain_argmax_agreement": agree,
            "scan_bf16_flips_layer0": flips,
            "launches": launches, "step_breakdown": breakdown}
    print(f"legacy: {arch} prefill_ms {line['prefill_ms']:.2f}", flush=True)
    print(f"legacy: {arch} decode_ms_per_token "
          f"{line['decode_ms_per_token']:.2f} (one token per sequence per "
          f"step, {BATCH} sequences)", flush=True)
    print(f"legacy: {arch} tok_per_s {line['tok_per_s']:.1f}", flush=True)
    print(f"legacy: {arch} peak_mem_gib {line['peak_mem_gib']:.3f} (serving "
          f"params {line['pack_gib']:.3f} GiB, K-major weight codes "
          f"{line['k_major_gib']:.3f} GiB of it)", flush=True)
    print("legacy: " + json.dumps(line), flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / f"legacy_{arch}.json").write_text(
        json.dumps(line) + "\n")
    return line


def attn_scan_times(torch, dev, card: str) -> dict:
    """Phase 6, second half: flash attention at the olmo-1b prefill shape
    and the scan at the rwkv6-1.6b prefill shape (kernel, plain, library,
    bound)."""
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.kernels import rwkv6_scan as rsk

    bw, _, bf16_peak, _ = peaks(card)
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = {}

    b, hq, hkv, t, _, d, *_ = FLASH_CASES[0]
    bf = torch.bfloat16
    # 48 MB of q, k, v per call: three copies exceed the 50 MB L2
    qkv = [tuple(torch.randn(b, h, t, d, generator=gen, device=dev).to(bf)
                 for h in (hq, hkv, hkv)) for _ in range(3)]
    flops = 4.0 * b * hq * d * t * (t + 1) / 2  # QK and PV, visible pairs
    nbytes = 2.0 * (2 * b * hq * t * d + 2 * b * hkv * t * d)  # q, out, k, v
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_ops, t_bytes = flops / bf16_peak, nbytes / bw
    rows["flash_attention"] = {
        "shape": [b, hq, hkv, t, d], "dtype": "bfloat16", "causal": True,
        "kernel_us": time_calls(torch, [lambda a=a: fak.flash_attention(*a)
                                        for a in qkv]) * 1e6,
        "plain_us": time_calls(torch, [lambda a=a: fak.flash_attention_plain(*a)
                                       for a in qkv[:2]], reps=5) * 1e6,
        "library_us": time_calls(torch, [lambda a=a: sdpa(*a, is_causal=True)
                                         for a in qkv]) * 1e6,
        "bound_us": max(t_ops, t_bytes) * 1e6,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print("time " + json.dumps(rows["flash_attention"]), flush=True)
    del qkv

    b, t, h, dk, dv, *_ = SCAN_CASES[0]
    ins = [scan_inputs(torch, b, t, h, dk, dv, bf, gen, dev) for _ in range(3)]
    n_ch, ell, tri = -(-t // 32), 32, 32 * 31 / 2
    # the products on the TF32 tensor cores (half the bf16 rate on Hopper),
    # each in the passes the kernel runs: A = r~ k~^T (3) and A V (2, v is
    # bf16) over the strict lower triangle, r~ S (3) and k~^T V (2) in full
    flops = 2.0 * b * h * n_ch * (3 * tri * dk + 2 * tri * dv
                                  + 5 * ell * dk * dv)
    nbytes = (b * t * h * (2 * dk * 2 + dv * 2 + dk * 4 + dv * 4)
              + b * h * dk * dv * 4 + h * dk * 4)
    t_ops, t_bytes = flops / (bf16_peak / 2), nbytes / bw
    rows["rwkv6_scan"] = {
        "shape": [b, t, h, dk, dv], "dtype": "bfloat16",
        "blocks": rsk.grid_blocks(b, h),
        "kernel_us": time_calls(torch, [lambda a=a: rsk.rwkv6_scan(*a)
                                        for a in ins]) * 1e6,
        "plain_us": time_calls(torch, [lambda a=a: rsk.rwkv6_scan_plain(*a)
                                       for a in ins[:2]], reps=5) * 1e6,
        "library_us": None,
        "bound_us": max(t_ops, t_bytes) * 1e6,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print("time " + json.dumps(rows["rwkv6_scan"]), flush=True)
    return rows


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=16,
                    help="olmo-1b depth for the engine path (widths are "
                    "never cut; the lock-step paths run at full depth)")
    args = ap.parse_args()
    t_start = time.perf_counter()

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

    from repro_torch import kernels
    from repro_torch.kernels import nvcc

    t0 = time.perf_counter()
    kernels.build_all()  # one nvcc per source, all at once
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    if nvcc.BUILD_LOG:
        os.makedirs(ROOT / "chiprun_out", exist_ok=True)
        (ROOT / "chiprun_out" / "build.log").write_text("\n".join(
            f"== {name} ({log['seconds']:.1f} s)\n{log['output']}"
            for name, log in nvcc.BUILD_LOG.items()))
        for name, log in nvcc.BUILD_LOG.items():
            for line in log["output"].splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: " + line.strip(), flush=True)

    errs = check_kernels(torch, dev)
    errs.update(check_attention_and_scan(torch, dev))
    # every path is driven with the launch counts zeroed just before it and
    # read just after it
    paths = {"engine olmo-1b": run_main_path(torch, dev, args.layers)}
    for arch in LEGACY:
        paths[f"legacy {arch}"] = run_legacy_path(torch, dev, arch)["launches"]
    launches = {n: sum(p[n] for p in paths.values()) for n in wrappers()}
    print("launches by path: " + json.dumps(paths), flush=True)
    rows = kernel_times(torch, dev, card)
    new_rows = attn_scan_times(torch, dev, card)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "kernel_times.json").write_text(
        json.dumps({"card": card, "rows": rows, "attention_scan": new_rows},
                   indent=1))
    entries = []
    for name, src_line in (("approx_matmul_cv_fused", 332),
                           ("approx_matmul_cv", 166)):
        dec = step_entry(rows, name, DECODE_KN, 4)
        pre = step_entry(rows, name, PREFILL_KN, 128)
        print(f"{name} per layer, decode step (7 launches, M=4): "
              + json.dumps(dec), flush=True)
        print(f"{name} per layer, rwkv6-1.6b decode step ({len(RWKV_KN)} "
              "launches, M=4): " + json.dumps(step_entry(rows, name, RWKV_KN,
                                                        4)), flush=True)
        print(f"{name} rwkv6-1.6b head, decode step (1 launch, M=4): "
              + json.dumps(step_entry(rows, name, [RWKV_HEAD_KN], 4)),
              flush=True)
        print(f"{name} per layer, prefill step (4 launches, M=128): "
              + json.dumps(pre), flush=True)
        if name == "approx_matmul_cv_fused":
            for label, kn, mm in (("olmo-1b", PREFILL_KN, OLMO_PREFILL_M),
                                  ("rwkv6-1.6b", RWKV_KN, RWKV_PREFILL_M)):
                print(f"{name} per layer, {label} lock-step prefill "
                      f"({len(kn)} launches, M={mm}): "
                      + json.dumps(step_entry(rows, name, kn, mm)),
                      flush=True)
        entries.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/approx_matmul.cu",
            "replaces": f"src/repro/kernels/approx_matmul.py:{src_line}",
            # wrapper calls on the three paths (a fused call is one CUDA
            # launch at decode rows, the prep and a matmul kernel above)
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": (dec["kernel_us"] + pre["kernel_us"]) / 1e3,
            "plain_ms": (dec["plain_us"] + pre["plain_us"]) / 1e3,
            "bound_ms": (dec["bound_us"] + pre["bound_us"]) / 1e3,
            "bound_by": dec["bound_by"],
            "library_ms": (dec["library_us"] + pre["library_us"]) / 1e3,
        })
    for name, src in (("flash_attention", "flash_attention.py:114"),
                      ("rwkv6_scan", "rwkv6_scan.py:95")):
        r = new_rows[name]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/{src}",
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": r["kernel_us"] / 1e3, "plain_ms": r["plain_us"] / 1e3,
            "bound_ms": r["bound_us"] / 1e3, "bound_by": r["bound_by"],
            "library_ms": (None if r["library_us"] is None
                           else r["library_us"] / 1e3),
        })
    print(f"smoke: {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
