"""Card check for the PyTorch/CUDA port: `python3 chip_smoke.py`.

Drives the port (`src/repro_torch`, no JAX) on one CUDA card:

1. device: name and power limit; TF32 off;
2. build: compiles the three CUDA sources from the checkout, one `nvcc`
   each, all at once;
3. kernels: every kernel against its plain PyTorch version on the card:
   approx-matmul for every multiplier mode at the serving shapes (decode
   M=4, engine chunk M=128, olmo-1b prefill M=4096 at K=2048 and 8192,
   rwkv6-1.6b prefill M=2048 at K=7168, qwen3-4b's layers at M=4, 128 and
   4096 (K=2560, 4096, 9728) and its decode members, a ragged M=1000 with
   a K off the tile), granite-8b's and deepseek-67b's layers at M=4 and
   4096 in bf16, decode rows at M=1 and 8, rwkv6-1.6b's decode shapes and
   head, fused-group members reading a row slice of their group's codes, a
   fused q|k|v pack with per-column biases on both tiles, ragged decode
   calls, inputs on quantization ties, plus exact-integer accumulator
   checks (M=4, 128, 300), qwen2-vl-2b's and hubert-xlarge's layers
   (biases included) at M=4, 128 and 4096 and their decode members,
   hubert's head (N=504) on both tiles, deepseek-v2-lite-16b's and
   moonshot-v1-16b-a3b's new shapes (q N=3072, the shared experts'
   gate|up N=5632 and down K=2816, the dense layer's gate|up N=21888 and
   down K=10944, the head N=102400) at M=4 and 128, hymba-1.5b's layers
   (q|k|v 1600+320+320, in_proj N=6400, out_proj K=3200, gate|up, down,
   the head N=32001, x_proj N=132, dt_proj K=100 with its bias) at M=4
   and 128 and its new shapes at the prefill's M=8192, equal to
   the plain version on every matmul tile of the source, and every decode
   call twice bit-equal;
   the CNN suite's conv and head shapes (K = 16 ... 1152, N = 4 ... 128)
   in float32 at M = 4, 250, 4,001, 16,000 and 256,000 and one in
   bfloat16 at (16,000, 27, 16), every mode, CV on and off, each call
   above 8 rows on the conv kernel where K * N <= 36,864 (every (K, N)
   but vgg's (576, 128) and (1152, 128), which keep the wgmma tile; the
   route of each (K, N) printed);
   flash attention at the olmo-1b, qwen3-4b (GQA 32/8), qwen2-vl-2b
   (GQA 12/2) and hymba-1.5b (GQA 25/5, D=64, window 1024 of T=2048)
   prefill shapes and hubert-xlarge's encoder (D=80, non-causal), the JAX
   kernel tests' shapes in float32 and bfloat16 (GQA,
   window, non-causal, Tq < Tk at D=16, 64, 80 and 128), ragged lengths
   (D=128, 80 and 16), the quickstart example's float32 shapes
   (olmo-1b, and olmo-1b-reduced at D=16), and in float32 at D=16 and 128
   Tq > Tk and a window with Tq > Tk (rows with no visible key give 0),
   and at D=64 a non-causal Tk = 4096, each row held to its own scale,
   every float32 call twice bit-equal and also held to a float64
   reference;
   the RWKV6 scan (out and final state, and two calls bit-equal) at the
   rwkv6-1.6b prefill shape, the JAX tests' shapes, ragged and partial
   chunks, one head, Dk != Dv and the extreme decays;
4. engine paths, each served by the port's continuous-batching engine (8
   requests of `mixed_trace(seed=0)`, slots 4, max_len 256, chunk 32):
   full-width olmo-1b (8 of its 16 layers by default, `--layers`; every
   olmo-1b phase below runs on these packs) and qwen3-4b (36 layers) on
   `backend: "pallas"`
   packs with a bf16 KV cache, each again on the paged KV layout (blocks
   of 16, prefix cache on) after a warmed shared-prefix pair and a
   full-prompt repeat (tokens equal the contiguous run's and a sequential
   decode's, prefix hits, a copy on write, the NULL block zero, KV bytes
   in use at peak against the contiguous cache's); olmo-1b with request
   deadlines (3 expire in the queue, 1 mid-prompt); olmo-1b under the
   `int8` preset and then with self-verifying speculative decode (the
   `int8` pack verifies, the `serve-default` kernel pack drafts, k=4) on
   the contiguous and paged layouts and with a no-CV draft (tokens equal
   the `int8` engine's, kernel launches only in draft calls, the
   acceptance rate with and without the CV, one round profiled against an
   `int8` thin step); qwen3-4b at 6 of its 36 layers (its lock-step
   path below runs all 36), again with the int8 KV cache and under the
   `int8` preset (plain exact-integer products), full-width
   rwkv6-1.6b at 8 of its 24 layers (per-slot recurrent state; the
   lock-step path runs all 24) and qwen2-vl-2b at 14 of its 28 layers
   (token prompts, M-RoPE ids equal; the lock-step path runs all 28).
   Checks
   completion, the kernel launch count the schedule implies, that each
   request's tokens equal a sequential decode of it on the same packs
   (rwkv6: the lock-step recurrent decode), that the packs hold their
   codes only K-major (fused-group members as row slices of the group's),
   that a thin step's fused calls are one CUDA launch each, device
   placement, determinism, kernel path equal to plain path, and (olmo-1b)
   that the control variate reaches the logits; then, on the qwen2-vl-2b
   engine phase's packs, its multimodal prefill ((4, 1024, 1536)
   embeddings with (3, 4, 1024) M-RoPE ids holding a 16 x 16 image block,
   32 decode steps) with the lock-step checks below;
4b. the robustness layer, on the olmo-1b packs after the speculative runs:
   the error probe every 4 steps on the main trace for the kernel pack
   with and without the CV and for the `int8` pack (the probed run's tokens
   and final KV cache equal the unprobed main run's, the probes' kernel
   launches, the no-CV layer error variances above the CV's, `int8` at
   float-ulp level, one thin and one chunk probe profiled with the live
   cache byte-equal after them); `nan@3` with detection on the `int8`
   pack, contiguous and paged (tokens equal the clean `int8` run's,
   injected = detected = replays, one injector log), `spike@5` on the
   kernel pack replayed on the `int8` pack, one replay profiled; the
   accuracy-SLO governor over serve-default -> int8 -> float (its SLO 4x
   the measured CV logits variance, dense noise on steps 0-24 of a
   16-request trace: an escalation inside the noise and a relax after it,
   each rung packed once and timed, the engine's numerics following every
   decision, the power attribution); and `auto(...)`: the `paper-grid`
   preset lowered on resnet44 at full width from 256 calibration images
   (its policies, forwards and seconds, mean modeled saving, and relative
   logit error on 1,000 test images beside serve-default's);
   "checkpoint" (after the fleet phase): the olmo-1b engine phase's
   full-width float32 parameters (2.56 GB at 8 layers) saved with
   `save_pytree`
   (codec none, the NumericsSpec in the meta), restored onto the card
   (every leaf bit-equal), packed again (byte-equal to the engine phase's
   packs) and served on the main trace through the approx kernel (tokens
   and launches equal to the engine phase's run); `plan
   --diff-checkpoint` on the shard (0 under its spec, 7 under `int8`); the
   train CLI at olmo-1b-reduced, twice in one directory (the second run
   resumes); `run_resilient` with two injected failures against a clean
   run (every restore bit-equal to the saved state, losses and parameters
   within the train phase's tolerances, the straggler flags); save and
   load MB/s by codec on one 64 MiB leaf and the projected save time of a
   full-width training checkpoint under the default codec;
4c. "moe": deepseek-v2-lite-16b at full width and depth (27 layers: MLA,
   one dense layer, 64 routed experts top-6 and 2 shared) on
   `serve-default` kernel packs built a layer at a time (a float32 tree
   and its serving copy do not fit on the card together), through the
   engine (the main trace, bf16 KV cache): 109 fused calls a chunk step and
   136 a thin step, tokens equal to a sequential decode, the kernel path
   bit-equal to the plain one, one CUDA launch a thin step's fused call;
   then the paged layout as above; then through the serve CLI
   (`run_serve_cli`: 4 requests, built a layer at a time, the checks of
   4d); then moonshot-v1-16b-a3b at full width
   and 8 of its 48 layers (depth cut for time and memory) with the same
   engine checks; prints gen tok/s, TTFT and ITL, a thin and a chunk
   step's wall and device ms, params GiB with the float experts apart, KV
   GiB beside a GQA cache of the same heads, peak GiB of build and run;
4d. "granite-8b" (after the qwen2-vl-2b phase): the serve CLI in this
   process (`run_serve_cli`: `--engine --arch granite-8b --spec-json
   <pallas spec>`, the whole float32 tree, then its serving copy) at
   full width and depth (36 layers), 8 requests of the main trace, slots
   4, max_len 256, chunk 32, bf16 KV; the CLI's build route, seconds and
   peak GiB, params GiB with the K-major codes apart, gen tok/s, TTFT and
   ITL, a profiled thin and chunk step; every request finishes, tokens
   equal a sequential decode on the same packs, fused launches equal the
   steps' fused calls, 2 compiled shapes, the kernel path equal to the
   plain one, one CUDA launch a thin step's fused call;
5. lock-step paths (`launch.serve.run_legacy`): full-width olmo-1b,
   qwen3-4b and qwen2-vl-2b (B=4, T=1024) and rwkv6-1.6b (B=4, T=512), 32
   tokens each,
   `serve-default` with `backend: "pallas"`; checks finite logits,
   determinism, the launch counts the schedule implies, the packs and one
   launch a decode call as above, the logit gap to the same prefill with
   the flash and scan kernels swapped for their plain versions, and each
   layer's flash (scan) call against its plain version on the kernel
   path's own layer input (teacher-forced, so the gap cannot compound),
   within the kernel's per-call tolerance; then "hybrid": hymba-1.5b
   the same way at full width and depth (32 layers, B=4, T=2048, so the
   window of 1024 binds and the ring wraps), plus every flash call of a
   prefill in window mode at GQA group 5, the fused calls at hymba's (M,
   K, N), the kernel path's prefill logits bit-equal to the plain path's,
   the loop again over an int8 ring cache (launches, the SSM state
   float32, token agreement with bf16), and the SSM recurrence's share of
   a prefill and a decode step; then "train" (`launch.train`): olmo-1b,
   rwkv6-1.6b and hymba-1.5b at full width cut to 2 layers, float32, 2
   steps on the card against the same steps on the host (losses rtol
   1e-4, parameters atol 1e-4), then olmo-1b at full width and depth, 8
   steps of B=4, T=512 on the synthetic stream (each step's loss, wall
   ms, tokens/s, a profiled step's device ms, peak GiB; losses finite,
   the last below the first; no inference kernel launched); then
   hubert-xlarge's
   encoder (48 layers, `forward` over (4, 1024, 1280) frame embeddings:
   non-causal flash at D=80, the N=504 head on the prefill tile), with the
   same launch, determinism, plain-gap and teacher-forced checks;
5b. "distributed", right after the moe phase's deepseek-v2-lite-16b
   engine and on its packs, over an NCCL process group of one rank and a
   (1, 1) ("data", "model") mesh (no gloo, no CPU fallback; destroyed
   before the later phases): the same trace through the engine with
   `moe_impl="ep_psum"` and `mesh=` (tokens and approx-matmul launches
   equal the local run's, one NCCL all-reduce a MoE layer a call); the
   sharded training step, olmo-1b at full width and 2 layers in bf16 with
   FSDP and sequence parallelism, then `dp_only` on a (1,) mesh, 2 steps
   each against the unsharded step (losses and state bit-equal; wall and
   device ms a step); `rs_matmul_overlapped` at (4096, 2048) x (2048,
   8192) and `compressed_psum` of the sharded step's gradients against
   their plain forms; the sharded state saved under (1, 1) and restored
   under (1,), bit-equal; and the dry run of every reference cell on both
   production meshes at H100 constants, started in the background at the
   script's start (`python -m repro_torch.launch.dryrun --all`, niced, 3
   workers, CPU only): one line a cell (`chiprun_out/dryrun/`,
   `distributed.json`);
6. the paper's CNN path: the six CNN_SUITE nets at full width (CIFAR
   geometry, seeded float weights), calibrated on 256 procedural train
   images and packed (`backend: "pallas"`) at every paper-grid point with
   the CV on and off, evaluated on 1,000 test images in batches of 250:
   the launch counts the layer lists imply, the relative logit error and
   top-1 agreement against the float model with and without the CV, the
   modelled power saving, the `int8` preset's error, kernel-path logits
   bit-equal to the plain version's at one point per mode, one point per
   mode at 100 classes, a profiled B=250 forward (one conv-kernel launch
   a conv-shaped call, no prep kernel) and the time of each net's largest
   approx call at perforated m=2 and truncated m=7; and one point per
   mode of the reference's
   default `backend: "jnp"` grid, CV on: folded float32 operands against
   `fold=False` (the exact-integer product) and the kernel sweep, the fold
   bytes against the plan's, a grouped-CV (4 groups) pack's error beside
   single-CV's, and a profiled B=250 forward, folded and `fold=False`;
6b. "paper", the paper's own evaluation (`repro_torch.paper`): Table 1
   (every entry over 1M sample pairs, the card's integer error sums equal
   to the host's), the conv-error bench (every row: mean nullified, Eq. 20
   within 0.1), Figs. 7-9 and Table 5; then Tables 2-4 through the bench's
   own `run`: the six nets trained on the card (the reference's SGD
   recipe, 300 steps at batch 64) at 10 and 100 classes, calibrated,
   packed at every paper-grid point with the CV on and off (`backend:
   "pallas"`, every layer packed) and evaluated on 1,000 test images, the
   launches counted; per net its first 5 training steps on the card
   against the host's, its training trained (loss falling, float accuracy
   above twice chance) or one of the recipe's failure modes (collapse to
   the uniform prediction, divergence: printed, kept out of the summary),
   and at one point per mode, CV on and off, kernel logits bit-equal to the
   plain version's and (nets that trained) top-1 predictions agreeing with
   the `jnp` pack's on 99% of the test images;
   prints the rows, the mean accuracy loss with and without the CV, the
   modelled power saving and Fig. 10 (`chiprun_out/paper.json`);
6c. "examples" (`repro_torch.examples`, the reference's `jnp` backend: no
   approx-matmul launch; quickstart's forwards run flash, a launch a
   layer): quickstart at olmo-1b's full width (the seven mean
   |logit err| rows, finite), and its `main` at its defaults
   (olmo-1b-reduced, head dim 16) on the card against the host (table
   equal, float logits within 2e-5, each forward's first differing
   activation code on a rounding boundary, rows within 5e-3, beside the
   host's own rows with one boundary code flipped); serve_approx on qwen3-4b
   at full width (10 requests, int8 KV: every request finishes or is
   rejected as the admission controller rejects it); train_lm's ~100M
   model for 100 steps (the example's default is 300) of B=8, T=256
   with checkpoints every 50 (codec
   none; tokens/s, step ms, peak GiB, the loss every 50 steps; the last
   20 steps' mean loss below the first 20's, every loss finite); and
   pareto_sweep on the paper phase's cached resnet44/c10 weights (every
   power equal to the cost model's, every accuracy loss within 1 point of
   the paper phase's row) (`chiprun_out/examples.json`);
7. kernel times at the paths' shapes (kernel, plain, library, bound),
   the approx-matmul also at the prefills' and the encoder's shapes and
   at the decode shapes of qwen3-4b, rwkv6-1.6b (head too), qwen2-vl-2b
   and hymba-1.5b (head too), and (kernel only: no phase drives them) at
   the shapes of hubert-xlarge's `--legacy` decode step and head, flash at
   the five prefill and encoder shapes beside
   `scaled_dot_product_attention` (hymba's window as its boolean mask),
   and its float32 route (3xTF32 on the TF32 tensor cores, bound at three
   passes at the TF32 rate, the float32 CUDA-core figure beside it) at
   quickstart's two shapes, olmo-1b's prefill and hubert's encoder beside
   SDPA in float32;
   the codes-in entry also at olmo-1b's prefill rows, and its other
   design (the rows tile) beside it at the chunk and prefill rows.

Prints the card line and one `kernels` JSON line before the last line, and
ends with `{"ok": true, "device": {...}}`.  Any failure exits non-zero.

`python3 chip_smoke.py --compare-codes-entry OTHER` runs no check: it times
the codes-in entry on olmo-1b's layers in the checkout at OTHER (say, the
parent commit unpacked with `git archive`) and in this one, each tree in
processes of its own, in the order other, this, this, other;
`--compare-flash-f32 OTHER` does the same for flash's float32 route at its
four timed shapes.
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
OLMO_PREFILL_M, RWKV_PREFILL_M, QWEN_PREFILL_M = 4096, 2048, 4096
#: prefill rows of the kernel checks at granite-8b's and deepseek-67b's
#: widths (B=4 x T=1024)
WIDE_PREFILL_M = 4096
#: qwen3-4b's packed layers: fused q|k|v (q 4096, k 1024, v 1024 columns),
#: o (q_dim 4096 -> d_model 2560), fused gate|up, down; decode steps run
#: the members (q, k, v, o, gate, up, down)
QWEN_QKV = (4096, 1024, 1024)
QWEN_KN = [(2560, 6144), (4096, 2560), (2560, 19456), (9728, 2560)]
QWEN_DECODE_KN = [(2560, 4096), (2560, 1024), (2560, 1024), (4096, 2560),
                  (2560, 9728), (2560, 9728), (9728, 2560)]
#: qwen2-vl-2b's packed layers: fused q|k|v with biases (q 1536, k 256, v
#: 256 columns), o, fused gate|up, down; decode steps run the members
QWEN2VL_QKV = (1536, 256, 256)
QWEN2VL_KN = [(1536, 2048), (1536, 1536), (1536, 17920), (8960, 1536)]
QWEN2VL_DECODE_KN = [(1536, 1536), (1536, 256), (1536, 256), (1536, 1536),
                     (1536, 8960), (1536, 8960), (8960, 1536)]
#: hubert-xlarge's packed layers: fused q|k|v (no biases), o, the gelu
#: MLP's up and down (with biases) and the untied head (N = 504, off every
#: column tile); decode-shaped calls run the members (q, k, v, o, up, down)
#: in the `--legacy` decode step, which no phase here drives: those shapes
#: are checked and timed as kernel cases only
HUBERT_QKV = (1280, 1280, 1280)
HUBERT_KN = [(1280, 3840), (1280, 1280), (1280, 5120), (5120, 1280)]
HUBERT_DECODE_KN = [(1280, 1280)] * 4 + [(1280, 5120), (5120, 1280)]
HUBERT_HEAD_KN = (1280, 504)
#: rows of the qwen2-vl-2b lock-step and embeds prefills and of the
#: hubert-xlarge encoder forward: B=4 x T=1024
QWEN2VL_PREFILL_M = HUBERT_M = 4096
#: the widths of granite-8b and deepseek-67b (kernels only; the models are
#: not built here): (K, member widths) of fused q|k|v, fused gate|up, down
WIDE_KN = {"granite-8b": [(4096, (4096, 1024, 1024)), (4096, (14336, 14336)),
                          (14336, (4096,))],
           "deepseek-67b": [(8192, (8192, 1024, 1024)),
                            (8192, (22016, 22016)), (22016, (8192,))]}
#: deepseek-v2-lite-16b's packed layers (MLA packs q and o; kv_a, kv_b,
#: the router and the routed experts stay float): q, o, the shared
#: experts' fused gate|up and down a chunk step, their members a thin
#: step; the leading dense layer's; the untied head (moonshot-v1-16b-a3b's
#: layers have olmo-1b's q|k|v and o and deepseek's shared experts; its
#: head is held against the plain version by the moe phase's
#: kernel_vs_plain)
DSV2_KN = [(2048, 3072), (2048, 2048), (2048, 5632), (2816, 2048)]
DSV2_DECODE_KN = [(2048, 3072), (2048, 2048), (2048, 2816), (2048, 2816),
                  (2816, 2048)]
DSV2_DENSE_KN = [(2048, 3072), (2048, 2048), (2048, 21888), (10944, 2048)]
DSV2_DENSE_DECODE_KN = [(2048, 3072), (2048, 2048), (2048, 10944),
                        (2048, 10944), (10944, 2048)]
DSV2_HEAD_KN = (2048, 102400)
#: hymba-1.5b's packed layers under serve-default (x_proj and dt_proj stay
#: float by the serving keep-float rules): fused q|k|v (q 1600, k 320, v
#: 320 columns: GQA 25/5 at head dim 64), o, the SSM's in_proj (N = 6400)
#: and out_proj (K = 3200), fused gate|up, down; decode steps run the
#: members; the untied head (N = 32001, the first odd N), one call a step
#: at M = B (the prefill's last token, then each decode step)
HYMBA_QKV = (1600, 320, 320)
HYMBA_KN = [(1600, 2240), (1600, 1600), (1600, 6400), (3200, 1600),
            (1600, 11008), (5504, 1600)]
HYMBA_DECODE_KN = [(1600, 1600), (1600, 320), (1600, 320), (1600, 1600),
                   (1600, 6400), (3200, 1600), (1600, 5504), (1600, 5504),
                   (5504, 1600)]
HYMBA_HEAD_KN = (1600, 32001)
#: the SSM's x_proj (N = dt_rank + 2 d_state = 132) and dt_proj (K =
#: dt_rank = 100, with its bias), packed by a spec without the keep-float
#: rules: kernel cases only
HYMBA_SSM_FLOAT_KN = [(3200, 132), (100, 3200)]
#: rows of the hymba lock-step prefill: B=4 x T=2048
HYMBA_PREFILL_M = 8192
#: decode-row cases (M, K, N) beyond the path shapes: one and DECODE_M_MAX
#: rows at olmo-1b's shapes, rwkv6-1.6b's key and value projections and head,
#: a ragged call (K off 16 bytes, N off the 32-column tile)
DECODE_CASES = [(1, 2048, 2048), (8, 2048, 2048), (1, 8192, 2048),
                (8, 8192, 2048), (8, 2048, 8192), (4, 2048, 7168),
                (4, 7168, 2048), (4,) + RWKV_HEAD_KN, (3, 1000, 1000)]
#: the codes-in entry's prefill-row times: olmo-1b's lock-step prefill
CODES_PREFILL = {(OLMO_PREFILL_M, k, n) for k, n in PREFILL_KN}
#: ragged codes-in cases (M, K, N): the CNNs' first-layer fan-in (27) at
#: 16 and 48 columns, K = 2000 at an odd N (the rows tile), K = 2000 at N
#: = 1008 and 2000 (the transposing tiles' K and N edges: 2000 = 15 x 128
#: + 80, 1008 and 2000 off their 128- and 256-column tiles), hymba-1.5b's
#: head at decode rows; 9 rows (just past the decode window) and 4,001 (a
#: partial last row tile after many full ones)
CODES_RAGGED = [(mm, 27, n) for mm in (4, 9, 4_001) for n in (16, 48)] + [
    (mm, 2000, 1001) for mm in (4, 9, 4_001)] + [
    (9, 2000, 1008), (4_001, 2000, 1008), (4_001, 2000, 2000),
    (4, 1600, 32001)]
#: the codes-in entry's other design, timed beside it at olmo-1b's chunk
#: and prefill rows: the mma.sync rows tile (the transposing wgmma tiles
#: take those calls)
CODES_OTHER = "rows_64x128"
#: the CNN phase (the paper's six CNNs, CIFAR geometry): the reference
#: accuracy benchmark's calibration images, test images and eval batch
#: (benchmarks/tables2_4_accuracy.py), and the row counts at which every
#: conv and head shape is held against its plain version: split-K rows,
#: the heads at the eval batch, a partial last row tile after a hundred
#: and more full ones (4,001), 8 x 8 and 32 x 32 maps at B = 250
CNN_CALIB, CNN_TEST, CNN_BATCH = 256, 1000, 250
CONV_M = (4, 250, 4_001, 16_000, 256_000)
#: the conv shape also held against its plain version with bfloat16 x
CONV_BF16_CASE = (16_000, 27, 16)
#: approx calls a forward of each suite net makes (its convs and fcs)
CNN_LAYERS = {"vgg13": 8, "vgg16": 11, "resnet44": 16, "resnet56": 22,
              "googlenet": 20, "shufflenet": 12}
#: one paper-grid point per mode (perforated m=2, recursive m=3, truncated
#: m=6; indices into paper_grid_specs): the 100-class sweep and the
#: kernel-vs-plain logits
CNN_POINTS = (1, 4, 7)


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
    """Every module of a parameter tree (dicts and lists of modules and
    tensors)."""
    import torch.nn as nn

    if isinstance(tree, nn.Module):
        yield from tree.modules()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from modules(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
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
    """The card's data-sheet peaks (``repro_torch.launch.roofline.
    CARD_PEAKS``: bytes/s, int8 ops/s, bf16 FLOP/s, float32 FLOP/s)."""
    from repro_torch.launch import roofline

    val = roofline.peaks(name)
    if val is None:
        fail(f"no data-sheet peaks for card {name!r}: add it to "
             "repro_torch.launch.roofline.CARD_PEAKS")
    return val


def approx_bound(mm: int, k: int, n: int, w_qbt_numel: int,
                 epilogue_numel: int, meta_numel: int, x_itemsize: int,
                 out_itemsize: int, card: str, mode: str = "perforated",
                 m: int = 2) -> tuple[float, str]:
    """(least seconds, bound_by) of one fused approx call on ``card``: the
    work formula the dry run counts the kernel with
    (``roofline.approx_matmul_work``), bytes over the memory rate against
    int8 operations over the int8 peak."""
    from repro_torch.launch import roofline

    bw, int8_peak, _, _ = peaks(card)
    nbytes, ops = roofline.approx_matmul_work(
        mm, k, n, w_qbt_numel, epilogue_numel, meta_numel, x_itemsize,
        out_itemsize, mode, m)
    return roofline.bound(nbytes, ops, int8_peak, bw)


# ---------------------------------------------------------------------------
# pack construction at a given shape (random codes, realistic constants)
# ---------------------------------------------------------------------------


def random_pack(torch, k: int, n: int, mode: str, m: int, gen, dev,
                widths=None, bias: bool = False):
    """A blocked pack from random float weights (and per-column biases with
    ``bias``) through the port's own packing path (pack_linear ->
    concat_packs -> build_blocked_layout); ``widths`` are the members' of a
    fused group (one member of n columns by default)."""
    from repro_torch.quant.quantize import (build_blocked_layout,
                                            calibrate_minmax, concat_packs,
                                            pack_linear)

    widths = widths or [n]
    packs = [pack_linear(torch.randn(k, w, generator=gen, device=dev)
                         * k ** -0.5,
                         torch.randn(w, generator=gen, device=dev) * 0.5
                         if bias else None, mode, m) for w in widths]
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
    each entry was compared on every matmul tile the source gives it
    (``approx_matmul.ENTRY_TILES``)."""
    import dataclasses

    from repro_torch.kernels import approx_matmul as amk
    from repro_torch.core import multipliers as am

    from repro_torch.quant.quantize import EPI_BIAS, k_major

    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"approx_matmul_cv_fused": 0.0, "approx_matmul_cv": 0.0}
    tiles = {name: set() for name in errs}

    def equal(name, got, want, mm, k, n, mode, m):
        err = close(torch, got, want)
        if err != 0.0:
            fail(f"{name} {mode} m={m} ({mm}, {k}, {n}): max abs err {err} "
                 "against its plain version, not 0")
        errs[name] = max(errs[name], err)
        tiles[name].add(amk.tile(mm, k, n, mode, m,
                                 codes=name == "approx_matmul_cv"))

    def fused(x, blocked, mode, m, label, use_cv=True):
        """The fused kernel against its plain version; decode rows twice."""
        k, n = blocked.k, blocked.n
        args = (x, blocked.w_qbt, blocked.epilogue, blocked.meta)
        kw = dict(k=k, n=n, mode=mode, m=m, use_cv=use_cv)
        got = amk.approx_matmul_cv_fused(*args, **kw)
        again = (amk.approx_matmul_cv_fused(*args, **kw)
                 if x.shape[0] <= amk.DECODE_M_MAX else got)
        want = amk.approx_matmul_cv_fused_plain(*args, **kw)
        torch.cuda.synchronize()
        if got.dtype != x.dtype or got.shape != (x.shape[0], n):
            fail(f"fused kernel output {got.dtype} {tuple(got.shape)}")
        if not torch.equal(got, again):
            fail(f"fused kernel {label} {mode} m={m} ({x.shape[0]}, {k}, "
                 f"{n}): two calls on the same inputs differ")
        equal("approx_matmul_cv_fused", got, want, x.shape[0], k, n, mode, m)
        return got

    # (M, K, member widths, dtypes, codes-in entry too): decode and
    # engine-chunk rows at every olmo-1b path shape; lock-step prefill calls:
    # olmo-1b's fused q|k|v and down projection (K=8192: the 128 x 256
    # tile), rwkv6-1.6b's key projection; a ragged call whose K (2000) is
    # off the 128-byte K tile and whose M and N are off the row and column
    # tiles; the decode cases; qwen3-4b's packed layers at decode, engine
    # chunk and lock-step prefill rows (K = 2560, 4096, 9728: the split-K
    # cluster rule at 76 rounds of 128) and its decode members; granite-8b's
    # and deepseek-67b's at decode and prefill rows, in bf16 as served; then
    # (a sixth field: per-column biases) qwen2-vl-2b's and hubert-xlarge's
    # packed layers at decode, engine-chunk and prefill rows (prefill rows in
    # bf16, as served), hubert's head (N = 504) on both tiles, and the
    # decode members of both, each with biases where a layer of that shape
    # has them
    both = (torch.bfloat16, torch.float32)

    def widths(k, n):
        return (2048,) * 3 if (k, n) == (2048, 6144) else (n,)

    qwen = {(2560, 6144): QWEN_QKV, (2560, 19456): (9728, 9728)}
    cases = ([(mm, k, widths(k, n), both, True)
              for mm in (4, 128) for k, n in PATH_KN]
             + [(mm, k, widths(k, n), both, True) for mm, k, n in
                [(5, 200, 48), (OLMO_PREFILL_M, 2048, 6144),
                 (OLMO_PREFILL_M, 8192, 2048), (RWKV_PREFILL_M, 7168, 2048),
                 (1000, 2000, 1000)] + DECODE_CASES]
             + [(mm, k, qwen.get((k, n), (n,)), both, False)
                for mm in (4, 128, QWEN_PREFILL_M) for k, n in QWEN_KN]
             + [(4, k, (n,), both, False)
                for k, n in sorted(set(QWEN_DECODE_KN))]
             + [(mm, k, ws, (torch.bfloat16,), False)
                for kns in WIDE_KN.values() for k, ws in kns
                for mm in (4, WIDE_PREFILL_M)])
    cases = [case + (False,) for case in cases]
    groups = {(1536, 2048): QWEN2VL_QKV, (1536, 17920): (8960, 8960),
              (1280, 3840): HUBERT_QKV}
    biased = {(1536, 2048), (1536, 1536), (1536, 256), (1280, 5120),
              (5120, 1280)}
    cases += [(mm, k, groups.get((k, n), (n,)),
               both if mm <= 128 else (torch.bfloat16,), False,
               (k, n) in biased)
              for mm in (4, 128, QWEN2VL_PREFILL_M)
              for k, n in QWEN2VL_KN + HUBERT_KN + [HUBERT_HEAD_KN]]
    cases += [(4, k, (n,), both, False, (k, n) in biased)
              for k, n in sorted(set(QWEN2VL_DECODE_KN + HUBERT_DECODE_KN))]
    # deepseek-v2-lite-16b's and moonshot-v1-16b-a3b's new shapes at the
    # engine's thin (split-K) and chunk (tile) rows: q (N = 3072), the
    # shared experts' gate|up (N = 5632) and down (K = 2816), the dense
    # layer's gate|up (N = 21888) and down (K = 10944), the head (N =
    # 102400), and the thin steps' gate and up members
    moe_groups = {(2048, 5632): (2816, 2816), (2048, 21888): (10944, 10944)}
    cases += [(mm, k, moe_groups.get((k, n), (n,)), both, False, False)
              for mm in (4, 128)
              for k, n in sorted(set(DSV2_KN + DSV2_DENSE_KN)
                                 | {DSV2_HEAD_KN})]
    cases += [(4, k, (n,), both, False, False)
              for k, n in ((2048, 2816), (2048, 10944))]
    # hymba-1.5b's: every packed layer at the thin and chunk rows, its new
    # K and N (in_proj N = 6400, out_proj K = 3200) and q|k|v at the
    # lock-step prefill's rows in bf16 as served, the decode members, the
    # head (N = 32001: odd, off every column tile) at decode rows, and the
    # SSM's x_proj (N = 132) and dt_proj (K = 100, biased), which
    # serve-default keeps float
    hymba_groups = {(1600, 2240): HYMBA_QKV, (1600, 11008): (5504, 5504)}
    cases += [(mm, k, hymba_groups.get((k, n), (n,)), both, False,
               (k, n) == (100, 3200))
              for mm in (4, 128)
              for k, n in HYMBA_KN + HYMBA_SSM_FLOAT_KN + [HYMBA_HEAD_KN]]
    cases += [(HYMBA_PREFILL_M, k, hymba_groups.get((k, n), (n,)),
               (torch.bfloat16,), False, False)
              for k, n in ((1600, 2240), (1600, 6400), (3200, 1600))]
    cases += [(4, k, (n,), both, False, False)
              for k, n in sorted(set(HYMBA_DECODE_KN) - set(HYMBA_KN))]
    n_cases = n_twice = n_ragged = 0
    for mode, m in MODES:
        for mm, k, ws, dtypes, codes_in, bias in cases:
            n = sum(ws)
            pack, a_qp, blocked = random_pack(torch, k, n, mode, m, gen, dev,
                                              widths=list(ws), bias=bias)
            for dt in dtypes:
                x = (torch.randn(mm, k, generator=gen, device=dev) * 1.5).to(dt)
                got = fused(x, blocked, mode, m, "path")
                n_cases += 1
                n_twice += mm <= amk.DECODE_M_MAX
                if len(ws) == 3 and mm <= amk.DECODE_M_MAX:
                    # a fused group's member (k of q|k|v) over its rows of
                    # the group's K-major codes, as packs serve it: equal to
                    # its plain version and to the group call's columns
                    lo, hi = ws[0], ws[0] + ws[1]
                    member = dataclasses.replace(
                        blocked, n=ws[1], w_qbt=blocked.w_qbt[lo:hi],
                        epilogue=blocked.epilogue[:, lo:hi].contiguous())
                    got_m = fused(x, member, mode, m, "member")
                    if not torch.equal(got_m, got[:, lo:hi]):
                        fail(f"member slice {mode} m={m} ({mm}, {k}, {n}): "
                             "differs from the group call's columns")
                    n_cases += 1
                    n_twice += 1
            if codes_in:
                # codes-in kernel on the same pack (per-tensor quant params
                # are exact for an unfused pack; use the first member's for
                # fused)
                a_q = torch.randint(0, 256, (mm, k), generator=gen,
                                    device=dev, dtype=torch.uint8)
                meta = torch.tensor([0.015, 0.02, 7.0, 131.0], device=dev)
                bias = torch.randn(n, generator=gen, device=dev)
                args = (a_q, pack.w_q, pack.c, pack.c0, pack.sum_qw, bias,
                        meta)
                kw = dict(mode=mode, m=m, true_k=float(k))
                got = amk.approx_matmul_cv(*args, **kw)
                want = amk.approx_matmul_cv_plain(*args, **kw)
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
                torch.tensor([1.0, 1.0, 0.0, 0.0], device=dev),
                mode=mode, m=m, use_cv=False, true_k=float(k))
            torch.cuda.synchronize()
            for name, got in (("approx_matmul_cv_fused", got1),
                              ("approx_matmul_cv", got2)):
                if not torch.equal(got, want):
                    fail(f"{name} accumulator not exact for {mode} m={m}"
                         f" M={mm}: max diff {float((got - want).abs().max())}")
                tiles[name].add(amk.tile(mm, k, n, mode, m,
                                         codes=name == "approx_matmul_cv"))
            n_cases += 2
        # the codes-in entry on ragged operands, as the op calls it (meta
        # [sa, sw, za, zw], the fan-in by value), CV on and off: K = 27 (off
        # 16 bytes; conv-shaped above 8 rows), K = 2000 at odd N (the weight
        # rows off 16 bytes: byte-by-byte copies; every rows tile's edges),
        # hymba-1.5b's head (N = 32,001) at decode rows, and row counts just
        # past the decode window (9) and past a hundred row tiles (4,001)
        for mm, k, n in CODES_RAGGED:
            a_q = torch.randint(0, 256, (mm, k), generator=gen, device=dev,
                                dtype=torch.uint8)
            w_q = torch.randint(0, 256, (k, n), generator=gen, device=dev,
                                dtype=torch.uint8)
            c = torch.randn(n, generator=gen, device=dev) * 30
            c0 = torch.randn(n, generator=gen, device=dev)
            sqw = w_q.to(torch.int32).sum(0, dtype=torch.int32)
            bias = torch.randn(n, generator=gen, device=dev)
            meta4 = torch.tensor([0.015, 0.02, 7.0, 131.0], device=dev)
            for use_cv in (True, False):
                args = (a_q, w_q, c, c0, sqw, bias, meta4)
                kw = dict(mode=mode, m=m, use_cv=use_cv, true_k=float(k))
                got = amk.approx_matmul_cv(*args, **kw)
                want = amk.approx_matmul_cv_plain(*args, **kw)
                torch.cuda.synchronize()
                equal("approx_matmul_cv", got, want, mm, k, n, mode, m)
                n_cases += 1
                n_ragged += 1
            del a_q, w_q
    # a fused q|k|v pack with per-column biases (qkv_bias) at qwen3-4b's
    # widths: the bias row of the epilogue on the split-K kernel (M=4) and
    # the prefill tile (M=128); the bias must move the output
    _, _, blocked = random_pack(torch, 2560, 6144, "perforated", 2, gen, dev,
                                widths=list(QWEN_QKV), bias=True)
    nobias = dataclasses.replace(blocked, epilogue=blocked.epilogue.clone())
    nobias.epilogue[EPI_BIAS] = 0.0
    for mm in (4, 128):
        for dt in (torch.bfloat16, torch.float32):
            x = (torch.randn(mm, 2560, generator=gen, device=dev) * 1.5).to(dt)
            got = fused(x, blocked, "perforated", 2, "bias")
            if torch.equal(got, fused(x, nobias, "perforated", 2, "bias")):
                fail(f"bias pack M={mm}: the bias row did not reach the "
                     "output")
            n_cases += 2
            n_twice += 2 * (mm <= amk.DECODE_M_MAX)
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
    # the CNN suite's convs (im2col) and heads, float32 in and out as the
    # CNN phase runs them, every mode with the CV on and off, at every row
    # count of CONV_M, and one shape in bfloat16: fan-ins off multiples of
    # 8 (27, 100), widths below one 8-column mma tile (4); every call above
    # DECODE_M_MAX rows must take the conv kernel where the source's rule
    # sends it there (all but vgg's two widest (K, N)), and a wgmma tile
    # elsewhere
    conv_kn = cnn_kn(torch, dev)
    n_conv = 0

    def conv_case(x, blocked, mode, m, use_cv):
        fused(x, blocked, mode, m, "conv", use_cv)
        mm, k, n = x.shape[0], blocked.k, blocked.n
        want = ({"split_k"} if mm <= amk.DECODE_M_MAX else
                {"conv"} if not amk._takes_prep(mm, k, n) else
                set(amk.ENTRY_TILES["approx_matmul_cv_fused"])
                - {"split_k", "conv"})
        if amk.tile(mm, k, n, mode, m) not in want:
            fail(f"conv shape ({mm}, {k}, {n}) {mode} m={m} took "
                 f"{amk.tile(mm, k, n, mode, m)}, not {sorted(want)}")

    for mode, m in MODES:
        cvs = (True, False) if mode != "exact" else (True,)
        for k, n in conv_kn:
            _, _, blocked = random_pack(torch, k, n, mode, m, gen, dev)
            for mm in CONV_M:
                x = torch.randn(mm, k, generator=gen, device=dev) * 1.5
                for use_cv in cvs:
                    conv_case(x, blocked, mode, m, use_cv)
                    n_conv += 1
                    n_twice += mm <= amk.DECODE_M_MAX
                if (mm, k, n) == CONV_BF16_CASE:
                    for use_cv in cvs:
                        conv_case(x.to(torch.bfloat16), blocked, mode, m,
                                  use_cv)
                        n_conv += 1
                del x
            del blocked
    n_cases += n_conv
    routes = {f"{k}x{n}": sorted({amk.tile(mm, k, n, "perforated", 2)
                                   for mm in CONV_M})
              for k, n in conv_kn}
    print(f"kernels: {n_conv} conv-shape cases (float32, (K, N) "
          f"{conv_kn}, M {CONV_M}; bfloat16 at {CONV_BF16_CASE}) equal "
          f"their plain versions; routes by (K, N) over M {CONV_M}: "
          + json.dumps(routes), flush=True)
    for name, seen in tiles.items():
        if set(amk.ENTRY_TILES[name]) - seen:
            fail(f"{name}: tiles {sorted(set(amk.ENTRY_TILES[name]) - seen)} "
                 "were never compared with the plain version")
    print(f"kernels: {n_cases} approx-matmul cases equal their plain "
          f"versions (max abs err 0) on every tile of each entry "
          f"{json.dumps(amk.ENTRY_TILES)}; {n_twice} decode-row cases called "
          f"twice, bit-equal; {n_ragged} ragged codes-in cases (M, K, N) "
          f"{CODES_RAGGED} every mode, CV on and off", flush=True)
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
#: (B, Hq, Hkv, Tq, Tk, D, causal, window, dtype): the olmo-1b and
#: qwen3-4b (GQA group 4) prefill shapes, the JAX kernel tests' cases
#: (tests/test_kernels.py) in float32 (3xTF32 route) and their GQA,
#: window, non-causal and Tq < Tk cases in bfloat16 at D=64, 80 and 128
#: (tensor-core route), a ragged T; qwen2-vl-2b's prefill (GQA group 6)
#: and hubert-xlarge's encoder (D=80, non-causal) in both types, and a
#: ragged T at D=80; hymba-1.5b's prefill (GQA group 5, window 1024) and
#: group 5 with a window in float32 at a ragged T; the quickstart
#: example's float32 forwards (olmo-1b at full width, olmo-1b-reduced at
#: D=16, GQA 2:1, T=32: one partial query and key tile), and D=16 in
#: bfloat16 (GQA, window, Tq < Tk) and at a ragged T in float32; in
#: float32 at D=16 and 128, Tq > Tk (the first Tq - Tk rows see no key)
#: and a window with Tq > Tk (rows with no key, then rows that see fewer
#: keys than the window), both ragged; a long non-causal key axis (Tk =
#: 4096, where sums over the whole axis in one tensor-core accumulator
#: lose the tolerance)
QWEN_FLASH = (4, 32, 8, 1024, 1024, 128, True, None, "bfloat16")
QWEN2VL_FLASH = (4, 12, 2, 1024, 1024, 128, True, None, "bfloat16")
HUBERT_FLASH = (4, 16, 16, 1024, 1024, 80, False, None, "bfloat16")
#: hymba-1.5b's lock-step prefill: GQA group 5 at D=64 in window mode
#: (window 1024 of a 2048-token prompt)
HYMBA_FLASH = (4, 25, 5, 2048, 2048, 64, True, 1024, "bfloat16")
#: the quickstart example's prefill attention: olmo-1b and olmo-1b-reduced
#: at float32 on (4, 32) tokens
QUICKSTART_FLASH = [(4, 16, 16, 32, 32, 128, True, None, "float32"),
                    (4, 4, 2, 32, 32, 16, True, None, "float32")]
FLASH_CASES = [
    (4, 16, 16, 1024, 1024, 128, True, None, "bfloat16"),
    QWEN_FLASH,
    (2, 4, 4, 128, 128, 32, True, None, "float32"),
    (2, 8, 2, 128, 128, 32, True, None, "float32"),
    (2, 4, 4, 128, 128, 32, False, None, "float32"),
    (2, 4, 2, 128, 128, 32, True, 64, "float32"),
    (1, 4, 2, 64, 256, 64, True, None, "float32"),
    (4, 16, 16, 1000, 1000, 128, True, None, "bfloat16"),
    QWEN2VL_FLASH, QWEN2VL_FLASH[:-1] + ("float32",),
    HUBERT_FLASH, HUBERT_FLASH[:-1] + ("float32",),
    HYMBA_FLASH, (2, 25, 5, 300, 300, 64, True, 128, "float32"),
    (4, 16, 16, 1000, 1000, 80, False, None, "bfloat16"),
    (4, 16, 16, 1000, 1000, 80, False, None, "float32"),
    *QUICKSTART_FLASH, (2, 4, 2, 100, 100, 16, True, None, "float32"),
] + [case for d in (16, 128) for case in (
    (2, 8, 2, 200, 130, d, True, None, "float32"),
    (2, 4, 2, 150, 90, d, True, 24, "float32"))
] + [(1, 8, 2, 4096, 4096, 64, False, None, "float32")] + [case for d in (16, 64, 80, 128) for case in (
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


def flash_ref64(torch, q, k, v, causal: bool, window) -> "torch.Tensor":
    """Flash attention's function in float64 (the plain version's
    arithmetic, which casts to float32, in double): the yardstick a float32
    call's error is also held to."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    qg = q.double().reshape(b, hkv, hq // hkv, tq, d) * d ** -0.5
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.double())
    qi = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
    ki = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (ki <= qi)
    if window is not None:
        mask = mask & (ki > qi - window)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True).clamp_min(-1e300))
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-300)
    return torch.einsum("bhgqk,bhkd->bhgqd", p, v.double()).reshape(
        b, hq, tq, d)


def rtol_share(got, want, rtol: float) -> float:
    """The largest |got - want| / (rtol (|want| + max |want| of its row)):
    the share of ``close(..., per_row=True)``'s bound a result uses."""
    want = want.double()
    bound = rtol * (want.abs() + want.abs().amax(dim=-1, keepdim=True))
    return float(((got.double() - want).abs() / bound.clamp_min(1e-300))
                 .max())


def check_attention_and_scan(torch, dev) -> dict:
    """Phase 3, second half: flash attention (a float32 call also against
    float64, and two float32 calls on the same inputs bit-equal) and the
    RWKV6 scan against their plain versions on the card."""
    from repro_torch.kernels import flash_attention as fak

    gen = torch.Generator(device=dev).manual_seed(2)
    errs = {"flash_attention": 0.0, "rwkv6_scan": 0.0}
    for b, hq, hkv, tq, tk, d, causal, window, dt in FLASH_CASES:
        dtype = getattr(torch, dt)
        q = torch.randn(b, hq, tq, d, generator=gen, device=dev).to(dtype)
        k = torch.randn(b, hkv, tk, d, generator=gen, device=dev).to(dtype)
        v = torch.randn(b, hkv, tk, d, generator=gen, device=dev).to(dtype)
        got = fak.flash_attention(q, k, v, causal=causal, window=window)
        again = (fak.flash_attention(q, k, v, causal=causal, window=window)
                 if dt == "float32" else got)
        want = fak.flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        if got.dtype != dtype or got.shape != want.shape:
            fail(f"flash output {got.dtype} {tuple(got.shape)}")
        if not torch.equal(got, again):
            fail(f"flash B={b} Hq={hq} Hkv={hkv} Tq={tq} Tk={tk} D={d} {dt}: "
                 "two calls on the same inputs differ")
        err = close(torch, got, want, FLASH_RTOL[dt], per_row=True)
        errs["flash_attention"] = max(errs["flash_attention"], err)
        f64 = ""
        if dt == "float32":
            ref = flash_ref64(torch, q, k, v, causal, window)
            close(torch, got, ref, FLASH_RTOL[dt], per_row=True)
            f64 = (f"; two calls bit-equal; share of the bound against "
                   f"float64: kernel "
                   f"{rtol_share(got, ref, FLASH_RTOL[dt]):.4f}, "
                   f"plain {rtol_share(want, ref, FLASH_RTOL[dt]):.4f}")
            del ref
        print(f"kernels: flash_attention B={b} Hq={hq} Hkv={hkv} Tq={tq} "
              f"Tk={tk} D={d} causal={causal} window={window} {dt}: max abs "
              f"err {err:.3g} (rtol {FLASH_RTOL[dt]:.3g}){f64}", flush=True)
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
    """Phase 7: per-shape times of both kernels, their plain versions, the
    library matmuls the approximate layer stands beside, and the bound
    (perforated m=2 + CV, bf16 activations, as served): decode rows (olmo-1b,
    qwen3-4b and rwkv6-1.6b, head included) and engine chunk rows (olmo-1b,
    qwen3-4b) for both entries, the three lock-step prefills' rows for the
    fused entry and olmo-1b's for the codes-in entry, whose other design
    (CODES_OTHER, kernel only) is timed beside it at olmo-1b's chunk and
    prefill rows, and at one prefill shape each transposing tile (plain
    versions timed at one prefill shape only)."""
    from repro_torch.kernels import approx_matmul as amk
    from repro_torch.launch import roofline
    from repro_torch.quant.quantize import BlockedPack

    bw, int8_peak, _, _ = peaks(card)
    mode, m = "perforated", 2
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    small = sorted({(4, k, n) for k, n in DECODE_KN + PATH_KN + RWKV_KN
                    + [RWKV_HEAD_KN] + QWEN_DECODE_KN + QWEN_KN
                    + QWEN2VL_DECODE_KN + HUBERT_DECODE_KN
                    + [HUBERT_HEAD_KN] + DSV2_DECODE_KN
                    + DSV2_DENSE_DECODE_KN + [DSV2_HEAD_KN]
                    + HYMBA_DECODE_KN + [HYMBA_HEAD_KN]}
                   | {(128, k, n) for k, n in PATH_KN + QWEN_KN + QWEN2VL_KN
                      + DSV2_KN + DSV2_DENSE_KN + [DSV2_HEAD_KN]})
    prefill = sorted({(OLMO_PREFILL_M, k, n) for k, n in PREFILL_KN}
                     | {(RWKV_PREFILL_M, k, n) for k, n in RWKV_KN}
                     | {(QWEN_PREFILL_M, k, n) for k, n in QWEN_KN}
                     | {(QWEN2VL_PREFILL_M, k, n) for k, n in QWEN2VL_KN}
                     | {(HUBERT_M, k, n)
                        for k, n in HUBERT_KN + [HUBERT_HEAD_KN]}
                     | {(HYMBA_PREFILL_M, k, n) for k, n in HYMBA_KN})
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
            bound=approx_bound(mm, k, n, w_bytes, blocked.epilogue.numel(),
                               blocked.meta.numel(), 2, 2, card, mode, m))
        entries = [("approx_matmul_cv_fused", fused)]
        if mm <= 128 or (mm, k, n) in CODES_PREFILL:
            wqs = [pack.w_q] + [pack.w_q.clone() for _ in range(copies - 1)]
            a_q = torch.randint(0, 256, (mm, k), generator=gen, device=dev,
                                dtype=torch.uint8)
            meta4 = torch.tensor([0.015, 0.02, 7.0, 131.0], device=dev)
            bias = torch.zeros(n, device=dev)
            # as the op calls it: the kernel reads each copy's row-major
            # w_q in place, the fan-in by value
            kw = dict(mode=mode, m=m, true_k=float(k))
            bound = roofline.bound(*roofline.approx_codes_work(
                mm, k, n, mode, m), int8_peak, bw)
            entries.append(("approx_matmul_cv", dict(
                kern=[lambda w=w: amk.approx_matmul_cv(
                    a_q, w, pack.c, pack.c0, pack.sum_qw, bias, meta4, **kw)
                    for w in wqs],
                plain=[lambda w=w: amk.approx_matmul_cv_plain(
                    a_q, w, pack.c, pack.c0, pack.sum_qw, bias, meta4, **kw)
                    for w in wqs[:2]],
                bound=bound)))
            # the other design on the same operands at olmo-1b's chunk and
            # prefill rows, and at one prefill shape the transposing tiles
            # that the source's rule passes over (kernel only)
            others = ([CODES_OTHER] if mm > amk.DECODE_M_MAX
                      and (k, n) in PREFILL_KN else [])
            if (mm, k, n) == plain_at:
                others += ["tr_128x128", "tr_64x128"]
            for other in others:
                entries.append((f"approx_matmul_cv/{other}", dict(
                    kern=[lambda w=w, t=other: amk.approx_matmul_cv(
                        a_q, w, pack.c, pack.c0, pack.sum_qw, bias, meta4,
                        tile=t, **kw) for w in wqs],
                    plain=None, bound=bound)))
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
        for name, d in entries:
            timed_plain = d["plain"] is not None and (
                mm <= 128 or (mm, k, n) == plain_at)
            rows.append({
                "kernel": name, "M": mm, "K": k, "N": n,
                "tile": (name.split("/")[1] if "/" in name else
                         amk.tile(mm, k, n, mode, m,
                                  codes=name == "approx_matmul_cv")),
                "kernel_us": time_calls(torch, d["kern"]) * 1e6,
                "plain_us": (time_calls(torch, d["plain"], reps=3) * 1e6
                             if timed_plain else None),
                "library_us": t_lib * 1e6,
                "int8_library_us": None if t_int8 is None else t_int8 * 1e6,
                "bound_us": d["bound"][0] * 1e6, "bound_by": d["bound"][1]})
            print("time " + json.dumps(rows[-1]), flush=True)
        del blks, fused, entries
    return rows


def codes_entry_layers(torch, dev) -> dict:
    """Device us of the codes-in entry on olmo-1b's layers (perforated m=2
    + CV; decode DECODE_KN at M=4, chunk and prefill PREFILL_KN at M=128
    and OLMO_PREFILL_M), called as the checkout's ``approx_matmul_cv``
    takes it: the fan-in by value, or, in a tree from before that, as
    meta[4]; whatever the call does (a copy of w_q included) is timed."""
    import inspect

    from repro_torch.kernels import approx_matmul as amk

    by_value = "true_k" in inspect.signature(amk.approx_matmul_cv).parameters
    gen = torch.Generator(device=dev).manual_seed(2)
    out = {}
    for label, kns, mm in (("decode", DECODE_KN, 4),
                           ("chunk", PREFILL_KN, 128),
                           ("prefill", PREFILL_KN, OLMO_PREFILL_M)):
        total = 0.0
        for k, n in kns:
            copies = max(2, -(-(128 << 20) // (k * n)))
            wqs = [torch.randint(0, 256, (k, n), generator=gen, device=dev,
                                 dtype=torch.uint8) for _ in range(copies)]
            a_q = torch.randint(0, 256, (mm, k), generator=gen, device=dev,
                                dtype=torch.uint8)
            c = torch.randn(n, generator=gen, device=dev) * 30
            c0 = torch.randn(n, generator=gen, device=dev)
            sqw = wqs[0].to(torch.int32).sum(0, dtype=torch.int32)
            bias = torch.zeros(n, device=dev)
            scal = [0.015, 0.02, 7.0, 131.0] + ([] if by_value else [k])
            meta = torch.tensor(scal, dtype=torch.float32, device=dev)
            kw = dict(mode="perforated", m=2)
            if by_value:
                kw["true_k"] = float(k)
            total += time_calls(torch, [
                lambda w=w: amk.approx_matmul_cv(a_q, w, c, c0, sqw, bias,
                                                 meta, **kw) for w in wqs])
            del wqs
        out[label] = total * 1e6
    return out


def compare_trees(kind: str, other: pathlib.Path) -> None:
    """``--compare-codes-entry OTHER`` (kind "codes-entry": the codes-in
    entry's olmo-1b layer times, codes_entry_layers) or
    ``--compare-flash-f32 OTHER`` (kind "flash-f32": flash's float32 route
    at FLASH_F32_TIMED, kernel only) of the checkout at OTHER (an unpacked
    parent commit) and of this one, each in a process of its own that
    builds its tree's source, in the order other, this, this, other."""
    runs = []
    for root in (other, ROOT, ROOT, other):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                            "--tree-times", kind, str(root)],
                           capture_output=True, text=True, timeout=1200)
        lines = [ln for ln in r.stdout.splitlines()
                 if ln.startswith(kind + " ")]
        if r.returncode or not lines:
            print(r.stdout[-3000:] + r.stderr[-3000:], flush=True)
            fail(f"{kind} times of {root} failed ({r.returncode})")
        runs.append(json.loads(lines[-1][len(kind) + 1:]))
        print(f"{lines[-1]} ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"{kind} comparison, us, median of each tree's two runs: "
          + json.dumps({
              str(root): {key: statistics.median(
                  [r["us"][key] for r in runs if r["root"] == str(root)])
                  for key in runs[0]["us"]} for root in (other, ROOT)}),
          flush=True)


def tree_times(kind: str, root: pathlib.Path) -> None:
    """``--tree-times KIND ROOT``: compare_trees' timing with ROOT's port
    (ROOT/src first on the path), one ``KIND`` JSON line."""
    sys.path.insert(0, str(root / "src"))
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    from repro_torch.kernels import approx_matmul as amk
    from repro_torch.kernels import flash_attention as fak

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    mod = amk if kind == "codes-entry" else fak
    t0 = time.perf_counter()
    mod._lib()
    build_s = time.perf_counter() - t0
    if kind == "codes-entry":
        us = codes_entry_layers(torch, dev)
    else:
        gen = torch.Generator(device=dev).manual_seed(3)
        rows = flash_rows(torch, dev, card_line(), FLASH_F32_TIMED, gen,
                          plain=False)
        us = {key: row["kernel_us"] for key, row in rows.items()}
    print(f"{kind} " + json.dumps({
        "root": str(root), "source": str(mod.SOURCE), "card": card_line(),
        "build_s": build_s, "us": us}), flush=True)


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


def pallas_spec(use_cv: bool = True):
    """serve-default, perforated m=2 (+ CV), on the approx kernel."""
    from repro_torch.core.policy import ApproxPolicy
    from repro_torch.numerics import get_preset

    return get_preset("serve-default", policy=ApproxPolicy(
        "perforated", 2, use_cv=use_cv, backend="pallas"))


def dense_calls(cfg, slots: int):
    """Fused-wrapper calls of one (slots, C) engine step: fused q|k|v, o,
    fused gate|up and down a layer above DECODE_M_MAX rows, the seven
    members at or below it; an MLA layer packs q and o only (kv_a and kv_b
    stay float), so 4 calls and 5 members; an MoE layer's packed MLP is its
    shared experts' gate|up and down (the router and the routed expert
    stacks stay float); an untied packed head adds one."""
    from repro_torch.kernels import approx_matmul as amk

    head = 0 if cfg.tie_embeddings else 1
    thin = 5 if cfg.attn == "mla" else 7
    return lambda c: cfg.n_layers * (
        thin if slots * c <= amk.DECODE_M_MAX else 4) + head


def engine_run(torch, label: str, cfg, api, params, ecfg, trace, per_call,
               numerics: str, before=None, draft=None, per_draft=None,
               draft_numerics: str | None = None, deadline=None,
               on_step=None, expire=(), engine_kw=None, per_probe=None,
               compiles: int | None = 2) -> dict:
    """Serves ``trace`` through the port's engine, the wrapper launch
    counts set to 0 just before and read just after (``before(eng)`` runs
    inside that window, ahead of the trace).  Request i is submitted with
    ``deadline_ms=deadline(i)``, and ``on_step(reqs)`` runs after every
    engine step.  Fails unless the requests of ``expire`` finished on their
    deadline and every other one with its token count, all ids in the
    vocabulary, the fused approx
    wrapper launched ``per_call(C)`` times in each (slots, C) step of
    ``params``, ``per_draft(C)`` in each step of ``draft`` (speculative
    decode), ``per_probe(C)`` in each error probe of a (slots, C) step of
    ``params`` and never in a step or probe of another pack (a governor's
    ``int8`` and float rungs, a quarantine's exact pack; no other wrapper
    at all), plus, under a shadow (``engine_kw`` ``shadow_params``, a pack
    of ``params``' structure), ``per_call(C)`` in each of a replay's
    ``ceil(len / C)`` chunk-shaped calls of each of its two packs,
    ``compile_count()`` is ``compiles`` (None: not checked), and every
    parameter and cache tensor is on the card.  ``engine_kw`` goes to the
    engine (governor, injector, shadow ...).  Returns the engine, the
    requests, launches, metrics snapshot, peak bytes, the cache, each
    request's (C, n_valid) per step of ``params``, the probes' (C,
    parameters), the shadow replays' fed lengths, and the steps and wall
    seconds of the serving loop (submissions to the last step,
    synchronised)."""
    from repro_torch.core.approx_linear import iter_tensors
    from repro_torch.serving import ServingEngine

    eng = ServingEngine(cfg, params, ecfg, api=api, numerics=numerics,
                        draft_params=draft, draft_numerics=draft_numerics,
                        **(engine_kw or {}))
    steps, probes, sched = [], [], {}
    dispatch = eng._dispatch

    def logged(p, batch, *rest):
        c = batch.tokens.shape[1]
        steps.append((c, p))
        if p is params:
            for r in batch.rows:
                sched.setdefault(r.rid, []).append(
                    (c, int(batch.n_valid[r.slot])))
        return dispatch(p, batch, *rest)

    eng._dispatch = logged
    if eng._probe is not None:
        probe_run = eng._probe.run

        def probe_logged(p, tokens, *rest, **kw):
            probes.append((tokens.shape[1], p))
            return probe_run(p, tokens, *rest, **kw)

        eng._probe.run = probe_logged
    replays = []
    if eng._shadow is not None:
        shadow_replay = eng._shadow.replay

        def replay_logged(prompt, generated):
            replays.append(len(prompt) + len(generated) - 1)
            return shadow_replay(prompt, generated)

        eng._shadow.replay = replay_logged
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wr = wrappers()
    for w in wr.values():
        w.launches = 0
    pre = before(eng) if before is not None else None
    t_loop = time.perf_counter()
    reqs = [eng.submit(p, g, deadline_ms=deadline(i) if deadline else None)
            for i, (p, g) in enumerate(trace)]
    finished = []
    while not eng.idle:
        finished += eng.step()
        if on_step is not None:
            on_step(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_loop
    launches = {n: w.launches for n, w in wr.items()}
    snap = eng.snapshot()
    peak = torch.cuda.max_memory_allocated()
    reasons = [r.finish_reason for r in reqs]
    want = ["deadline" if i in expire else "length" for i in range(len(trace))]
    if len(finished) != len(trace) or reasons != want or not all(
            r.finished and (i in expire or len(r.generated) == g)
            for i, (r, (_, g)) in enumerate(zip(reqs, trace))) or \
            snap["requests_deadline_expired"] != len(expire):
        fail(f"{label}: finished {len(finished)}/{len(trace)} requests, "
             f"reasons {reasons} (want {want}), "
             f"{snap['requests_deadline_expired']} expired")
    if any(not 0 <= t < cfg.vocab for r in reqs for t in r.generated):
        fail(f"{label}: token id out of the vocabulary")
    expected = {n: 0 for n in wr}
    expected["approx_matmul_cv_fused"] = sum(
        per_call(c) if p is params else
        per_draft(c) if draft is not None and p is draft else 0
        for c, p in steps) + sum(per_probe(c) for c, p in probes
                                 if per_probe is not None and p is params) \
        + sum(2 * math.ceil(n / ecfg.prefill_chunk)
              * per_call(ecfg.prefill_chunk) for n in replays)
    print(f"{label}: steps prefill={snap['prefill_steps']} mixed="
          f"{snap['mixed_steps']} decode={snap['decode_steps']} spec="
          f"{snap['spec_rounds']} (draft calls {snap['draft_calls']}); "
          f"wrapper launches {launches}, the schedule implies {expected} (a "
          "fused call is one CUDA launch at decode rows and at conv "
          "shapes, prep and matmul above)", flush=True)
    if launches != expected:
        fail(f"{label}: launches {launches} != {expected}")
    if compiles is not None and eng.compile_count() != compiles:
        fail(f"{label}: {eng.compile_count()} (parameters, shape) pairs "
             f"dispatched, want {compiles}")
    off = [t.device for t in iter_tensors(params) if t.device.type != "cuda"]
    off += [t.device for t in iter_tensors(eng.pool.cache)
            if t.device.type != "cuda"]
    if off:
        fail(f"{label}: {len(off)} parameter/cache tensors off the card: "
             f"{off[:3]}")
    return {"engine": eng, "reqs": reqs, "launches": launches, "snap": snap,
            "peak": peak, "cache": eng.pool.cache, "sched": sched,
            "before": pre, "probes": probes, "replays": replays,
            "steps": eng._steps, "wall_s": wall}


def replay_dense(torch, api, params, ecfg, prompt, calls) -> list[int]:
    """A sequential decode of one request: alone in slot 0 of a fresh
    pooled cache (the other slots idle), its prompt and then its own
    greedy tokens fed back, each call at the (slots, C) shape and n_valid
    the engine gave that request.  The float operations around the kernels
    (bf16 GEMMs of the attention and the tied head) pick their algorithm by
    shape, so matched shapes make the comparison exact: it shows that a
    request's tokens depend on neither its slot nor the other requests."""
    from repro_torch.launch.serve import _CACHE_DTYPES

    cache = api.init_slot_cache(ecfg.slots, ecfg.max_len,
                                _CACHE_DTYPES[ecfg.cache_dtype])
    fed, out = 0, []
    for c, n in calls:
        toks = torch.zeros(ecfg.slots, c, dtype=torch.long, device=api.device)
        if fed < len(prompt):
            row = prompt[fed:fed + n]
            fed += n
            emit = fed == len(prompt)
        else:
            row, emit = [out[-1]], True
        toks[0, :n] = torch.tensor(row)
        logits = api.decode_slots(params, toks, cache,
                                  [n] + [0] * (ecfg.slots - 1))[0]
        if emit:
            out.append(int(logits[0, n - 1].argmax()))
    return out


def check_sequential(label: str, run: dict, trace, replay,
                     what: str = "a sequential decode") -> None:
    """Engine tokens equal ``replay(prompt, gen, calls)`` for every
    request."""
    t0 = time.perf_counter()
    for r, (prompt, gen) in zip(run["reqs"], trace):
        want = replay(prompt, gen, run["sched"][r.rid])
        if r.generated != want:
            fail(f"{label}: request {r.rid} engine tokens {r.generated} != "
                 f"{what}'s {want}")
    print(f"{label}: engine tokens equal {what} of every request on the "
          f"same packs ({time.perf_counter() - t0:.1f} s)", flush=True)


def cache_gib(cache: dict) -> float:
    return sum(t.numel() * t.element_size() for t in cache.values()) / 2**30


def kernel_vs_plain(torch, label, api, packed, ecfg, toks) -> torch.Tensor:
    """Determinism and the kernel path against the plain path: one
    chunk-shaped call on a fresh cache twice (bit-equal, finite float32
    logits of the right shape), then the chunk-shaped and a thin call with
    the approx wrapper swapped for its plain version (every other operation
    is the same deterministic GPU code), equal to the kernel path's.
    Returns the chunk call's logits."""
    from repro_torch.kernels import approx_matmul as amk
    from repro_torch.launch.serve import _CACHE_DTYPES

    dt = _CACHE_DTYPES[ecfg.cache_dtype]
    nv = [toks.shape[1]] * ecfg.slots

    def logits(t, n):
        cache = api.init_slot_cache(ecfg.slots, ecfg.max_len, dt)
        return api.decode_slots(packed, t, cache, n)[0]

    l1, l2 = logits(toks, nv), logits(toks, nv)
    lk_thin = logits(toks[:, :1], [1] * ecfg.slots)
    torch.cuda.synchronize()
    vocab = api.cfg.vocab
    if l1.shape != (ecfg.slots, toks.shape[1], vocab) \
            or l1.dtype != torch.float32 or not bool(torch.isfinite(l1).all()):
        fail(f"{label}: logits {l1.dtype} {tuple(l1.shape)} not finite f32")
    if not torch.equal(l1, l2):
        fail(f"{label}: two identical calls gave different logits")
    swaps = [(amk, "approx_matmul_cv_fused", amk.approx_matmul_cv_fused_plain)]
    with plain_swapped(label, swaps):
        lp, lp_thin = logits(toks, nv), logits(toks[:, :1], [1] * ecfg.slots)
    torch.cuda.synchronize()
    if not (torch.equal(l1, lp) and torch.equal(lk_thin, lp_thin)):
        fail(f"{label}: kernel path differs from the plain path by "
             f"{float((l1 - lp).abs().max())} (chunk), "
             f"{float((lk_thin - lp_thin).abs().max())} (thin)")
    print(f"{label}: deterministic; full-depth logits through the kernels "
          "equal the plain path's (chunk-shaped and thin calls)", flush=True)
    return l1


def run_main_path(torch, dev, n_layers: int) -> dict:
    """Phase 4: full-width olmo-1b through the port's engine.  Returns the
    launches and what the later olmo-1b phases share: the config, the API,
    the trace, the engine config, the run, the float parameters (the
    governor's float rung) and the packs (``serve-default`` with and
    without the CV on the approx kernel, and the ``int8`` preset's, all
    from one seeded init)."""
    import dataclasses

    from repro_torch.configs import EngineConfig, get_config
    from repro_torch.core.approx_linear import iter_tensors
    from repro_torch.launch.serve import (ServeConfig, build_serving_params,
                                          mixed_trace)
    from repro_torch.models import build_model
    from repro_torch.numerics import get_preset

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
    spec = pallas_spec()
    packed = build_serving_params(params, cfg, ServeConfig(spec=spec), device=dev)
    packed_nocv = build_serving_params(params, cfg,
                                       ServeConfig(spec=pallas_spec(False)),
                                       device=dev)
    verify = build_serving_params(params, cfg,
                                  ServeConfig(spec=get_preset("int8")),
                                  device=dev)
    torch.cuda.synchronize()
    pack_gib = storage_gib(iter_tensors(packed))
    members = check_packs("main", packed)
    print(f"main: init + three packs {time.perf_counter() - t0:.1f} s; "
          f"serving params {pack_gib:.3f} GiB, of which K-major weight codes "
          f"{k_major_gib(packed):.3f} GiB (no row-major copy; {members} "
          "fused-group members read row slices of their group's)", flush=True)

    ecfg = EngineConfig(slots=4, max_len=256, prefill_chunk=32,
                        cache_dtype="bfloat16")
    trace = mixed_trace(cfg, 8, ecfg.max_len, ecfg.prefill_chunk, seed=0)
    warm_up(torch, api, packed, ecfg)
    run = engine_run(torch, "main", cfg, api, packed, ecfg, trace,
                     dense_calls(cfg, ecfg.slots), spec.name)
    check_sequential("main", run, trace, lambda p, g, calls: replay_dense(
        torch, api, packed, ecfg, p, calls))

    # determinism, kernel against plain, and the CV's reach: the no-CV
    # pack's logits differ
    g = torch.Generator(device=dev).manual_seed(5)
    toks = torch.randint(0, cfg.vocab, (ecfg.slots, ecfg.prefill_chunk),
                         generator=g, device=dev)
    l1 = kernel_vs_plain(torch, "main", api, packed, ecfg, toks)
    l3 = api.decode_slots(packed_nocv, toks, api.init_slot_cache(
        ecfg.slots, ecfg.max_len, torch.bfloat16),
        [ecfg.prefill_chunk] * ecfg.slots)[0]
    if torch.equal(l1, l3):
        fail("main: the no-CV pack gave the CV pack's logits")
    print(f"main: CV moves logits by max {float((l1 - l3).abs().max()):.4g}",
          flush=True)

    breakdown = {kind: profile_call(torch, "main", api, packed, ecfg, c)
                 for kind, c in (("thin", 1), ("chunk", ecfg.prefill_chunk))}
    check_one_launch("main: thin step", breakdown["thin"])
    snap = run["snap"]
    write_line("main", "main_path.json", {
        **served_metrics(snap), "peak_mem_gib": run["peak"] / 2**30,
        "pack_gib": pack_gib, "k_major_gib": k_major_gib(packed),
        "cache_gib": cache_gib(run["cache"]),
        "launches": run["launches"], "step_breakdown": breakdown})
    del run["engine"]
    return {"launches": run["launches"], "cfg": cfg, "api": api,
            "trace": trace, "ecfg": ecfg, "run": run, "packed": packed,
            "packed_nocv": packed_nocv, "verify": verify,
            "numerics": spec.name, "float": params}


#: the legacy-pack phase: one (B, T) prefill, then decode steps
LEGACY_PACK_SHAPE, LEGACY_PACK_STEPS = (4, 128), 3


def legacy_packs(tree):
    """The reference's legacy packs: every pack of ``tree`` rebuilt without
    its blocked layout over the same buffers (its row-major ``w_q`` and CV
    constants; no copy, checked), groups with their members rebuilt alike.
    Returns the tree and the number of single packs outside groups and of
    group members."""
    from repro_torch.core.approx_linear import (LayerStack, QuantizedDense,
                                                QuantizedDenseGroup)

    counts = {"single": 0, "member": 0, "group": 0}

    def one(m, kind):
        new = QuantizedDense(m.pack, m.a_qp, m.policy, None)
        if new.w_q is not m.w_q or new.blocked is not None:
            fail("legacy-pack: a rebuilt pack copied its codes or kept its "
                 "blocked layout")
        counts[kind] += 1
        return new

    def walk(node):
        if isinstance(node, QuantizedDenseGroup):
            counts["group"] += 1
            return QuantizedDenseGroup(
                node.pack, node.a_qp, node.policy, None, node.names,
                node.splits, [one(x, "member") for x in node.members])
        if isinstance(node, QuantizedDense):
            return one(node, "single")
        if isinstance(node, LayerStack):
            return LayerStack([walk(x) for x in node.layers])
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(tree), counts


def run_legacy_packs(torch, built: dict) -> dict:
    """Phase 4b: the reference's legacy-pack route (``backend: "pallas"``
    packs without a blocked layout: quantize, then the codes-in kernel) at
    olmo-1b's full width on the main path's packs, rebuilt as views of the
    same codes: one (4, 128) prefill and a few greedy decode steps.  Single
    packs run ``approx_matmul_cv`` (the prefill's o and down, every
    projection of a decode step, whose groups run their members); a
    group's wide prefill call goes where the reference sends it, the exact
    integer ``quantized_linear``.  Fails unless the counted launches equal
    the single packs' calls, the groups' calls equal theirs, the logits
    are finite and bit-equal to a run with the kernel swapped for its plain
    version."""
    from repro_torch.core import approx_linear as al
    from repro_torch.kernels import approx_matmul as amk

    cfg, api, label = built["cfg"], built["api"], "legacy-pack olmo-1b"
    dev = api.device
    t0 = time.perf_counter()
    legacy, counts = legacy_packs(built["packed"])
    (b, t), steps = LEGACY_PACK_SHAPE, LEGACY_PACK_STEPS
    g = torch.Generator(device=dev).manual_seed(11)
    prompt = torch.randint(0, cfg.vocab, (b, t), generator=g, device=dev)

    def run():
        logits, cache = api.prefill(legacy, {"tokens": prompt}, t + steps)
        outs = [logits]
        for _ in range(steps):
            tok = torch.argmax(outs[-1], -1)[:, None]
            logits, cache = api.decode_step(legacy, tok, cache)
            outs.append(logits)
        return torch.stack(outs)

    run()  # warm-up, not counted
    group_calls = [0]
    plain_linear = al.quantized_linear

    def spy(*a, **kw):
        group_calls[0] += 1
        return plain_linear(*a, **kw)

    al.quantized_linear = spy
    try:
        expected = {"approx_matmul_cv": counts["single"] * (1 + steps)
                    + counts["member"] * steps,
                    "flash_attention": cfg.n_layers}
        out, wall, launches, peak = counted_run(
            torch, label, run, expected,
            f"{counts['single']} single packs x {1 + steps} calls + "
            f"{counts['member']} group members x {steps} decode steps")
    finally:
        al.quantized_linear = plain_linear
    if group_calls[0] != counts["group"]:
        fail(f"{label}: {group_calls[0]} quantized_linear calls, want one a "
             f"group at the prefill ({counts['group']})")
    with plain_swapped(label, [(amk, "approx_matmul_cv",
                                amk.approx_matmul_cv_plain)]):
        plain = run()
    torch.cuda.synchronize()
    if tuple(out.shape) != (1 + steps, b, cfg.vocab) \
            or not bool(torch.isfinite(out).all()):
        fail(f"{label}: logits {tuple(out.shape)} not finite")
    if not torch.equal(out, plain):
        fail(f"{label}: kernel run differs from the plain run: max "
             f"{float((out - plain).abs().max())}")
    line = {"arch": cfg.name, "layers": cfg.n_layers, "batch": b,
            "prompt_len": t, "decode_steps": steps, **counts,
            "launches": launches, "quantized_linear_calls": group_calls[0],
            "kernel_equals_plain": True, "wall_s": wall,
            "peak_mem_gib": peak / 2**30,
            "phase_s": time.perf_counter() - t0}
    write_line(label, "legacy_packs_olmo-1b.json", line)
    return launches


#: tokens a KV block of the paged phases, and the speculative draft depth
PAGED_BLOCK, SPEC_K = 16, 4
#: fleet steps between prefix shares (the serve CLI's default)
FLEET_SHARE_EVERY = 4


def run_paged(torch, label: str, cfg, api, packed, ecfg, trace, cont,
              numerics: str) -> dict:
    """The paged layout (blocks of PAGED_BLOCK, prefix cache on, the
    contiguous layout's capacity) on a contiguous phase's packs: first the
    reference's shared-prefix pair (a warm request, then the same prompt
    plus 4 tokens, which attaches to every cached block), then the full
    prompt again (attached one token short, so its re-prefill copies the
    shared last block on write), then the phase's trace.  Fails unless
    every trace request's tokens equal the contiguous run's, the pair's
    second request hits the whole prefix and the repeat all but one token,
    at least one copy on write happened, each of the three requests equals
    a sequential decode of it (alone on the contiguous layout, its cached
    prefix computed in the warm request's chunks, then its own calls), and
    the NULL block is still zero.  Prints the KV bytes in use at peak
    against the contiguous cache's."""
    import dataclasses

    import numpy as np

    pecfg = dataclasses.replace(ecfg, kv_layout="paged",
                                kv_block_size=PAGED_BLOCK)
    rng = np.random.default_rng(17)
    shared = rng.integers(0, cfg.vocab, min(4 * ecfg.prefill_chunk,
                                            ecfg.max_len // 2)).tolist()
    suffix = rng.integers(0, cfg.vocab, 4).tolist()

    def pair(eng):
        out = []
        for prompt, gen in ((shared, 2), (shared + suffix, 4), (shared, 4)):
            out.append(eng.submit(prompt, gen))
            eng.run()
        return out

    run = engine_run(torch, label, cfg, api, packed, pecfg, trace,
                     dense_calls(cfg, ecfg.slots), numerics, before=pair)
    eng, (warm, hit, again) = run["engine"], run["before"]
    for r, c in zip(run["reqs"], cont["reqs"]):
        if r.generated != c.generated:
            fail(f"{label}: request {r.rid} paged tokens {r.generated} != "
                 f"the contiguous run's {c.generated}")
    snap = run["snap"]
    if (hit.prefix_hit_tokens != len(shared)
            or again.prefix_hit_tokens != len(shared) - 1
            or snap["prefix_hits"] != 2 or snap["cow_copies"] < 1):
        fail(f"{label}: prefix hits {hit.prefix_hit_tokens}, "
             f"{again.prefix_hit_tokens} of {len(shared)} shared tokens, "
             f"{snap['prefix_hits']} hits, {snap['cow_copies']} copies on "
             "write")
    warm_calls = run["sched"][warm.rid]

    def prefix_calls(h):
        calls = []
        for c, n in warm_calls:
            if h <= 0:
                break
            calls.append((c, min(n, h)))
            h -= n
        return calls

    for r in (warm, hit, again):
        want = replay_dense(torch, api, packed, ecfg, r.prompt,
                            prefix_calls(r.prefix_hit_tokens)
                            + run["sched"][r.rid])
        if r.generated != want:
            fail(f"{label}: shared-prefix request {r.rid} (hit "
                 f"{r.prefix_hit_tokens}) tokens {r.generated} != a "
                 f"sequential decode's {want}")
    pool = eng.pool
    leaves = [k for k in pool.cache if k != "lengths"]
    if any(bool(pool.cache[k][:, 0].any()) for k in leaves):
        fail(f"{label}: the NULL block was written")
    kv_dtype = pool.cache[leaves[0]].dtype
    peak_gib = snap["peak_blocks_in_use"] * pool.per_block_bytes() / 2**30
    cont_gib = cache_gib(cont["cache"])
    # one thin step on each layout, fresh caches, every slot at the same
    # cursor (the paged one through full block tables)
    toks = torch.zeros(ecfg.slots, 1, dtype=torch.long, device=api.device)
    tables = np.arange(1, 1 + ecfg.slots * pool.blocks_per_slot).reshape(
        ecfg.slots, pool.blocks_per_slot)
    nv = [1] * ecfg.slots

    def paged_step():
        cache = api.init_paged_cache(pool.allocator.num_blocks, PAGED_BLOCK,
                                     ecfg.slots, kv_dtype)
        cache["lengths"].fill_(ecfg.prefill_chunk)
        api.decode_slots(packed, toks, cache, nv, block_tables=tables,
                         kv_len=ecfg.max_len)

    def cont_step():
        cache = api.init_slot_cache(ecfg.slots, ecfg.max_len, kv_dtype)
        cache["lengths"].fill_(ecfg.prefill_chunk)
        api.decode_slots(packed, toks, cache, nv)

    name = label.replace(" ", "_")
    steps = {"paged": profile_fn(torch, f"{label}: profile paged thin step",
                                 paged_step, f"host_profile_{name}.txt"),
             "contiguous": profile_fn(
                 torch, f"{label}: profile contiguous thin step", cont_step,
                 f"host_profile_{name}_contiguous.txt")}
    check_one_launch(f"{label}: paged thin step", steps["paged"])
    line = {**served_metrics(snap), "block_size": PAGED_BLOCK,
            "prefix_hits": snap["prefix_hits"],
            "prefix_hit_tokens": snap["prefix_hit_tokens"],
            "cow_copies": snap["cow_copies"],
            "peak_blocks_in_use": snap["peak_blocks_in_use"],
            "blocks_total": snap["blocks_total"],
            "kv_gib_peak_in_use": peak_gib, "kv_gib_pool": cache_gib(
                pool.cache), "kv_gib_contiguous": cont_gib,
            "mean_block_utilization": snap["mean_block_utilization"],
            "mean_block_fragmentation": snap["mean_block_fragmentation"],
            "peak_mem_gib": run["peak"] / 2**30, "launches": run["launches"],
            "thin_step": steps}
    print(f"{label}: trace tokens equal the contiguous run's; pair hit "
          f"{hit.prefix_hit_tokens}/{len(shared)} shared tokens, repeat "
          f"{again.prefix_hit_tokens} with {snap['cow_copies']} copy on "
          f"write, both equal a sequential decode; NULL block zero; KV in use "
          f"at peak {peak_gib:.4f} GiB ({snap['peak_blocks_in_use']} of "
          f"{snap['blocks_total']} blocks) against the contiguous cache's "
          f"{cont_gib:.4f} GiB", flush=True)
    write_line(label, f"{label.replace(' ', '_')}.json", line)
    return run["launches"]


def run_deadlines(torch, built: dict) -> dict:
    """Request deadlines on the olmo-1b packs, through ``engine_run``: the
    trace with a 0 ms budget on its last three requests (they expire in the
    queue, before any admission) and on request 2 (a long document) once
    its first prompt chunk has run (it stops at its next chunk): 4 requests
    expire, and each of the others equals a sequential decode of it at this
    run's call shapes.  (Against the main run's tokens, whose calls had
    other shapes, the agreement is printed: the bf16 operations around the
    kernels pick their algorithm by shape.)"""
    cfg, api, packed, ecfg = (built[k] for k in ("cfg", "api", "packed",
                                                 "ecfg"))
    trace, main_reqs = built["trace"], built["run"]["reqs"]
    queue_expire, mid = (5, 6, 7), 2

    def expire_mid(reqs):
        r = reqs[mid]
        if r.prefilled and r.deadline_ms is None and not r.finished:
            r.deadline_ms = 0.0

    run = engine_run(torch, "deadlines", cfg, api, packed, ecfg, trace,
                     dense_calls(cfg, ecfg.slots), built["numerics"],
                     deadline=lambda i: 0.0 if i in queue_expire else None,
                     on_step=expire_mid, expire=queue_expire + (mid,))
    reqs = run["reqs"]
    if any(reqs[i].generated or reqs[i].slot is not None
           for i in queue_expire) or \
            not 0 < reqs[mid].prefilled < reqs[mid].prompt_len:
        fail(f"deadlines: queued requests admitted or request {mid} not "
             f"stopped mid-prompt ({reqs[mid].prefilled} of "
             f"{reqs[mid].prompt_len} prompt tokens)")
    survivors = [i for i in range(len(trace))
                 if i not in queue_expire + (mid,)]
    check_sequential("deadlines", {"reqs": [reqs[i] for i in survivors],
                                   "sched": run["sched"]},
                     [trace[i] for i in survivors],
                     lambda prompt, gen, calls: replay_dense(
                         torch, api, packed, ecfg, prompt, calls),
                     "a sequential decode at this run's call shapes")
    same = sum(a == b for i in survivors
               for a, b in zip(reqs[i].generated, main_reqs[i].generated))
    total = sum(len(main_reqs[i].generated) for i in survivors)
    print(f"deadlines: 3 requests expired in the queue (never admitted), "
          f"request {mid} after {reqs[mid].prefilled} of "
          f"{reqs[mid].prompt_len} prompt tokens; requests_deadline_expired "
          f"{run['snap']['requests_deadline_expired']}; {same}/{total} of "
          f"the other requests' tokens equal the main run's", flush=True)
    return run["launches"]


def run_speculative(torch, built: dict) -> dict:
    """Self-verifying speculative decode at full olmo-1b width: the
    ``int8`` preset verifies (the plain float64 integer product), the
    ``serve-default`` pack on the approx kernel drafts, k = SPEC_K.  First
    the non-speculative engine under ``int8`` on the main trace, whose
    tokens must equal a sequential decode at its call shapes; then the
    speculative engine on the contiguous layout, whose tokens must equal a
    sequential exact-int8 decode at the verify call's (slots, chunk)
    shape, then on the paged layout and with the no-CV draft, whose tokens
    must equal the first speculative run's (the kernel launched only in
    draft calls, ``dense_calls`` of a thin step each; the acceptance rate
    with and without the CV).  Every speculative run's tokens must also
    equal the non-speculative run's, whose decode rows ran thin calls: on
    this path the shapes do not move a token (on the ``serve-default``
    packs they can, see ``run_deadlines``).  Profiles one speculative round (SPEC_K thin draft
    calls, one chunk-shaped verify call: every fused call one CUDA launch)
    against a non-speculative ``int8`` thin step.  Returns the launches
    of each run."""
    import dataclasses

    from repro_torch.core.approx_linear import iter_tensors

    cfg, api, ecfg, trace = (built[k] for k in ("cfg", "api", "ecfg",
                                                "trace"))
    verify = built["verify"]
    warm_up(torch, api, verify, ecfg)
    base = engine_run(torch, "int8 olmo-1b", cfg, api, verify, ecfg, trace,
                      lambda c: 0, "int8")
    check_sequential("int8 olmo-1b", base, trace,
                     lambda p, g, calls: replay_dense(torch, api, verify,
                                                      ecfg, p, calls))
    built["int8_tokens"] = [r.generated for r in base["reqs"]]
    out = {"engine int8 olmo-1b": base["launches"]}
    lines = {}
    per_draft = dense_calls(cfg, ecfg.slots)
    first = None
    for label, layout, draft in (
            ("spec olmo-1b", "contiguous", built["packed"]),
            ("spec olmo-1b paged", "paged", built["packed"]),
            ("spec olmo-1b no-cv", "contiguous", built["packed_nocv"])):
        secfg = dataclasses.replace(ecfg, kv_layout=layout,
                                    kv_block_size=PAGED_BLOCK,
                                    speculative_k=SPEC_K)
        run = engine_run(torch, label, cfg, api, verify, secfg, trace,
                         lambda c: 0, "int8", draft=draft,
                         per_draft=per_draft, draft_numerics="serve-default")
        if first is None:
            # the exact model's greedy decode at the verify call's shape:
            # each request alone, its prompt in the engine's chunks, then
            # one token a (slots, chunk) call
            first = run
            for r, (prompt, gen) in zip(run["reqs"], trace):
                calls, fed = [], 0
                for c, n in run["sched"][r.rid]:
                    if fed >= len(prompt):
                        break
                    calls.append((c, n))
                    fed += n
                calls += [(ecfg.prefill_chunk, 1)] * (gen - 1)
                want = replay_dense(torch, api, verify, ecfg, prompt, calls)
                if r.generated != want:
                    fail(f"{label}: request {r.rid} speculative tokens "
                         f"{r.generated} != a sequential exact-int8 decode's "
                         f"{want} at the verify call's shape")
        else:
            for r, f in zip(run["reqs"], first["reqs"]):
                if r.generated != f.generated:
                    fail(f"{label}: request {r.rid} tokens {r.generated} != "
                         f"the contiguous speculative run's {f.generated}")
        same = sum(a == b for r, b_ in zip(run["reqs"], base["reqs"])
                   for a, b in zip(r.generated, b_.generated))
        n_tok = sum(len(b.generated) for b in base["reqs"])
        if same != n_tok:
            fail(f"{label}: {same}/{n_tok} tokens equal the non-speculative "
                 "int8 engine's")
        snap = run["snap"]
        if not snap["drafted_tokens"] or snap["acceptance_rate"] is None:
            fail(f"{label}: nothing drafted")
        lines[label] = {**served_metrics(snap), "k": SPEC_K,
                        "layout": layout,
                        "drafted_tokens": snap["drafted_tokens"],
                        "accepted_draft_tokens": snap["accepted_draft_tokens"],
                        "acceptance_rate": snap["acceptance_rate"],
                        "spec_rounds": snap["spec_rounds"],
                        "draft_calls": snap["draft_calls"],
                        "tokens_equal_int8_engine": f"{same}/{n_tok}",
                        "launches": run["launches"],
                        "peak_mem_gib": run["peak"] / 2**30}
        print(f"{label}: tokens equal a sequential exact-int8 decode at the "
              f"verify shape (and across the speculative runs), and the "
              f"non-speculative int8 engine's ({same}/{n_tok}, its decode "
              f"rows on thin calls); "
              f"acceptance {snap['accepted_draft_tokens']}/"
              f"{snap['drafted_tokens']} = {snap['acceptance_rate']:.4f} over "
              f"{snap['spec_rounds']} rounds ({snap['draft_calls']} draft "
              f"calls); gen tok/s {snap['gen_tok_per_s']:.1f} against the "
              f"int8 engine's {base['snap']['gen_tok_per_s']:.1f}", flush=True)
        out[f"engine {label}"] = run["launches"]

    # one round against one non-speculative int8 thin step, fresh caches
    toks1 = torch.zeros(ecfg.slots, 1, dtype=torch.long, device=api.device)
    toksc = torch.zeros(ecfg.slots, ecfg.prefill_chunk, dtype=torch.long,
                        device=api.device)
    base_len = ecfg.prefill_chunk

    def spec_round():
        cache = api.init_slot_cache(ecfg.slots, ecfg.max_len, torch.bfloat16)
        cache["lengths"].fill_(base_len)
        for _ in range(SPEC_K):
            api.decode_slots(built["packed"], toks1, cache, [1] * ecfg.slots)
        cache["lengths"].fill_(base_len)
        api.decode_slots(verify, toksc, cache, [SPEC_K + 1] * ecfg.slots)

    rnd = profile_fn(torch, "spec olmo-1b: profile one round", spec_round,
                     "host_profile_spec_round.txt")
    check_one_launch("spec olmo-1b: one round's draft calls", rnd)
    thin = profile_call(torch, "int8 olmo-1b", api, verify, ecfg, 1)
    chunk = profile_call(torch, "int8 olmo-1b", api, verify, ecfg,
                         ecfg.prefill_chunk)
    write_line("spec", "speculative_olmo-1b.json", {
        "runs": lines, "int8_engine": {
            **served_metrics(base["snap"]),
            "peak_mem_gib": base["peak"] / 2**30,
            "verify_pack_gib": storage_gib(iter_tensors(verify))},
        "round_profile": rnd, "int8_thin_step": thin,
        "int8_chunk_step": chunk})
    return out


#: the robustness phases (olmo-1b packs of the main path): probes every
#: PROBE_EVERY steps; the governor's config (windows of GOV_WINDOW probes,
#: GOV_RELAX clean windows to relax, probes every GOV_PROBE_EVERY steps),
#: its SLO GOV_SLO_FACTOR times the measured CV logits variance, and the
#: dense noise (sigma GOV_NOISE on every packed layer's probe output, steps
#: [0, GOV_NOISE_STOP)).  Sigma 10 randomises the residual stream, which
#: saturates the logits' error variance at about twice their own variance,
#: well above the SLO; the exact rungs' probes read (near) 0
PROBE_EVERY = 4
GOV_WINDOW, GOV_RELAX, GOV_PROBE_EVERY = 2, 2, 2
GOV_SLO_FACTOR, GOV_NOISE, GOV_NOISE_STOP = 4.0, 10.0, 24
#: requests of the governor's trace (``mixed_trace(seed=0)``): its two
#: escalations and two relaxes take about 40 steps
GOV_REQUESTS = 16
#: the int8 probe's bound, against the CV pack's mean layer variance: an
#: int8 layer at fan-in > 258 runs the exact reference itself, so its only
#: delta is the bf16 rounding of the served output (logits: exactly 0)
INT8_LAYER_RATIO = 1e-2
#: the ``auto`` phase: one CNN of the suite at full width, its budget
AUTO_NET, AUTO_BUDGET = "resnet44", 0.05


def probe_summary(snap: dict) -> dict:
    p = snap["error_probe"]
    return {"runs": p["runs"], "layer_keys": len(p["layers"]),
            "logits_err_mean": p["logits_err_mean"],
            "logits_err_var": p["logits_err_var"],
            "mean_layer_err_var": p["mean_layer_err_var"],
            "max_layer_err_var": p["max_layer_err_var"]}


def run_probe_phase(torch, built: dict) -> tuple[dict, dict]:
    """The error probe (every PROBE_EVERY steps) on the main trace, three
    times: the kernel pack with the CV, without it, and the ``int8`` pack.
    Checks: the CV run's tokens and final KV cache equal the unprobed main
    run's; the probes' kernel launches (``dense_calls`` of a one-row step
    each, through ``engine_run``); the no-CV layer error variances above
    the CV ones (the CV's residual, per layer); ``int8`` at float-ulp
    level.  Then one thin and one chunk-shaped probe profiled by hand (the
    live cache byte-equal after it; the thin probe's 112 approximate dense
    calls one split-K launch each).  Returns the launches by run and the
    summaries."""
    import dataclasses

    from repro_torch.quant.error_probe import ErrorProbe

    cfg, api, ecfg, trace = (built[k] for k in ("cfg", "api", "ecfg",
                                                "trace"))
    pecfg = dataclasses.replace(ecfg, error_probe_every=PROBE_EVERY)
    per_call, per_probe = dense_calls(cfg, ecfg.slots), dense_calls(cfg, 1)
    out, summ = {}, {}
    for label, key, kernel in (("probe olmo-1b", "packed", True),
                               ("probe olmo-1b no-cv", "packed_nocv", True),
                               ("probe olmo-1b int8", "verify", False)):
        run = engine_run(torch, label, cfg, api, built[key], pecfg, trace,
                         per_call if kernel else lambda c: 0,
                         built["numerics"] if kernel else "int8",
                         per_probe=per_probe if kernel else None)
        out[f"engine {label}"] = run["launches"]
        summ[label] = probe_summary(run["snap"])
        shapes = sorted({c for c, _ in run["probes"]})
        print(f"{label}: {json.dumps(summ[label])}; probed step shapes C="
              f"{shapes}", flush=True)
        if key == "packed":
            main = built["run"]
            if [r.generated for r in run["reqs"]] != \
                    [r.generated for r in main["reqs"]]:
                fail(f"{label}: tokens differ from the unprobed main run's")
            for k, v in main["cache"].items():
                if not torch.equal(run["cache"][k], v):
                    fail(f"{label}: final KV cache leaf {k} differs from the "
                         "unprobed main run's")
            print(f"{label}: tokens and the final KV cache equal the "
                  "unprobed main run's", flush=True)
            cv_layers = run["snap"]["error_probe"]["layers"]
        elif key == "packed_nocv":
            nocv_layers = run["snap"]["error_probe"]["layers"]
        del run
    cv, nocv, i8 = (summ[k] for k in ("probe olmo-1b", "probe olmo-1b no-cv",
                                      "probe olmo-1b int8"))
    above = sum(nocv_layers[k]["err_var"] > cv_layers[k]["err_var"]
                for k in cv_layers)
    if not (nocv["mean_layer_err_var"] > cv["mean_layer_err_var"]
            and nocv["max_layer_err_var"] > cv["max_layer_err_var"]):
        fail(f"probe: no-CV layer variances (mean {nocv['mean_layer_err_var']}"
             f", max {nocv['max_layer_err_var']}) not above the CV's "
             f"({cv['mean_layer_err_var']}, {cv['max_layer_err_var']})")
    if i8["logits_err_var"] != 0.0 or i8["mean_layer_err_var"] >= \
            INT8_LAYER_RATIO * cv["mean_layer_err_var"]:
        fail(f"probe int8: logits variance {i8['logits_err_var']} (want 0) "
             f"or mean layer variance {i8['mean_layer_err_var']} not under "
             f"{INT8_LAYER_RATIO} x the CV's {cv['mean_layer_err_var']}")
    print(f"probe: layer error variance without the CV over with it: mean "
          f"{nocv['mean_layer_err_var'] / cv['mean_layer_err_var']:.1f}x, "
          f"max {nocv['max_layer_err_var'] / cv['max_layer_err_var']:.1f}x, "
          f"{above}/{len(cv_layers)} layer keys above; logits {nocv['logits_err_var']:.4g} "
          f"without, {cv['logits_err_var']:.4g} with; int8 logits variance 0, "
          f"mean layer {i8['mean_layer_err_var']:.3g} (< {INT8_LAYER_RATIO} "
          "x the CV's)", flush=True)

    # one probe by hand at each shape: row 0 of a (slots, C) step whose
    # pre-step cursor is a quarter of max_len, on a random live cache
    probe = ErrorProbe(api)
    prof = {}
    base = ecfg.max_len // 4
    for kind, c in (("thin", 1), ("chunk", ecfg.prefill_chunk)):
        cache = api.init_slot_cache(ecfg.slots, ecfg.max_len, torch.bfloat16)
        cache["k"].normal_()
        cache["v"].normal_()
        cache["lengths"].fill_(base + c)
        toks = torch.zeros(ecfg.slots, c, dtype=torch.long).numpy()
        nv = [c] + [0] * (ecfg.slots - 1)
        lengths = [base] * ecfg.slots
        before = {k: v.clone() for k, v in cache.items()}

        def call():
            probe.run(built["packed"], toks, nv, cache, lengths)

        prof[kind] = profile_fn(torch, f"probe olmo-1b: one {kind} probe",
                                call, f"host_profile_probe_{kind}.txt")
        for k, v in before.items():
            if not torch.equal(cache[k], v):
                fail(f"probe olmo-1b: a {kind} probe wrote the live cache "
                     f"leaf {k}")
        if prof[kind]["fused_calls"] != 3 * per_probe(c):
            fail(f"probe olmo-1b: a {kind} probe made "
                 f"{prof[kind]['fused_calls'] / 3} approx calls, want "
                 f"{per_probe(c)}")
        del cache, before
    check_one_launch("probe olmo-1b: thin probes", prof["thin"])
    # what serving pays for the probe's plumbing on the host: one
    # thread-local lookup a dense call and one layer scope a layer
    from repro_torch.quant import error_probe, observers

    calls = per_call(1)
    t0 = time.perf_counter()
    for _ in range(1000):
        for _ in range(calls):
            error_probe.active()
        for i in range(cfg.n_layers):
            with observers.scope("blocks", i):
                pass
    prof["hooks_us_per_thin_step"] = (time.perf_counter() - t0) / 1000 * 1e6
    print(f"probe olmo-1b: the hooks' lookups ({calls}) and layer scopes "
          f"({cfg.n_layers}) of a thin step: "
          f"{prof['hooks_us_per_thin_step']:.2f} us of host time", flush=True)
    print(f"probe olmo-1b: the live cache byte-equal after a thin and a "
          f"chunk probe; a thin probe {prof['thin']['wall_ms']:.2f} ms wall, "
          f"{prof['thin']['device_ms']:.3f} ms device; a chunk probe "
          f"{prof['chunk']['wall_ms']:.2f} / {prof['chunk']['device_ms']:.3f}"
          " ms", flush=True)
    write_line("probe", "probe_olmo-1b.json", {
        "every": PROBE_EVERY, "runs": summ,
        "layers_nocv_above_cv": f"{above}/{len(cv_layers)}",
        "profile": prof})
    return out, summ


def run_faults(torch, built: dict) -> dict:
    """Fault injection and quarantine replay.  ``nan@3`` with detection on
    the ``int8`` pack, contiguous and paged: tokens equal the clean
    ``int8`` engine's, injected = detected = replays = the injector's log,
    the same log on both layouts.  ``spike@5`` on the kernel pack, replays
    on the ``int8`` pack: every token in the vocabulary, detected >=
    injected.  One replay (an ``int8`` (slots, 1) call with one valid row)
    profiled.  Returns the launches by run."""
    import dataclasses

    from repro_torch.quant.faults import FaultInjector, FaultSpec

    cfg, api, ecfg, trace = (built[k] for k in ("cfg", "api", "ecfg",
                                                "trace"))
    out, logs = {}, {}
    for layout in ("contiguous", "paged"):
        label = f"faults olmo-1b nan@3 {layout}"
        fecfg = dataclasses.replace(ecfg, kv_layout=layout,
                                    kv_block_size=PAGED_BLOCK,
                                    detect_faults=True)
        inj = FaultInjector(FaultSpec.parse("nan@3"))
        run = engine_run(torch, label, cfg, api, built["verify"], fecfg,
                         trace, lambda c: 0, "int8",
                         engine_kw={"fault_injector": inj})
        m = run["snap"]
        toks = [r.generated for r in run["reqs"]]
        if toks != built["int8_tokens"]:
            fail(f"{label}: tokens differ from the clean int8 engine's")
        if not (m["faults_injected"] == m["faults_detected"]
                == m["quarantine_replays"] == len(inj.log) > 0):
            fail(f"{label}: injected {m['faults_injected']}, detected "
                 f"{m['faults_detected']}, replays "
                 f"{m['quarantine_replays']}, log {len(inj.log)}")
        logs[layout] = inj.log
        out[f"engine {label}"] = run["launches"]
        print(f"{label}: injected = detected = replays = "
              f"{m['faults_injected']}; tokens equal the clean int8 "
              f"engine's; quarantine log {run['engine'].quarantine_log[:3]}"
              " ...", flush=True)
        del run
    if logs["contiguous"] != logs["paged"]:
        fail("faults: the injector's log differs between the layouts")
    label = "faults olmo-1b spike@5"
    inj = FaultInjector(FaultSpec.parse("spike@5"))
    run = engine_run(torch, label, cfg, api, built["packed"], ecfg, trace,
                     dense_calls(cfg, ecfg.slots), built["numerics"],
                     engine_kw={"fault_injector": inj,
                                "exact_params": built["verify"]},
                     compiles=None)
    m = run["snap"]
    if not m["faults_detected"] >= m["faults_injected"] > 0:
        fail(f"{label}: detected {m['faults_detected']} < injected "
             f"{m['faults_injected']}")
    out[f"engine {label}"] = run["launches"]
    print(f"{label}: injected {m['faults_injected']}, detected "
          f"{m['faults_detected']}, replays {m['quarantine_replays']} on the "
          f"int8 pack; every token in the vocabulary; "
          f"{run['engine'].compile_count()} (parameters, shape) pairs",
          flush=True)
    del run
    toks = torch.zeros(ecfg.slots, 1, dtype=torch.long, device=api.device)

    def replay():
        cache = api.init_slot_cache(ecfg.slots, ecfg.max_len, torch.bfloat16)
        cache["lengths"].fill_(ecfg.max_len // 4)
        api.decode_slots(built["verify"], toks, cache,
                         [1] + [0] * (ecfg.slots - 1))

    prof = profile_fn(torch, "faults olmo-1b: one replay (int8, slots x 1)",
                      replay, "host_profile_replay.txt")
    write_line("faults", "faults_olmo-1b.json", {
        "log_contiguous": [list(e) for e in logs["contiguous"]],
        "replay_profile": prof})
    return out


def run_governor(torch, built: dict, cv_logits_var: float) -> dict:
    """The accuracy-SLO governor over the ladder serve-default (the kernel
    pack) -> int8 -> float, resolved on the float parameters; its SLO
    GOV_SLO_FACTOR x this run's CV logits variance; dense noise on steps
    [0, GOV_NOISE_STOP).  Checks an escalation inside the noise window and
    a relax after it, ``pack_fn`` called once per rung reached (each
    rung's build timed), the engine's numerics following every decision
    and the launches (the kernel only on the serve-default rung).  Prints
    the decisions in the serve CLI's format and the power attribution.
    Returns the launches."""
    import dataclasses

    from repro_torch.core.approx_linear import iter_tensors
    from repro_torch.launch.serve import (ServeConfig, build_serving_params,
                                          mixed_trace)
    from repro_torch.numerics import resolve_ladder
    from repro_torch.quant.faults import FaultInjector, FaultSpec
    from repro_torch.serving import GovernorConfig, NumericsGovernor

    cfg, api, ecfg = (built[k] for k in ("cfg", "api", "ecfg"))
    ladder = resolve_ladder([pallas_spec(), "int8", "float"], built["float"])
    slo = GOV_SLO_FACTOR * cv_logits_var
    gov = NumericsGovernor(ladder, GovernorConfig(
        slo_err_var=slo, window_probes=GOV_WINDOW,
        clean_windows_to_relax=GOV_RELAX))
    rungs = {}

    def pack_fn(spec):
        t0 = time.perf_counter()
        p = built["float"] if spec is None else build_serving_params(
            built["float"], cfg, ServeConfig(spec=spec), device=api.device)
        torch.cuda.synchronize()
        name = "float" if spec is None else spec.name
        if name in rungs:
            fail(f"governor: pack_fn called twice for rung {name}")
        rungs[name] = {"build_s": time.perf_counter() - t0,
                       "gib": storage_gib(iter_tensors(p))}
        return p

    switches = []

    def watch(eng):
        apply = eng._apply_decision

        def logged(decision):
            apply(decision)
            if decision is not None:
                if eng.numerics != decision.rung_to.name:
                    fail(f"governor: numerics {eng.numerics} after a move "
                         f"to {decision.rung_to.name}")
                switches.append((eng._steps, decision.to_dict()))

        eng._apply_decision = logged

    inj = FaultInjector(FaultSpec(kind="dense-noise", every=1, start=0,
                                  stop=GOV_NOISE_STOP, scale=GOV_NOISE))
    trace = mixed_trace(cfg, GOV_REQUESTS, ecfg.max_len, ecfg.prefill_chunk,
                        seed=0)
    gecfg = dataclasses.replace(ecfg, error_probe_every=GOV_PROBE_EVERY)
    label = "governor olmo-1b"
    run = engine_run(torch, label, cfg, api, built["packed"], gecfg, trace,
                     dense_calls(cfg, ecfg.slots), ladder[0].name,
                     before=watch, per_probe=dense_calls(cfg, 1),
                     compiles=None,
                     engine_kw={"governor": gov, "pack_fn": pack_fn,
                                "fault_injector": inj,
                                "exact_params": built["verify"]})
    eng = run["engine"]
    print(f"{label}: ladder " + " -> ".join(
        f"{r.name} ({r.power_saving_pct}%)" for r in ladder)
        + f"; slo_err_var {slo:.6g} = {GOV_SLO_FACTOR} x the CV logits "
        f"variance; dense-noise@1@0-{GOV_NOISE_STOP} sigma {GOV_NOISE}; "
        f"{eng._steps} steps, {run['snap']['error_probe']['runs']} probes",
        flush=True)
    print(f"  governor: rung={eng.numerics} "
          f"switches={eng.metrics.governor_switches} "
          f"(escalate {eng.metrics.governor_escalations} / "
          f"relax {eng.metrics.governor_relaxes})", flush=True)
    for step, dd in switches:
        print(f"    window {dd['window']}: {dd['action']} "
              f"{dd['from']} -> {dd['to']} [{dd['reason']}] "
              f"err_var={dd['err_var']} "
              f"power_delta={dd['power_delta_pct']}% (step {step})",
              flush=True)
    if not any(d["action"] == "escalate" and step <= GOV_NOISE_STOP
               for step, d in switches) or \
            not any(d["action"] == "relax" and step > GOV_NOISE_STOP
                    for step, d in switches):
        fail(f"{label}: want an escalation inside steps [0, "
             f"{GOV_NOISE_STOP}] and a relax after them: {switches}")
    reached = {d["to"] for _, d in switches} - {ladder[0].name}
    if set(rungs) != reached or eng.numerics != gov.rung.name or \
            [d for _, d in switches] != [d.to_dict() for d in gov.decisions]:
        fail(f"{label}: rungs built {sorted(rungs)}, reached "
             f"{sorted(reached)}, numerics {eng.numerics}")
    if eng.compile_count() > 2 * len(ladder):
        fail(f"{label}: {eng.compile_count()} (parameters, shape) pairs")
    power = run["snap"]["power_attribution"]
    tiers = {k: v["power_saving_pct"] for k, v in power["per_tier"].items()}
    print(f"{label}: rung packs built once each {json.dumps(rungs)}; tokens "
          f"by numerics {json.dumps(power['tokens_by_numerics'])}; modeled "
          f"power saving by tier {json.dumps(tiers)}, overall "
          f"{power['modeled_power_saving_pct']}%; faults injected "
          f"{run['snap']['faults_injected']}", flush=True)
    write_line("governor", "governor_olmo-1b.json", {
        "slo_err_var": slo, "noise": GOV_NOISE, "steps": eng._steps,
        "decisions": [{"step": s, **d} for s, d in switches],
        "rung_packs": rungs, "tokens_by_numerics": power["tokens_by_numerics"],
        "power_saving_by_tier": tiers,
        "modeled_power_saving_pct": power["modeled_power_saving_pct"],
        **served_metrics(run["snap"])})
    return {f"engine {label}": run["launches"]}


#: the observability phase: windows of OBS_WINDOW_S seconds (a run of a few
#: seconds rolls several), the governor's SLOs (whole-logits and per
#: layer) OBS_SLO_FACTOR x the probe phase's CV variances, so that the
#: bookkeeping runs and no rung is switched; the shadow samples every
#: second finished request
OBS_WINDOW_S, OBS_SLO_FACTOR, SHADOW_FRACTION = 0.25, 1000.0, 0.5


def _tools():
    """The repo's trace tools (``tools/``: pure Python, no JAX)."""
    sys.path.insert(0, str(ROOT / "tools"))
    import obs_dashboard
    import trace_report

    return trace_report, obs_dashboard


def run_observability(torch, built: dict, probe_summ: dict) -> dict:
    """Tracing, windowed metrics, OpenMetrics and A/B shadow serving on the
    olmo-1b packs.  A traced run of the main trace (windows of
    OBS_WINDOW_S, the probe every PROBE_EVERY steps, the governor with
    whole-logits and per-layer SLOs it does not breach): every lifecycle
    span, the probe and window kinds, both exports read by
    ``tools/trace_report.py --assert-lifecycle`` and rendered by
    ``tools/obs_dashboard.py``, the OpenMetrics text parsed back to the
    snapshot's numbers, two (parameters, shape) pairs and the main run's
    tokens.  Then the cost of tracing: the main trace untraced, traced,
    traced, untraced (no probe), wall ms per step.  Then the shadow pair
    (the no-CV kernel pack shadows the CV one, every second finished
    request replayed through both: its launches counted) and the control
    (the CV pack shadows itself: logits variance exactly 0; its token
    match is printed, not checked, since the primary's tokens came from
    thin calls and the replay is chunk-shaped), one replay of the pair
    profiled.  Returns the launches by run."""
    import dataclasses

    from repro_torch.numerics import resolve_ladder
    from repro_torch.serving import GovernorConfig, NumericsGovernor
    from repro_torch.serving.prom import (metric_value, parse_openmetrics,
                                          to_openmetrics)
    from repro_torch.serving.telemetry import LIFECYCLE_KINDS

    trace_report, obs_dashboard = _tools()
    cfg, api, ecfg, trace = (built[k] for k in ("cfg", "api", "ecfg",
                                                "trace"))
    per_call = dense_calls(cfg, ecfg.slots)
    main_toks = [r.generated for r in built["run"]["reqs"]]
    out, part_s, t0 = {}, {}, time.perf_counter()

    # -- the traced run --------------------------------------------------
    cv = probe_summ["probe olmo-1b"]
    gov = NumericsGovernor(
        resolve_ladder([pallas_spec(), "int8", "float"], built["float"]),
        GovernorConfig(slo_err_var=OBS_SLO_FACTOR * cv["logits_err_var"],
                       window_probes=GOV_WINDOW,
                       clean_windows_to_relax=GOV_RELAX,
                       layer_slo={"blocks/*": OBS_SLO_FACTOR
                                  * cv["max_layer_err_var"]}))

    def no_switch(spec):
        fail(f"observability: the governor switched to {spec}")

    tecfg = dataclasses.replace(ecfg, trace=True,
                                metrics_window_s=OBS_WINDOW_S,
                                error_probe_every=PROBE_EVERY)
    label = "observability olmo-1b"
    run = engine_run(torch, label, cfg, api, built["packed"], tecfg, trace,
                     per_call, built["numerics"],
                     per_probe=dense_calls(cfg, 1),
                     engine_kw={"governor": gov, "pack_fn": no_switch})
    out[f"engine {label}"] = run["launches"]
    eng, snap = run["engine"], run["snap"]
    if [r.generated for r in run["reqs"]] != main_toks:
        fail(f"{label}: tokens differ from the untraced main run's")
    kinds = {e.kind for e in eng.tracer.events()}
    want = set(LIFECYCLE_KINDS) | {"probe", "metrics_window"}
    series = list(eng.metrics.timeseries)
    if not want <= kinds or len(series) < 2 or \
            not any(s.get("probe_layers") for s in series):
        fail(f"{label}: span kinds {sorted(kinds)} (want {sorted(want)}), "
             f"{len(series)} windows, probe layers in "
             f"{sum(bool(s.get('probe_layers')) for s in series)}")
    odir = ROOT / "chiprun_out"
    odir.mkdir(exist_ok=True)
    paths = [str(odir / "obs_trace.json"), str(odir / "obs_trace.jsonl")]
    for path in paths:
        eng.tracer.write(path)
        if trace_report.main([path, "--assert-lifecycle"]) != 0:
            fail(f"{label}: trace_report rejects {path}")
    if obs_dashboard.main([paths[1], "--out", str(odir / "obs.html"),
                           "--assert-sections", "windows", "heatmap"]) != 0:
        fail(f"{label}: obs_dashboard did not render the windows")
    text = to_openmetrics(snap, labels={"engine": eng.engine_id})
    parsed = parse_openmetrics(text)
    gauges = {k: v for k, v in snap.items()
              if isinstance(v, (int, float)) and v is not None}
    bad = [k for k, v in gauges.items()
           if metric_value(parsed, f"repro_{k}", engine=eng.engine_id)
           != float(v)]
    if bad or metric_value(parsed, "repro_probe_runs") != \
            snap["error_probe"]["runs"]:
        fail(f"{label}: OpenMetrics round trip lost {bad}")
    (odir / "obs.prom").write_text(text)
    print(f"{label}: {len(eng.tracer)} spans ({eng.tracer.dropped} dropped)"
          f" of kinds {sorted(kinds)}; {len(series)} windows of "
          f"{OBS_WINDOW_S} s (gen tok/s "
          f"{[s['gen_tok_per_s'] for s in series]}); trace_report and "
          f"obs_dashboard read both exports; {len(parsed)} OpenMetrics "
          f"series parse back to the snapshot; governor switches "
          f"{snap['governor_switches']}; tokens equal the main run's",
          flush=True)
    traced_run = {"spans": len(eng.tracer), "windows": len(series),
                  "probes": snap["error_probe"]["runs"],
                  "om_series": len(parsed),
                  "ms_per_step": run["wall_s"] / run["steps"] * 1e3}
    del run, eng
    part_s["traced run"], t0 = time.perf_counter() - t0, time.perf_counter()

    # -- what tracing costs: untraced, traced, traced, untraced ----------
    cost = {"untraced": [], "traced": []}
    for traced in (False, True, True, False):
        key = "traced" if traced else "untraced"
        cecfg = dataclasses.replace(ecfg, trace=traced,
                                    metrics_window_s=OBS_WINDOW_S * traced)
        run = engine_run(torch, f"{label} {key}", cfg, api, built["packed"],
                         cecfg, trace, per_call, built["numerics"])
        if [r.generated for r in run["reqs"]] != main_toks:
            fail(f"{label} {key}: tokens differ from the main run's")
        cost[key].append(run["wall_s"] / run["steps"] * 1e3)
        del run
    print(f"{label}: wall ms a step, the main trace without the probe, "
          f"in turns: untraced {cost['untraced']}, traced {cost['traced']}",
          flush=True)
    part_s["cost runs"], t0 = time.perf_counter() - t0, time.perf_counter()

    # -- the shadow pair and the control ---------------------------------
    shadows = {}
    for key, shadow, name in (
            ("pair", built["packed_nocv"], "serve-default no-cv"),
            ("control", built["packed"], built["numerics"])):
        secfg = dataclasses.replace(ecfg, shadow_fraction=SHADOW_FRACTION)
        slabel = f"shadow {key} olmo-1b"
        run = engine_run(torch, slabel, cfg, api, built["packed"], secfg,
                         trace, per_call, built["numerics"],
                         engine_kw={"shadow_params": shadow,
                                    "shadow_numerics": name})
        out[f"engine {slabel}"] = run["launches"]
        eng = run["engine"]
        verdict = eng.shadow_verdict()
        want_replays = len(trace) // round(1 / SHADOW_FRACTION)
        if [r.generated for r in run["reqs"]] != main_toks or \
                verdict is None or \
                verdict["sampled_requests"] != want_replays or \
                len(run["replays"]) != want_replays:
            fail(f"{slabel}: tokens changed or verdict {verdict} (want "
                 f"{want_replays} replays)")
        if key == "control" and verdict["logits_err_var"] != 0.0:
            fail(f"{slabel}: a pack shadowing itself gave logits variance "
                 f"{verdict['logits_err_var']}")
        shadows[key] = {"verdict": verdict, "replays": run["replays"],
                        "launches": run["launches"]}
        if key == "pair":
            # one replay of the longest request profiled, past the counted
            # run (the runner's own method; the verdict is already taken)
            r = max(run["reqs"], key=lambda q: q.prompt_len)
            runner = eng._shadow
            shadows[key]["replay_profile"] = profile_fn(
                torch, f"{slabel}: one replay ({r.prompt_len} + "
                f"{len(r.generated)} tokens, 2 packs)",
                lambda: type(runner).replay(runner, r.prompt, r.generated),
                "host_profile_shadow_replay.txt")
        print(f"{slabel}: {verdict['verdict']}, token match "
              f"{verdict['token_match_rate']} over {verdict['tokens']} "
              f"tokens ({verdict['sampled_requests']} replays, fed lengths "
              f"{run['replays']}), logits_err_var "
              f"{verdict['logits_err_var']:.6g}, power delta "
              f"{verdict['power_delta_pct']}pp [{verdict['reason']}]; "
              "replay launches counted as 2 packs x ceil(len/chunk) x "
              f"{per_call(ecfg.prefill_chunk)} fused calls", flush=True)
        del run, eng
        part_s[f"shadow {key}"], t0 = (time.perf_counter() - t0,
                                       time.perf_counter())
    print(f"{label}: seconds by part {json.dumps(part_s)}", flush=True)
    write_line("observability", "observability_olmo-1b.json", {
        "traced_run": traced_run, "ms_per_step": cost,
        "window_s": OBS_WINDOW_S, "shadow": shadows, "seconds": part_s})
    return out


def _close(a, b) -> bool:
    """Equal, floats to 1e-9 relative (a flat merge and a merge of merges
    associate their float sums differently), dicts key by key."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, float) and isinstance(b, float):
        return math.isclose(a, b, rel_tol=1e-9)
    return a == b


def run_fleet_phase(torch, built: dict) -> dict:
    """The fleet on the olmo-1b packs, paged (blocks of PAGED_BLOCK),
    traced: tiers ``float`` x 1 (exact) and the ``serve-default`` kernel
    pack x 2, spec-aware routing, prefixes shared every 4 fleet steps.
    First a warmed shared-prefix pair whose halves land on the two
    serve-default replicas (the share imports blocks, the second half
    hits them), then the main trace classed (every third request bulk).
    Checks: every imported block bit-equal to the exporter's; the
    sibling's tokens equal a sequential decode of its whole prompt (the
    imported positions at the exporter's call shapes); latency requests
    only on the exact tier; each trace request's
    tokens equal a sequential decode on its tier's pack at the engine's own
    call shapes; the kernel launched ``dense_calls`` in every step of a
    serve-default replica and never on the float one; at most two
    (parameters, shape) pairs a replica; the fleet snapshot equal to
    ``EngineMetrics.merge`` of the replica snapshots (time-derived keys
    aside); one trace file a replica, every event carrying its engine id.
    Returns the launches."""
    import dataclasses

    from repro_torch.launch.serve import mixed_trace
    from repro_torch.serving import EngineMetrics, TierConfig, build_fleet

    cfg, api, ecfg = (built[k] for k in ("cfg", "api", "ecfg"))
    fecfg = dataclasses.replace(ecfg, kv_layout="paged",
                                kv_block_size=PAGED_BLOCK, trace=True)
    packs = {"float": (built["float"], "float", None),
             "serve-default": (built["packed"], built["numerics"],
                               pallas_spec())}
    tiers = [TierConfig("float", "float", 1),
             TierConfig("serve-default", "serve-default", 2)]
    fleet = build_fleet(cfg, built["float"], tiers, fecfg,
                        lambda name: packs[name], api=api,
                        policy="spec-aware")
    label = "fleet olmo-1b"
    steps, sched = [], {}
    for rep in fleet.replicas:
        dispatch = rep.engine._dispatch

        def logged(p, batch, *rest, _d=dispatch, _id=rep.replica_id):
            c = batch.tokens.shape[1]
            steps.append((c, p))
            for r in batch.rows:
                sched.setdefault((_id, r.rid), []).append(
                    (c, int(batch.n_valid[r.slot])))
            return _d(p, batch, *rest)

        rep.engine._dispatch = logged
    per_call = dense_calls(cfg, ecfg.slots)
    wr = wrappers()
    torch.cuda.synchronize()
    for w in wr.values():
        w.launches = 0
    t0 = time.perf_counter()
    # the warmed pair: one serve-default replica prefills, the share
    # carries its blocks, the sibling serves the longer prompt from them
    warm_rep, cold_rep = fleet.replicas[1], fleet.replicas[2]
    rng = torch.Generator().manual_seed(17)
    shared = torch.randint(0, cfg.vocab, (min(4 * ecfg.prefill_chunk,
                                              ecfg.max_len // 2),),
                           generator=rng).tolist()
    warm = warm_rep.engine.submit(shared, 2)
    warm_rep.engine.drain()
    imported = fleet.share_prefixes()
    # every imported block bit-equal to the exporter's, leaf by leaf, in
    # the cache's own dtype (the export went to the host and back)
    src_pool, dst_pool = warm_rep.engine.pool, cold_rep.engine.pool
    src_bids = dict(src_pool.prefix.items())
    checked = 0
    for h, bid in dst_pool.prefix.items():
        for k in dst_pool._block_keys:
            a = dst_pool.cache[k][:, bid].contiguous()
            b = src_pool.cache[k][:, src_bids[h]].contiguous()
            if a.dtype != b.dtype or not torch.equal(a.view(torch.uint8),
                                                     b.view(torch.uint8)):
                fail(f"{label}: imported block {h.hex()[:12]} leaf {k} "
                     f"differs from the exporter's ({a.dtype}, {b.dtype})")
        checked += 1
    if checked != imported:
        fail(f"{label}: the sibling holds {checked} prefix blocks, "
             f"{imported} were imported")
    full = shared + torch.randint(0, cfg.vocab, (4,), generator=rng).tolist()
    hit = cold_rep.engine.submit(full, 4)
    cold_rep.engine.drain()
    shareable = len(shared) // PAGED_BLOCK * PAGED_BLOCK
    shareable = min(shareable, len(shared) - 1)
    if imported <= 0 or hit.prefix_hit_tokens < shareable:
        fail(f"{label}: {imported} blocks imported, the sibling hit "
             f"{hit.prefix_hit_tokens} tokens (want >= {shareable})")
    trace = mixed_trace(cfg, 8, ecfg.max_len, ecfg.prefill_chunk, seed=0)
    placed = [fleet.submit(p, g, klass="bulk" if i % 3 == 2 else "latency")
              for i, (p, g) in enumerate(trace)]
    t1 = time.perf_counter()
    steps0 = fleet.steps
    fleet.drain(share_every=FLEET_SHARE_EVERY)
    fleet_steps = fleet.steps - steps0
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {n: w.launches for n, w in wr.items()}
    expected = {n: 0 for n in wr}
    expected["approx_matmul_cv_fused"] = sum(
        per_call(c) for c, p in steps if p is built["packed"])
    if launches != expected:
        fail(f"{label}: launches {launches} != {expected}")
    # the sibling's tokens against a sequential decode of the full prompt
    # (past the counted run): the imported positions at the exporter's
    # prefill call shapes (the calls that wrote those blocks), then the
    # sibling's own calls
    calls, left = [], hit.prefix_hit_tokens
    for c, n in sched[(warm_rep.replica_id, warm.rid)]:
        if left <= 0:
            break
        calls.append((c, min(n, left)))
        left -= n
    calls += sched[(cold_rep.replica_id, hit.rid)]
    want = replay_dense(torch, api, packs["serve-default"][0], ecfg, full,
                        calls)
    if hit.generated != want:
        fail(f"{label}: the sibling's tokens {hit.generated} from the "
             f"imported blocks != a sequential decode of its prompt {want}")
    by_id = {r.replica_id: r for r in fleet.replicas}
    for r, (prompt, gen) in zip(placed, trace):
        rep = by_id[r.fleet_replica]
        if r.fleet_class == "latency" and not rep.exact:
            fail(f"{label}: latency request on {r.fleet_replica}")
        if not r.finished or len(r.generated) != gen:
            fail(f"{label}: request {r.rid} on {r.fleet_replica} "
                 f"unfinished")
        want = replay_dense(torch, api, packs[rep.tier.name][0], ecfg,
                            prompt, sched[(r.fleet_replica, r.rid)])
        if r.generated != want:
            fail(f"{label}: request {r.rid} on {r.fleet_replica}: tokens "
                 f"{r.generated} != its tier's sequential decode {want}")
    counts = {r.replica_id: r.engine.compile_count() for r in fleet.replicas}
    if max(counts.values()) > 2:
        fail(f"{label}: (parameters, shape) pairs by replica {counts}")
    snaps = [r.engine.snapshot() for r in fleet.replicas]
    snap = fleet.snapshot()
    merged = EngineMetrics.merge(snaps)
    timed = {"elapsed_s", "gen_tok_per_s", "total_tok_per_s"}
    diff = [k for k in merged
            if k not in timed and not _close(merged[k], snap["fleet"][k])]
    if diff or set(merged) != set(snap["fleet"]):
        fail(f"{label}: fleet snapshot differs from the merge of the "
             f"replica snapshots at {diff}")
    odir = ROOT / "chiprun_out" / "fleet_traces"
    files = fleet.write_traces(str(odir))
    for path, rep in zip(files, fleet.replicas):
        with open(path) as f:
            engines = {json.loads(line)["engine"] for line in f}
        if engines != {rep.replica_id}:
            fail(f"{label}: {path} carries engines {engines}")
    if len(files) != len(fleet.replicas):
        fail(f"{label}: {len(files)} trace files for "
             f"{len(fleet.replicas)} replicas")
    tiers_out = {t: {k: s[k] for k in ("engines", "requests_finished",
                                       "generated_tokens", "prefix_hits",
                                       "prefix_imports")}
                 for t, s in snap["tiers"].items()}
    ms_step = (t2 - t1) / fleet_steps * 1e3
    print(f"{label}: placed {[r.fleet_replica for r in placed]}; "
          f"routing {snap['routing']}; tiers {json.dumps(tiers_out)}; "
          f"warm pair: {imported} blocks imported, each bit-equal to the "
          f"exporter's, sibling hit {hit.prefix_hit_tokens} tokens and "
          f"its tokens equal a sequential decode; tokens equal each tier's "
          f"sequential decode; launches {launches}; (parameters, shape) "
          f"pairs {counts}; fleet snapshot = merge of the replica "
          f"snapshots; {len(files)} trace files; {fleet_steps} fleet steps, "
          f"{ms_step:.2f} wall ms a fleet step ({t2 - t0:.1f} s in all)",
          flush=True)
    write_line("fleet", "fleet_olmo-1b.json", {
        "placed": [r.fleet_replica for r in placed],
        "routing": snap["routing"], "tiers": tiers_out,
        "prefix_blocks_imported": imported,
        "sibling_hit_tokens": hit.prefix_hit_tokens,
        "fleet_steps": fleet_steps, "ms_per_fleet_step": ms_step,
        "compile_counts": counts, "launches": launches,
        **served_metrics(snap["fleet"])})
    return {label: launches}


#: the "checkpoint" phase.  The olmo-1b drift count of ``plan --preset
#: int8 --diff-checkpoint`` against a shard saved under pallas_spec()
#: (tests/test_torch_runtime.py::test_plan_diff_checkpoint_gate holds the
#: reference's CLI to it); the train CLI's scale (two runs in one
#: directory: CKPT_CLI_STEPS, then resumed to CKPT_CLI_MORE steps); the
#: resilient loop at that scale with failures injected at
#: CKPT_FAILURES, a checkpoint every CKPT_EVERY steps, against a clean run
OLMO_INT8_DRIFT = 7
CKPT_ARCH = "olmo-1b-reduced"
CKPT_CLI_STEPS, CKPT_CLI_MORE = 20, 40
CKPT_STEPS, CKPT_EVERY, CKPT_FAILURES = 24, 5, (7, 16)
#: full-width olmo-1b training state (float32 params, AdamW m and v), the
#: checkpoint whose save time the phase projects from one leaf's rate
TRAIN_STATE_COPIES = 3


def bits_equal(torch, a, b) -> bool:
    """Same dtype, shape and bytes (``torch.equal`` calls -0.0 == 0.0)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                       b.contiguous().reshape(-1).view(torch.uint8))


def run_checkpoint_phase(torch, built: dict) -> dict:
    """Phase 4b': full-width olmo-1b served from a checkpoint the port
    wrote.  The engine phase's float32 parameters (8 layers, 2.56 GB) are
    saved with ``save_pytree`` (codec "none", the NumericsSpec of their
    packs in the meta), restored onto the card through ``load_pytree``
    with a ``meta`` template and a placement tree (every leaf bit-equal),
    packed again (every pack tensor byte-equal to the engine phase's) and
    served on the main trace through the approx kernel (tokens and
    launches equal to the engine phase's run).  Then ``plan
    --diff-checkpoint`` on the shard (0 under its own spec, SystemExit(7)
    under ``int8``); the train CLI at its own scale, twice in one
    directory (the second run resumes); ``run_resilient`` with two
    injected failures against a clean run (every restore bit-equal to what
    was saved, losses and parameters within the train phase's
    tolerances), the straggler monitor's flags; and ``save_pytree`` /
    ``load_pytree`` MB/s by codec on one 64 MiB leaf, with the projected
    seconds of a full-width training checkpoint under the default codec.
    Returns the serving run's launches."""
    import io
    import shutil
    import tempfile

    from repro_torch.checkpoint import (CheckpointManager, load_pytree,
                                        read_meta, save_pytree)
    from repro_torch.checkpoint.manager import _default_codec, _walk
    from repro_torch.configs import get_config
    from repro_torch.core.approx_linear import iter_tensors
    from repro_torch.data import ShardedLoader, SyntheticLMConfig
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.launch.serve import ServeConfig, build_serving_params
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import (TrainConfig, init_train_state,
                                          main as train_main,
                                          make_train_step)
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import tree_map
    from repro_torch.runtime import (RetryPolicy, StragglerMonitor,
                                     run_resilient)

    label = "checkpoint olmo-1b"
    cfg, api, ecfg, trace = (built[k] for k in ("cfg", "api", "ecfg",
                                                "trace"))
    dev = api.device
    spec = pallas_spec()
    params = built["float"]
    (ROOT / "build").mkdir(exist_ok=True)
    work = tempfile.mkdtemp(prefix="ckpt_", dir=ROOT / "build")
    out: dict = {}
    try:
        # 1. the float checkpoint, saved and restored onto the card
        path = os.path.join(work, "olmo-1b.ckpt")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_pytree(params, path, codec="none",
                    meta={"numerics": spec.to_dict()})
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        n_params = sum(t.numel() for _, t in _walk(params))
        template = tree_map(lambda _, t: t.to("meta"), params)
        placement = tree_map(lambda _, t: dev, params)
        t0 = time.perf_counter()
        restored = load_pytree(template, path, placement)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        bad = [k for (k, a), (_, b) in zip(_walk(params), _walk(restored))
               if not (b.device == a.device and bits_equal(torch, a, b))]
        if bad or len(list(_walk(restored))) != len(list(_walk(params))):
            fail(f"{label}: restored leaves differ from the saved ones: "
                 f"{bad[:4]}")
        meta = read_meta(path)
        if meta != {"codec": "none", "numerics": spec.to_dict()}:
            fail(f"{label}: shard meta {meta}")
        print(f"{label}: {n_params:,} float32 parameters, shard "
              f"{nbytes:,} bytes (codec none); save {save_s:.2f} s "
              f"({nbytes / save_s / 1e6:.0f} MB/s, card to file, fsynced), "
              f"restore {load_s:.2f} s ({nbytes / load_s / 1e6:.0f} MB/s, "
              "file to card, page cache warm); every leaf bit-equal",
              flush=True)
        out.update({"params": n_params, "bytes": nbytes, "save_s": save_s,
                    "restore_s": load_s})

        # 2. packed again, byte-equal, and served through the kernel
        t0 = time.perf_counter()
        packed = build_serving_params(restored, cfg, ServeConfig(spec=spec),
                                      device=dev)
        del restored
        mine, theirs = (list(iter_tensors(p)) for p in (packed,
                                                        built["packed"]))
        if len(mine) != len(theirs) or not all(
                bits_equal(torch, a, b) for a, b in zip(mine, theirs)):
            fail(f"{label}: the restored tree's packs differ from the "
                 "engine phase's")
        check_packs(label, packed)
        pack_s = time.perf_counter() - t0
        run = engine_run(torch, label, cfg, api, packed, ecfg, trace,
                         dense_calls(cfg, ecfg.slots), spec.name)
        got = [r.generated for r in run["reqs"]]
        want = [r.generated for r in built["run"]["reqs"]]
        if got != want or run["launches"] != built["launches"]:
            fail(f"{label}: served {got} with launches {run['launches']}; "
                 f"the engine phase {want} with {built['launches']}")
        print(f"{label}: {len(mine)} pack tensors byte-equal to the engine "
              f"phase's ({pack_s:.1f} s); the main trace's tokens and "
              f"launches {run['launches']} equal the engine phase's run",
              flush=True)
        del run["engine"], packed

        # 3. plan --diff-checkpoint, under the shard's spec and int8
        spec_file = os.path.join(work, "spec.json")
        with open(spec_file, "w") as f:
            f.write(spec.to_json())
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve_main(["plan", "--arch", "olmo-1b", "--spec-json",
                        spec_file, "--diff-checkpoint", path])
        same = buf.getvalue().splitlines()[-1]
        buf = io.StringIO()
        code = 0
        try:
            with contextlib.redirect_stdout(buf):
                serve_main(["plan", "--arch", "olmo-1b", "--preset", "int8",
                            "--diff-checkpoint", path])
        except SystemExit as e:
            code = e.code
        if "no drift" not in same or code != OLMO_INT8_DRIFT:
            fail(f"{label}: plan --diff-checkpoint gave {same!r} under the "
                 f"shard's spec and exit {code} under int8 (want "
                 f"{OLMO_INT8_DRIFT})")
        print(f"{label}: plan --diff-checkpoint: {same}; under int8 "
              f"SystemExit({code})", flush=True)
        os.remove(path)

        # 4. the train CLI on the card at its own scale, then resumed
        cli_dir = os.path.join(work, "cli")
        args = ["--arch", CKPT_ARCH, "--ckpt-dir", cli_dir, "--ckpt-every",
                "10", "--device", dev.type]
        logs = []
        for n in (CKPT_CLI_STEPS, CKPT_CLI_MORE):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                train_main(args + ["--steps", str(n)])
            logs.append((buf.getvalue(), time.perf_counter() - t0))
        first, second = (text for text, _ in logs)
        steps = CheckpointManager(cli_dir).steps()
        if "step     0  loss" not in first or "step     0" in second or \
                f"step    {CKPT_CLI_STEPS}  loss" not in second or \
                steps[-1] != CKPT_CLI_MORE - 1:
            fail(f"{label}: the train CLI did not resume:\n{first}\n{second}")
        for text, secs in logs:
            print(f"{label}: train CLI ({secs:.1f} s): "
                  + " | ".join(text.strip().splitlines()), flush=True)

        # 5. run_resilient with two injected failures against a clean run
        rcfg = get_config(CKPT_ARCH)
        tcfg = TrainConfig(optimizer=AdamWConfig(eps=1e-4), base_lr=1e-3,
                           warmup_steps=0, total_steps=CKPT_STEPS)
        step_fn = make_train_step(rcfg, tcfg, device=dev)
        dcfg = SyntheticLMConfig(vocab=rcfg.vocab, seq_len=128, batch=8)

        class Checked(CheckpointManager):
            """Keeps a host copy of every saved state; every restore must
            give it back bit for bit."""

            def __init__(self, d):
                super().__init__(d)
                self.saved, self.restores = {}, 0

            def save(self, tree, step, blocking=True, numerics=None):
                self.saved[step] = tree_map(
                    lambda _, t: t.to("cpu", copy=True)
                    if isinstance(t, torch.Tensor) else t, tree)
                super().save(tree, step, blocking, numerics)

            def restore(self, template, step=None, placement=None):
                tree, s = super().restore(template, step, placement)
                bad = [k for (k, a), (_, b) in zip(_walk(tree),
                                                   _walk(self.saved[s]))
                       if not (bits_equal(torch, a.cpu(), b)
                               if isinstance(a, torch.Tensor) else a == b)]
                if bad:
                    fail(f"{label}: restore of step {s} differs from the "
                         f"saved state at {bad[:4]}")
                self.restores += 1
                return tree, s

        runs = {}
        for name, failures in (("clean", ()), ("failures", CKPT_FAILURES)):
            mgr = Checked(os.path.join(work, name))
            pending, losses = set(failures), {}
            monitor = StragglerMonitor()

            def wrapped(state, batch, i):
                state, m = step_fn(state, batch)
                losses[i] = float(m["loss"])
                return state

            def hook(i):
                if i in pending:
                    pending.discard(i)
                    raise RuntimeError("injected node failure")

            loader = ShardedLoader(lambda s, sh, ns: lm_batch(dcfg, s, sh,
                                                              ns))
            t0 = time.perf_counter()
            try:
                final = run_resilient(
                    init_state=lambda: init_train_state(rcfg, tcfg, seed=0,
                                                        device=dev),
                    step_fn=wrapped, loader=loader, manager=mgr,
                    total_steps=CKPT_STEPS,
                    policy=RetryPolicy(max_failures=3, backoff_s=0.0,
                                       checkpoint_every=CKPT_EVERY),
                    monitor=monitor, failure_hook=hook)
            finally:
                loader.close()
            runs[name] = {"losses": losses, "final": final,
                          "restores": mgr.restores,
                          "seconds": time.perf_counter() - t0,
                          "flagged": monitor.flagged}
        clean, hurt = runs["clean"], runs["failures"]
        rel = max(abs(hurt["losses"][i] - clean["losses"][i])
                  / abs(clean["losses"][i]) for i in range(CKPT_STEPS))
        worst = max(float((a - b).abs().max()) for (_, a), (_, b) in zip(
            _walk(hurt["final"]["params"]), _walk(clean["final"]["params"])))
        if hurt["restores"] != len(CKPT_FAILURES) or \
                sorted(hurt["losses"]) != list(range(CKPT_STEPS)) or \
                not (rel <= TRAIN_LOSS_RTOL and worst <= TRAIN_PARAM_ATOL):
            fail(f"{label}: the resilient run with failures at "
                 f"{CKPT_FAILURES} left the clean run: {hurt['restores']} "
                 f"restores, loss rel diff {rel:.3g}, params {worst:.3g}")
        print(f"{label}: run_resilient {CKPT_ARCH} B=8 T=128, "
              f"{CKPT_STEPS} steps, a checkpoint every {CKPT_EVERY}: "
              f"failures at {list(CKPT_FAILURES)}, {hurt['restores']} "
              "restores each bit-equal to the saved state; against the "
              f"clean run losses max rel diff {rel:.3g} (rtol "
              f"{TRAIN_LOSS_RTOL}), parameters max abs diff {worst:.3g} "
              f"(atol {TRAIN_PARAM_ATOL}); {clean['seconds']:.1f} / "
              f"{hurt['seconds']:.1f} s; straggler flags (step, s): clean "
              f"{clean['flagged']}, failures {hurt['flagged']}", flush=True)
        out["resilient"] = {k: {"losses": [v["losses"][i]
                                           for i in range(CKPT_STEPS)],
                                "restores": v["restores"],
                                "seconds": v["seconds"],
                                "stragglers": v["flagged"]}
                            for k, v in runs.items()}
        out["resilient"].update({"loss_rel_diff": rel,
                                 "param_max_abs_diff": worst})

        # 6. save / load rate by codec on one full-width leaf
        leaf = params["blocks"]["mlp"]["down"]["w"][0]
        rates, codec = {}, _default_codec()
        for codec in dict.fromkeys(("none", "zlib", codec)):
            p = os.path.join(work, f"leaf_{codec}.ckpt")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save_pytree({"w": leaf}, p, codec=codec)
            t1 = time.perf_counter()
            back = load_pytree({"w": leaf}, p)["w"]
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if not bits_equal(torch, back, leaf):
                fail(f"{label}: the {codec} leaf came back changed")
            mb = leaf.numel() * leaf.element_size() / 1e6
            rates[codec] = {"save_mb_s": mb / (t1 - t0),
                            "load_mb_s": mb / (t2 - t1),
                            "file_ratio": os.path.getsize(p) / (mb * 1e6)}
            os.remove(p)
        codec = _default_codec()  # the manager's, zlib without zstandard
        state_gb = TRAIN_STATE_COPIES * nbytes / 1e9
        projected = state_gb * 1e3 / rates[codec]["save_mb_s"]
        print(f"{label}: one {tuple(leaf.shape)} float32 leaf "
              f"({mb / 1.048576:.0f} MiB): "
              + "; ".join(f"{c} save {r['save_mb_s']:.0f} MB/s, load "
                          f"{r['load_mb_s']:.0f} MB/s, file/raw "
                          f"{r['file_ratio']:.3f}" for c, r in rates.items())
              + f"; a full-width olmo-1b training checkpoint (params, m, v: "
              f"{state_gb:.2f} GB) under the default codec ({codec}) would "
              f"take ~{projected:.0f} s to save", flush=True)
        out.update({"codec_rates": rates, "default_codec": codec,
                    "train_state_gb": state_gb,
                    "projected_train_save_s": projected})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    write_line(label, "checkpoint.json", out)
    return {label: run["launches"]}


def run_auto(torch, dev) -> None:
    """``auto(...)`` at full width: the ``paper-grid`` preset (budget
    AUTO_BUDGET) resolved on AUTO_NET with the CNN phase's 256 calibration
    images as ``calib_inputs`` and ``cnn_apply`` as ``apply_fn``, its
    calibrated ranges; prints each layer's policy, the forwards and
    seconds, the plan's mean modeled power saving and the lowered pack's
    relative logit error on the 1,000 test images beside serve-default's
    uniform perforated m=2 (both ``backend: "jnp"``: no kernel)."""
    from repro_torch.data.vision import VisionConfig, make_vision_dataset
    from repro_torch.nn.cnn import cnn_apply
    from repro_torch.numerics import apply_numerics, get_preset
    from repro_torch.quant.observers import CalibrationRecorder

    cfg, params, _ = cnn_net(torch, dev, AUTO_NET)
    calib, test = (torch.from_numpy(make_vision_dataset(
        VisionConfig(), split, n)[0]).to(dev)
        for split, n in (("train", CNN_CALIB), ("test", CNN_TEST)))
    with CalibrationRecorder() as rec:
        cnn_apply(params, calib, cfg)
    ranges = rec.ranges()
    forwards = [0]

    def apply_fn(p, x):
        forwards[0] += 1
        return cnn_apply(p, x, cfg)

    spec = get_preset("paper-grid", budget=AUTO_BUDGET)
    t0 = time.perf_counter()
    plan = spec.resolve(params, apply_fn=apply_fn, calib_inputs=calib,
                        act_ranges=ranges)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    packed = plan.packed
    if len(packed) != CNN_LAYERS[AUTO_NET] or any(
            e.policy is None or "auto" not in e.rule for e in packed):
        fail(f"auto: {len(packed)} layers lowered, want "
             f"{CNN_LAYERS[AUTO_NET]} concrete policies")
    saving = sum(e.power_saving_pct for e in packed) / len(packed)

    def logits(p):
        y = torch.cat([cnn_apply(p, test[i:i + CNN_BATCH], cfg)
                       for i in range(0, CNN_TEST, CNN_BATCH)])
        if not bool(torch.isfinite(y).all()):
            fail("auto: logits not finite")
        return y

    y_float = logits(params)
    y_auto = logits(apply_numerics(params, plan, act_ranges=ranges))
    sd = get_preset("serve-default")
    y_sd = logits(apply_numerics(params, sd.resolve(params),
                                 act_ranges=ranges))
    errs = {name: float((y - y_float).norm() / y_float.norm())
            for name, y in (("auto", y_auto), ("serve-default", y_sd))}
    policies = {e.path: e.policy.label() for e in packed}
    for path, label in policies.items():
        print(f"auto {AUTO_NET}: {path}: {label}", flush=True)
    print(f"auto {AUTO_NET}: {spec.name} lowered {len(packed)} layers in "
          f"{forwards[0]} forwards (B={CNN_CALIB}), {secs:.1f} s; mean "
          f"modeled power saving {saving:.2f}% (serve-default "
          f"{sd.resolve(params).packed[0].power_saving_pct}%); relative "
          f"logit error on {CNN_TEST} test images {errs['auto']:.5f}, "
          f"serve-default perforated(m=2)+cv {errs['serve-default']:.5f}",
          flush=True)
    write_line("auto", f"auto_{AUTO_NET}.json", {
        "net": AUTO_NET, "budget": AUTO_BUDGET, "forwards": forwards[0],
        "seconds": secs, "policies": policies,
        "mean_power_saving_pct": saving, "rel_err": errs})


def served_metrics(snap: dict) -> dict:
    return {key: snap[key] for key in (
        "requests_finished", "generated_tokens", "prompt_tokens", "elapsed_s",
        "gen_tok_per_s", "total_tok_per_s", "ttft_p50_s", "ttft_max_s",
        "itl_p50_s", "itl_p95_s")}


def write_line(label: str, name: str, line: dict) -> None:
    """Prints a phase's JSON line and keeps it under chiprun_out/."""
    text = json.dumps(line)
    print(f"{label}: " + text, flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / name).write_text(text + "\n")


def warm_up(torch, api, params, ecfg) -> None:
    """One chunk-shaped and one thin call outside the measured run."""
    from repro_torch.launch.serve import _CACHE_DTYPES

    warm = api.init_slot_cache(ecfg.slots, ecfg.max_len,
                               _CACHE_DTYPES[ecfg.cache_dtype])
    for c in (ecfg.prefill_chunk, 1):
        api.decode_slots(params, torch.zeros(ecfg.slots, c, dtype=torch.long,
                                             device=api.device), warm,
                         [c] * ecfg.slots)
    del warm
    torch.cuda.synchronize()


#: depth of the qwen3-4b engine run under the ``int8`` preset (widths
#: full): its packed layers run the plain exact-integer product
#: (``quantized_linear`` -> ``_int_matmul`` in float64), as the reference
#: does at fan-ins above 258, and no kernel
INT8_PRESET_LAYERS = 8
#: depth of the qwen3-4b, rwkv6-1.6b and qwen2-vl-2b engine phases, cut
#: (widths are never cut) to pay for the hybrid and train phases (qwen3-4b
#: 36 -> 12, rwkv6-1.6b 24 -> 8) and then the checkpoint phase (qwen3-4b
#: 12 -> 6, qwen2-vl-2b 28 -> 14); their lock-step paths still run at
#: full depth (36, 24 and 28 layers)
QWEN3_ENGINE_LAYERS, RWKV_ENGINE_LAYERS, QWEN2VL_ENGINE_LAYERS = 6, 8, 14


def run_qwen3_engine(torch, dev) -> dict:
    """Phase 4b: full-width qwen3-4b at QWEN3_ENGINE_LAYERS of its 36
    layers through the engine, with the checks of the olmo-1b phase:
    ``serve-default`` packs on the approx kernel with a bf16 KV cache; the
    same packs with the int8 KV cache; the ``int8`` preset at
    INT8_PRESET_LAYERS layers.  Returns the launches of each run."""
    import dataclasses

    from repro_torch.configs import EngineConfig, get_config
    from repro_torch.core.approx_linear import iter_tensors
    from repro_torch.launch.serve import (ServeConfig, build_serving_params,
                                          mixed_trace)
    from repro_torch.models import build_model
    from repro_torch.numerics import get_preset

    cfg = dataclasses.replace(get_config("qwen3-4b"),
                              n_layers=QWEN3_ENGINE_LAYERS)
    print(f"qwen3: {cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"heads={cfg.n_heads} kv={cfg.kv_heads} head_dim={cfg.head_dim} "
          f"q_dim={cfg.n_heads * cfg.head_dim} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab} qk_norm={cfg.qk_norm} theta={cfg.rope_theta:g} "
          f"tied={cfg.tie_embeddings} compute={cfg.compute_dtype}", flush=True)
    api = build_model(cfg, dev)
    t0 = time.perf_counter()
    params = api.init(0)
    spec = pallas_spec()
    packed = build_serving_params(params, cfg, ServeConfig(spec=spec),
                                  device=dev)
    cfg8 = dataclasses.replace(cfg, n_layers=min(INT8_PRESET_LAYERS,
                                                 cfg.n_layers))
    params8 = {k: v for k, v in params.items() if k != "blocks"}
    params8["blocks"] = _slice_layers(params["blocks"], cfg8.n_layers)
    int8_spec = get_preset("int8")
    packed8 = build_serving_params(params8, cfg8, ServeConfig(spec=int8_spec),
                                   device=dev)
    del params, params8
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    pack_gib = storage_gib(iter_tensors(packed))
    members = check_packs("qwen3", packed)
    print(f"qwen3: init + two packs {time.perf_counter() - t0:.1f} s; "
          f"serving params {pack_gib:.3f} GiB, of which K-major weight codes "
          f"{k_major_gib(packed):.3f} GiB ({members} fused-group members "
          "read row slices of their group's)", flush=True)

    out, bf16_run = {}, None
    for label, ecfg, params, run_cfg, run_api, numerics in (
            ("qwen3", EngineConfig(slots=4, max_len=256, prefill_chunk=32,
                                   cache_dtype="bfloat16"),
             packed, cfg, api, spec.name),
            ("qwen3 int8-cache", EngineConfig(
                slots=4, max_len=256, prefill_chunk=32, cache_dtype="int8"),
             packed, cfg, api, spec.name),
            ("qwen3 int8-preset", EngineConfig(
                slots=4, max_len=256, prefill_chunk=32,
                cache_dtype="bfloat16"),
             packed8, cfg8, build_model(cfg8, dev), int8_spec.name)):
        trace = mixed_trace(run_cfg, 8, ecfg.max_len, ecfg.prefill_chunk,
                            seed=0)
        warm_up(torch, run_api, params, ecfg)
        per_call = (dense_calls(run_cfg, ecfg.slots)
                    if params is packed else lambda c: 0)
        run = engine_run(torch, label, run_cfg, run_api, params, ecfg, trace,
                         per_call, numerics)
        check_sequential(label, run, trace, lambda p, g, calls: replay_dense(
            torch, run_api, params, ecfg, p, calls))
        line = {**served_metrics(run["snap"]), "layers": run_cfg.n_layers,
                "numerics": numerics, "cache_dtype": ecfg.cache_dtype,
                "peak_mem_gib": run["peak"] / 2**30,
                "pack_gib": storage_gib(iter_tensors(params)),
                "cache_gib": cache_gib(run["cache"]),
                "launches": run["launches"]}
        g = torch.Generator(device=dev).manual_seed(5)
        toks = torch.randint(0, run_cfg.vocab,
                             (ecfg.slots, ecfg.prefill_chunk), generator=g,
                             device=dev)
        if label == "qwen3":
            line["k_major_gib"] = k_major_gib(packed)
            kernel_vs_plain(torch, label, run_api, params, ecfg, toks)
            bf16_run = (run, line)
            out["paged qwen3-4b"] = run_paged(
                torch, "paged qwen3-4b", run_cfg, run_api, params, ecfg,
                trace, run, numerics)
        elif label == "qwen3 int8-cache":
            # a different numeric from the bf16 cache: report, not assert
            a = [r.generated for r in bf16_run[0]["reqs"]]
            b = [r.generated for r in run["reqs"]]
            same = sum(x == y for ra, rb in zip(a, b) for x, y in zip(ra, rb))
            first = next((i for i, (ra, rb) in enumerate(zip(a, b))
                          if ra != rb), None)
            line["token_agreement_with_bf16"] = same / sum(map(len, a))
            line["cache_bytes_ratio_to_bf16"] = (
                line["cache_gib"] / bf16_run[1]["cache_gib"])
            print(f"{label}: KV cache {line['cache_gib']:.4f} GiB against "
                  f"bf16's {bf16_run[1]['cache_gib']:.4f} "
                  f"({line['cache_bytes_ratio_to_bf16']:.3f}x); "
                  f"{same}/{sum(map(len, a))} generated tokens equal the bf16 "
                  f"cache run's (first request that differs: {first})",
                  flush=True)
        if label != "qwen3 int8-cache":
            line["step_breakdown"] = {
                kind: profile_call(torch, label, run_api, params, ecfg, c)
                for kind, c in (("thin", 1), ("chunk", ecfg.prefill_chunk))}
            if params is packed:
                check_one_launch(f"{label}: thin step",
                                 line["step_breakdown"]["thin"])
        write_line(label, f"engine_{label.replace(' ', '_')}.json", line)
        out[f"engine {label}"] = run["launches"]
        del run
    return out


def _slice_layers(tree, n: int):
    """The first ``n`` layers of a stacked float block tree."""
    if isinstance(tree, dict):
        return {k: _slice_layers(v, n) for k, v in tree.items()}
    return tree[:n]


def build_packed(torch, dev, arch: str, n_layers: int | None = None):
    """(cfg, api, serve-default packs on the approx kernel) of one arch at
    full width and depth (or ``n_layers``), from the seeded init (freed
    once packed)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import ServeConfig, build_serving_params
    from repro_torch.models import build_model

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    api = build_model(cfg, dev)
    params = api.init(0)
    packed = build_serving_params(params, cfg, ServeConfig(spec=pallas_spec()),
                                  device=dev)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return cfg, api, packed


def run_rwkv_engine(torch, dev) -> dict:
    """Phase 4c: full-width rwkv6-1.6b at RWKV_ENGINE_LAYERS of its 24
    layers through the engine on
    ``serve-default`` packs: the per-slot recurrent state, each chunk as
    single-token steps (no scan), the approx kernel at decode rows only;
    engine tokens equal the lock-step path's greedy tokens (its
    ``decode_step`` over every prompt token, the recurrent form the engine
    serves, on a batch of ``slots`` rows so that every product has the
    engine's shape)."""
    from repro_torch.configs import EngineConfig
    from repro_torch.core.approx_linear import iter_tensors
    from repro_torch.launch.serve import mixed_trace

    cfg, api, packed = build_packed(torch, dev, "rwkv6-1.6b",
                                    RWKV_ENGINE_LAYERS)
    spec = pallas_spec()
    check_packs("rwkv6", packed)
    ecfg = EngineConfig(slots=4, max_len=256, prefill_chunk=32,
                        cache_dtype="bfloat16")
    trace = mixed_trace(cfg, 8, ecfg.max_len, ecfg.prefill_chunk, seed=0)
    print(f"rwkv6: {cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab}; engine slots={ecfg.slots} "
          f"max_len={ecfg.max_len} chunk={ecfg.prefill_chunk}, {len(trace)} "
          "requests", flush=True)
    warm_up(torch, api, packed, ecfg)
    per_token = cfg.n_layers * 8 + 1  # 8 packed layers a block, the head
    run = engine_run(torch, "rwkv6", cfg, api, packed, ecfg, trace,
                     lambda c: c * per_token, spec.name)

    def lock_step(prompt, gen, calls):
        cache = api.init_cache(ecfg.slots, 0, torch.bfloat16)
        tok = torch.zeros(ecfg.slots, 1, dtype=torch.long, device=dev)
        for t in prompt:
            tok[0, 0] = t
            logits = api.decode_step(packed, tok, cache)[0]
        out = [int(logits[0].argmax())]
        for _ in range(gen - 1):
            tok[0, 0] = out[-1]
            out.append(int(api.decode_step(packed, tok, cache)[0][0].argmax()))
        return out

    check_sequential("rwkv6", run, trace, lock_step,
                     "the lock-step path's greedy decode")
    thin = profile_call(torch, "rwkv6", api, packed, ecfg, 1)
    check_one_launch("rwkv6: thin step", thin)
    write_line("rwkv6", "engine_rwkv6.json", {
        **served_metrics(run["snap"]), "peak_mem_gib": run["peak"] / 2**30,
        "pack_gib": storage_gib(iter_tensors(packed)),
        "cache_gib": cache_gib(run["cache"]), "launches": run["launches"],
        "step_breakdown": {"thin": thin}})
    return run["launches"]


#: idle seconds on each side of a profiled window
PROFILE_GAP_S = 0.05


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

    # one warm-up step that the profiler traces and discards, then the
    # three recorded calls between two idle gaps: the window is cut by
    # timestamps, and a kernel at its edge must not fall outside it (the
    # device's and the host's clocks are aligned only approximately; runs
    # without the gaps lost 3 to 10 of a window's first split-K records)
    traced = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traced.append(p.key_averages())
                 ) as prof:
        call()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(PROFILE_GAP_S)
        calls0 = amk.approx_matmul_cv_fused.launches
        kerns0 = amk.kernel_launches()
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        fused_calls = amk.approx_matmul_cv_fused.launches - calls0
        counted = {k: v - kerns0[k] for k, v in amk.kernel_launches().items()
                   if v > kerns0[k]}
        time.sleep(PROFILE_GAP_S)
        prof.step()

    def dev_us(evt):
        return getattr(evt, "self_device_time_total",
                       getattr(evt, "self_cuda_time_total", 0.0))

    # the schedule's "ProfilerStep#" range also appears on the device as
    # an annotation spanning the step: it is not a kernel
    kernels = [e for e in traced[0]
               if e.device_type == DeviceType.CUDA and dev_us(e) > 0
               and not e.key.startswith("ProfilerStep")]
    device_s = sum(dev_us(e) for e in kernels) / 3 / 1e6
    wall_s = statistics.median(walls)
    # kernels by name, instantiations of one template summed (their names
    # agree in the first 48 characters)
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.key[:48]] = by_name.get(e.key[:48], 0.0) + dev_us(e) / 3
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:6]
    # the approx-matmul source's CUDA launches in the profiled calls, by
    # kernel, as the trace shows them and as the source counted them,
    # beside the fused wrapper's calls there
    approx = {}
    for e in kernels:
        for kern in amk.LAUNCH_KINDS:
            if kern in e.key:
                approx[kern] = approx.get(kern, 0) + e.count
    out = {"wall_ms": wall_s * 1e3,
           "device_ms": device_s * 1e3 if kernels else None,
           "device_idle_share": 1 - device_s / wall_s if kernels else None,
           "top_device_us": dict(top),
           "fused_calls": fused_calls, "approx_launches": approx,
           "counted_launches": counted}
    print(f"{label}: " + json.dumps(out), flush=True)
    return out


def check_one_launch(label: str, prof: dict) -> None:
    """A decode step's fused calls (M <= DECODE_M_MAX) are one CUDA launch
    each: the source counted as many split-K launches as fused wrapper
    calls and no other launch (no prep kernel, no prefill tile); the trace,
    which can drop or repeat a record at its window's edge, may show no
    other approx kernel."""
    counted, traced = prof["counted_launches"], prof["approx_launches"]
    want = {"am_splitk_kernel": prof["fused_calls"]}
    if counted != want or set(traced) - {"am_splitk_kernel"}:
        fail(f"{label}: {prof['fused_calls']} fused calls launched {counted} "
             f"(traced {traced}), want one split-K launch each and nothing "
             "else")
    print(f"{label}: {prof['fused_calls']} fused calls, "
          f"{counted['am_splitk_kernel']} CUDA launches (traced {traced}; "
          "split-K only, no prep kernel)", flush=True)


def profile_call(torch, label: str, api, params, ecfg, c: int) -> dict:
    """One (slots, c) engine model step on a fresh cache."""
    from repro_torch.launch.serve import _CACHE_DTYPES

    toks = torch.zeros(ecfg.slots, c, dtype=torch.long, device=api.device)
    dt = _CACHE_DTYPES[ecfg.cache_dtype]

    def call():
        cache = api.init_slot_cache(ecfg.slots, ecfg.max_len, dt)
        api.decode_slots(params, toks, cache, [c] * ecfg.slots)

    name = label.replace(" ", "_")
    return profile_fn(torch, f"{label}: profile (slots, {c}) step", call,
                      f"host_profile_{name}_c{c}.txt")


# ---------------------------------------------------------------------------
# lock-step paths
# ---------------------------------------------------------------------------

BATCH, GEN = 4, 32
#: arch: (prompt length, packed-layer wrapper calls per layer at prefill and
#: at decode, packed head calls per step).  olmo-1b runs its fused q|k|v
#: and gate|up groups at prefill rows and their members at decode rows
#: (M = 4 <= DECODE_M_MAX) and has a tied float head, as has qwen3-4b;
#: rwkv6 has no fusable group and a packed head; hymba-1.5b (its own
#: "hybrid" phase, at full depth: 32 layers) runs q|k|v, o, the SSM's
#: in_proj and out_proj, gate|up and down at prefill rows, the members and
#: the rest at decode rows (x_proj and dt_proj stay float), and a packed
#: head.  Every path runs at full depth.
LEGACY = {"olmo-1b": (1024, 4, 7, 0), "rwkv6-1.6b": (512, 8, 8, 1),
          "qwen3-4b": (1024, 4, 7, 0), "qwen2-vl-2b": (1024, 4, 7, 0),
          "hymba-1.5b": (2048, 6, 9, 1)}
HYMBA = "hymba-1.5b"


def wrappers() -> dict:
    from repro_torch.kernels import approx_matmul as amk
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.kernels import rwkv6_scan as rsk

    return {"approx_matmul_cv_fused": amk.approx_matmul_cv_fused,
            "approx_matmul_cv": amk.approx_matmul_cv,
            "flash_attention": fak.flash_attention,
            "rwkv6_scan": rsk.rwkv6_scan}


def counted_run(torch, label: str, run, expected: dict, what: str):
    """Runs ``run`` (warmed up before) once, with every wrapper's count
    zeroed just before and read just after; fails unless the counts equal
    ``expected`` (a wrapper it does not name: 0).  Returns ``run``'s result,
    the wall seconds, the counts and the peak bytes allocated."""
    wr = wrappers()
    for w in wr.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: w.launches for n, w in wr.items()}
    want = {n: expected.get(n, 0) for n in wr}
    print(f"{label}: wrapper launches {launches}, {what} implies {want}",
          flush=True)
    if launches != want:
        fail(f"{label}: launches {launches} != {want}")
    return out, wall, launches, torch.cuda.max_memory_allocated()


def check_prefill(torch, label: str, logits, shape: tuple, mod, plain=None):
    """The checks every prefill path shares, on ``logits()``: two calls give
    bit-equal finite float32 logits of ``shape``; one call with ``mod``'s
    kernel swapped for ``plain`` (its own plain version unless given) gives
    the logit gap and the argmax agreement; then the teacher-forced
    per-layer check.  Returns the fields of the path's JSON line and the
    (last dim, causal flag) of the kernel's calls."""
    name = "rwkv6_scan" if hasattr(mod, "rwkv6_scan") else "flash_attention"
    l1, l2 = logits(), logits()
    torch.cuda.synchronize()
    if tuple(l1.shape) != shape or l1.dtype != torch.float32 \
            or not bool(torch.isfinite(l1).all()):
        fail(f"{label}: logits {l1.dtype} {tuple(l1.shape)} not finite f32 "
             f"of shape {shape}")
    if not torch.equal(l1, l2):
        fail(f"{label}: two identical calls gave different logits")
    del l2
    with plain_swapped(label, [(mod, name,
                                plain or getattr(mod, f"{name}_plain"))]):
        lp = logits()
    torch.cuda.synchronize()
    gap = float((l1 - lp).abs().max())
    agree = float((l1.argmax(-1) == lp.argmax(-1)).float().mean())
    print(f"{label}: deterministic; logits with {name} swapped for its plain "
          f"version: max gap {gap:.4g} (logit scale "
          f"{float(l1.abs().max()):.4g}), argmax agreement {agree:.3f}",
          flush=True)
    del l1, lp
    per_layer, calls = teacher_forced(torch, label, mod, logits)
    return {"plain_gap": gap, "plain_argmax_agreement": agree,
            "per_layer_max_abs_err": per_layer}, calls


def run_legacy_path(torch, dev, arch: str) -> dict:
    """Phase 5: one arch through ``launch.serve.run_legacy`` at full width
    and depth: B=4, the arch's prompt length, 32 greedy tokens.  A hybrid
    arch adds :func:`hybrid_checks`."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.approx_linear import iter_tensors
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.kernels import rwkv6_scan as rsk
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    prompt_len, pre_calls, dec_calls, head_calls = LEGACY[arch]
    cfg = get_config(arch)
    label = f"legacy {arch}"
    print(f"legacy: {cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab} rwkv={cfg.rwkv} "
          f"compute={cfg.compute_dtype}; B={BATCH} T={prompt_len} G={GEN}",
          flush=True)
    spec = pallas_spec()
    spec_path = ROOT / "build" / "legacy_spec.json"
    spec_path.parent.mkdir(exist_ok=True)
    spec_path.write_text(spec.to_json())

    def args(gen, cache_dtype="bfloat16"):
        return argparse.Namespace(
            arch=arch, batch=BATCH, prompt_len=prompt_len, gen=gen,
            mode="perforated", m=2, no_cv=False, preset=None,
            spec_json=str(spec_path), device=dev.type,
            cache_dtype=cache_dtype)

    api = build_model(cfg, dev)
    params = api.init(0)
    serve.run_legacy(args(2), params=params)  # warm-up, not counted
    torch.cuda.synchronize()
    expected = {
        "approx_matmul_cv_fused": cfg.n_layers * (pre_calls + dec_calls * (
            GEN - 1)) + head_calls * GEN,
        "rwkv6_scan" if cfg.rwkv else "flash_attention": cfg.n_layers}
    res, _, launches, peak = counted_run(
        torch, label, lambda: serve.run_legacy(args(GEN), params=params),
        expected, f"the schedule (one prefill, {GEN - 1} decode steps)")
    packed = res["params"]
    if not cfg.parallel_ssm:  # the hybrid's int8-cache run repacks them
        del params
    check_packs(label, packed)
    toks = res["tokens"]
    if toks.shape != (BATCH, GEN) or not bool(
            ((toks >= 0) & (toks < cfg.vocab)).all()):
        fail(f"{label}: tokens {tuple(toks.shape)} out of range")

    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (BATCH, prompt_len)), device=dev)

    def last_logits():
        return api.prefill(packed, {"tokens": prompt}, prompt_len + GEN)[0]

    first = []  # the first layer's scan inputs in the plain run

    def scan_plain(*a, **kw):
        if not first:
            first.append(a)
        return rsk.rwkv6_scan_plain(*a, **kw)

    t0 = time.perf_counter()
    checked, _ = check_prefill(torch, label, last_logits, (BATCH, cfg.vocab),
                               rsk if cfg.rwkv else fak,
                               scan_plain if cfg.rwkv else None)
    t_checks = time.perf_counter() - t0
    flips = None
    if first:  # where the gap starts: the model casts the WKV output to bf16
        o_k, o_p = rsk.rwkv6_scan(*first[0])[0], rsk.rwkv6_scan_plain(
            *first[0])[0]
        diff = (o_k - o_p).abs()
        flips = int((o_k.bfloat16() != o_p.bfloat16()).sum())
        print(f"{label}: first layer's WKV output, kernel against plain on "
              f"the same inputs: max abs diff {float(diff.max()):.3g}, "
              f"median relative diff "
              f"{float((diff / o_p.abs().clamp_min(1e-30)).median()):.3g}; "
              f"{flips} of {o_p.numel()} values differ once rounded to "
              "bfloat16", flush=True)
    cache = api.prefill(packed, {"tokens": prompt}, prompt_len + GEN)[1]
    tok = torch.zeros(BATCH, 1, dtype=torch.long, device=dev)
    breakdown = {
        "prefill": (hybrid_prefill_profile(torch, label, api, last_logits)
                    if cfg.parallel_ssm else
                    profile_fn(torch, f"{label}: profile prefill",
                               last_logits,
                               f"host_profile_{arch}_prefill.txt")),
        # one decode step after the prompt; the ten profiled steps stay
        # inside the cache's GEN free positions
        "decode": profile_fn(torch, f"{label}: profile decode step",
                             lambda: api.decode_step(packed, tok, cache),
                             f"host_profile_{arch}_decode.txt")}
    check_one_launch(f"{label}: decode step", breakdown["decode"])
    print(f"{label}: prefill checks {t_checks:.1f} s, profiles "
          f"{time.perf_counter() - t0 - t_checks:.1f} s", flush=True)
    line = {"arch": arch, "layers": cfg.n_layers, "batch": BATCH,
            "prompt_len": prompt_len, "gen": GEN,
            "prefill_ms": res["prefill_s"] * 1e3,
            "pack_gib": storage_gib(iter_tensors(packed)),
            "k_major_gib": k_major_gib(packed),
            "decode_ms_per_token": res["decode_s_per_step"] * 1e3,
            "tok_per_s": res["tok_per_s"], "peak_mem_gib": peak / 2**30,
            **checked, "scan_bf16_flips_layer0": flips,
            "launches": launches, "step_breakdown": breakdown}
    if cfg.parallel_ssm:
        line.update(hybrid_checks(torch, label, api, packed, prompt, res,
                                  lambda: serve.run_legacy(
                                      args(GEN, "int8"), params=params),
                                  expected, breakdown))
    print(f"{label}: prefill_ms {line['prefill_ms']:.2f}; decode_ms_per_token "
          f"{line['decode_ms_per_token']:.2f} (one token per sequence per "
          f"step, {BATCH} sequences); tok_per_s {line['tok_per_s']:.1f}; "
          f"peak_mem_gib {line['peak_mem_gib']:.3f} (serving params "
          f"{line['pack_gib']:.3f} GiB, K-major weight codes "
          f"{line['k_major_gib']:.3f} GiB of it)", flush=True)
    write_line(label, f"legacy_{arch}.json", line)
    return line


def hybrid_prefill_profile(torch, label: str, api, last_logits) -> dict:
    """hymba's prefill profiled in two parts, because its SSM scan makes
    ~10^5 operations (one ``addcmul`` a time step and layer) and tracing
    them costs the profiler over a minute of host time: the prefill with
    ``nn.ssm._scan`` replaced by a stand-in that returns zeros of its
    output's shape (``profile_fn``: every other kernel, and the stand-in's
    zero fill), and one layer's scan at the prefill's shapes (``profile_fn``
    on random inputs: its elementwise kernels do the same work whatever the
    values), scaled by the depth.  Device ms is their sum; wall ms is the
    median of 3 real prefills, and the scan's wall what they take beyond
    the stand-in's.  Returns ``profile_fn``'s keys for the prefill and the
    scan's share (``ssm_scan``)."""
    from repro_torch.nn import ssm as ssm_lib

    cfg = api.cfg
    scfg = cfg.ssm_config()
    b, t, dev = BATCH, LEGACY[HYMBA][0], api.device
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        last_logits()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_ms = statistics.median(walls) * 1e3
    real = ssm_lib._scan

    def stand_in(h, a, xc, *rest):
        return torch.zeros(xc.shape, dtype=torch.float32, device=dev), h

    ssm_lib._scan = stand_in
    try:
        rest = profile_fn(torch, f"{label}: profile prefill, the SSM scan "
                          "replaced by zeros", last_logits,
                          "host_profile_hymba-1.5b_prefill.txt")
    finally:
        ssm_lib._scan = real
    g = torch.Generator(device=dev).manual_seed(9)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    xc = rnd(b, t, scfg.d_inner)
    dt = torch.nn.functional.softplus(rnd(b, t, scfg.d_inner))
    bm, cm = rnd(b, t, scfg.d_state), rnd(b, t, scfg.d_state)
    h0 = torch.zeros(b, scfg.d_inner, scfg.d_state, device=dev)
    a = -torch.arange(1, scfg.d_state + 1, device=dev, dtype=torch.float32
                      ).repeat(scfg.d_inner, 1)
    scan = profile_fn(torch, f"{label}: profile one layer's SSM scan "
                      f"(B={b}, T={t})",
                      lambda: ssm_lib._scan(h0, a, xc, dt, bm, cm),
                      "host_profile_hymba_ssm_scan.txt")
    n = cfg.n_layers
    device_ms = rest["device_ms"] + n * scan["device_ms"]
    top = dict(rest["top_device_us"])
    for name, us in scan["top_device_us"].items():
        top[name] = top.get(name, 0.0) + n * us
    out = {"wall_ms": wall_ms, "device_ms": device_ms,
           "device_idle_share": 1 - device_ms / wall_ms,
           "top_device_us": dict(sorted(top.items(), key=lambda kv: kv[1],
                                        reverse=True)[:6]),
           "fused_calls": rest["fused_calls"],
           "approx_launches": rest["approx_launches"],
           # the scan's wall: what the prefill takes beyond the stand-in's
           # (one layer's scan timed alone overstates it: a call's own
           # synchronisation and host start-up)
           "ssm_scan": {"one_layer": scan,
                        "ssm_wall_ms": wall_ms - rest["wall_ms"],
                        "ssm_device_ms": n * scan["device_ms"],
                        "wall_share": 1 - rest["wall_ms"] / wall_ms,
                        "device_share": n * scan["device_ms"] / device_ms}}
    print(f"{label}: profile prefill (the two parts): " + json.dumps(
        {k: v for k, v in out.items() if k != "ssm_scan"}), flush=True)
    return out


def hybrid_checks(torch, label: str, api, packed, prompt, res, run_int8,
                  expected: dict, breakdown: dict) -> dict:
    """The "hybrid" phase's checks beyond the lock-step path's, on its
    packs: every flash call of a prefill is in window mode at GQA group 5
    (the spy sees the kernel's arguments), the fused approx calls of a
    prefill and a decode step are at hymba's (M, K, N) and as many as the
    layers imply, the kernel path's logits bit-equal to the plain path's
    with the approx wrapper swapped, the same loop over an int8 ring cache
    (the launch counts, the ring int8 and the SSM state float32; the
    tokens' agreement with the bf16 cache's and the first decode step's
    logit gap, printed), and the SSM's share of a prefill (from
    :func:`hybrid_prefill_profile`) and of a decode step (one layer's
    ``ssm_decode_step`` profiled and scaled by the depth)."""
    from collections import Counter

    from repro_torch.core.approx_linear import layer_params
    from repro_torch.kernels import approx_matmul as amk
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.nn import ssm as ssm_lib

    cfg = api.cfg
    b, t = prompt.shape
    max_len = t + GEN
    flash_calls, fused = [], Counter()
    real_fa, real_am = fak.flash_attention, amk.approx_matmul_cv_fused

    def fa_spy(q, k, v, **kw):
        flash_calls.append((tuple(q.shape), tuple(k.shape), kw.get("causal"),
                            kw.get("window")))
        return real_fa(q, k, v, **kw)

    def am_spy(x, *a, **kw):
        fused[(x.shape[0], kw["k"], kw["n"])] += 1
        return real_am(x, *a, **kw)

    t0 = time.perf_counter()
    fa_spy.launches = am_spy.launches = 0
    fak.flash_attention, amk.approx_matmul_cv_fused = fa_spy, am_spy
    tok = res["tokens"][:, :1]
    try:
        lk, cache = api.prefill(packed, {"tokens": prompt}, max_len)
        dl16 = api.decode_step(packed, tok, cache)[0]
    finally:
        fak.flash_attention, amk.approx_matmul_cv_fused = real_fa, real_am
    del cache
    want_fa = ((b, cfg.n_heads, t, cfg.head_dim),
               (b, cfg.kv_heads, t, cfg.head_dim), True, cfg.window)
    if flash_calls != [want_fa] * cfg.n_layers:
        fail(f"{label}: flash calls {sorted(set(flash_calls))} x "
             f"{len(flash_calls)}, want {want_fa} x {cfg.n_layers}")
    want_am = Counter()
    for k, n in HYMBA_KN:
        want_am[(b * t, k, n)] += cfg.n_layers
    for k, n in HYMBA_DECODE_KN:
        want_am[(b, k, n)] += cfg.n_layers
    want_am[(b,) + HYMBA_HEAD_KN] += 2
    if fused != want_am:
        fail(f"{label}: fused calls {dict(fused)}, want {dict(want_am)}")
    print(f"{label}: a prefill's {len(flash_calls)} flash calls all at q "
          f"{want_fa[0]} k/v {want_fa[1]} causal, window {cfg.window} (GQA "
          f"group {cfg.n_heads // cfg.kv_heads}); a prefill and a decode "
          f"step made the fused calls (M, K, N): "
          + json.dumps({str(key): c for key, c in sorted(fused.items())}),
          flush=True)

    swaps = [(amk, "approx_matmul_cv_fused", amk.approx_matmul_cv_fused_plain)]
    with plain_swapped(label, swaps):
        lp = api.prefill(packed, {"tokens": prompt}, max_len)[0]
    torch.cuda.synchronize()
    if not torch.equal(lk, lp):
        fail(f"{label}: the approx kernel path's prefill logits differ from "
             f"the plain path's by {float((lk - lp).abs().max())}")
    print(f"{label}: prefill logits through the approx kernel equal the "
          "plain path's (flash on the kernel in both); spies and the plain "
          f"prefill {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()

    res8, _, launches8, peak8 = counted_run(
        torch, f"{label} int8-cache", run_int8, expected,
        f"the schedule (one prefill, {GEN - 1} decode steps)")
    c8 = api.prefill(packed, {"tokens": prompt}, max_len,
                     cache_dtype=torch.int8)[1]
    dtypes = {k: str(v.dtype) for k, v in c8.items() if k != "pos"}
    if dtypes != {"k": "torch.int8", "v": "torch.int8",
                  "ssm_conv": "torch.float32", "ssm_h": "torch.float32"} \
            or c8["k"].shape[-2] != cfg.window:
        fail(f"{label}: int8 cache leaves {dtypes}, ring "
             f"{c8['k'].shape[-2]}")
    # a different numeric from the bf16 cache (steps of 1/16 on the ring's
    # keys and values): the agreement and the first decode step's logit
    # gap are reported, not asserted
    agree = float((res8["tokens"] == res["tokens"]).float().mean())
    dl8 = api.decode_step(packed, tok, c8)[0]
    gap = float((dl8 - dl16).abs().max())
    ring_gib = sum(c8[k].numel() * c8[k].element_size()
                   for k in ("k", "v")) / 2**30
    ssm_gib = sum(c8[k].numel() * 4 for k in ("ssm_conv", "ssm_h")) / 2**30
    print(f"{label} int8-cache: ring leaves int8 ({ring_gib:.4f} GiB, "
          f"{cfg.window} positions a layer), SSM state float32 "
          f"({ssm_gib:.4f} GiB); {agree:.3f} of the generated tokens equal "
          f"the bf16 cache run's; the first decode step's logits differ by "
          f"at most {gap:.4g} (logit scale {float(dl16.abs().max()):.4g}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del c8, res8
    t0 = time.perf_counter()

    # the SSM decode step alone (one layer's, at the model's shapes) scaled
    # by the depth, against the whole decode step; the prefill's share is
    # part of its profile (hybrid_prefill_profile)
    scfg = cfg.ssm_config()
    bp = layer_params(packed["blocks"], 0)["ssm"]
    state = ssm_lib.init_ssm_state(scfg, b, device=api.device)
    x1 = torch.randn(b, 1, cfg.d_model, device=api.device).to(torch.bfloat16)
    step = profile_fn(torch, f"{label}: profile one layer's ssm_decode_step",
                      lambda: ssm_lib.ssm_decode_step(bp, x1, state, scfg),
                      "host_profile_hymba_ssm_decode.txt")
    pre, dec = breakdown["prefill"], breakdown["decode"]
    share = {"prefill": {k: pre["ssm_scan"][k] for k in (
                 "ssm_wall_ms", "ssm_device_ms", "wall_share",
                 "device_share")},
             "decode": {"ssm_wall_ms": step["wall_ms"] * cfg.n_layers,
                        "ssm_device_ms": step["device_ms"] * cfg.n_layers,
                        "wall_share": (step["wall_ms"] * cfg.n_layers
                                       / dec["wall_ms"]),
                        "device_share": (step["device_ms"] * cfg.n_layers
                                         / dec["device_ms"])}}
    print(f"{label}: the SSM (prefill: the scan; decode: the whole "
          f"ssm_decode_step) scaled by {cfg.n_layers} layers against the "
          f"step: " + json.dumps(share)
          + f"; {time.perf_counter() - t0:.1f} s", flush=True)
    return {"flash_calls_window": len(flash_calls), "fused_calls_by_shape":
            {str(key): c for key, c in sorted(fused.items())},
            "int8_cache": {"launches": launches8, "peak_mem_gib":
                           peak8 / 2**30, "token_agreement_with_bf16": agree,
                           "first_decode_logit_gap": gap,
                           "ring_gib": ring_gib, "ssm_state_gib": ssm_gib},
            "ssm_share": share}


#: the "train" phase.  Card against host: each arch at full width cut to
#: TRAIN_CHECK_LAYERS layers, float32 compute (TF32 off), the same initial
#: weights and batches, TRAIN_CHECK_STEPS steps of make_train_step (lr
#: 1e-3, no warm-up, AdamW eps 1e-4, so that float32 noise in a
#: near-zero gradient element cannot flip its normalised step): every loss
#: within TRAIN_LOSS_RTOL and every parameter within TRAIN_PARAM_ATOL (a
#: tenth of one step at lr 1e-3) of the host's
TRAIN_CHECK_ARCHS = ("olmo-1b", "rwkv6-1.6b", "hymba-1.5b")
TRAIN_CHECK_LAYERS, TRAIN_CHECK_STEPS = 2, 2
TRAIN_CHECK_B, TRAIN_CHECK_T = 2, 64
TRAIN_LOSS_RTOL, TRAIN_PARAM_ATOL = 1e-4, 1e-4
#: then olmo-1b at full width and depth as configured (bf16 compute, remat
#: "full"): TRAIN_STEPS steps of B x T on the synthetic stream
TRAIN_ARCH, TRAIN_B, TRAIN_T, TRAIN_STEPS = "olmo-1b", 4, 512, 8


def run_train_phase(torch, dev) -> dict:
    """The training step on the card (``launch.train``): card steps against
    host steps on three archs, then a full-size olmo-1b run: each step's
    loss, wall and device ms, tokens/s, peak GiB; the losses finite and the
    last below the first.  Training reaches neither inference kernel (the
    wrappers' counts stay 0)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticLMConfig, lm_batch
    from repro_torch.launch.train import (TrainConfig, init_train_state,
                                          make_train_step)
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import tree_leaves, tree_map

    out = {"card_vs_host": {}}
    tcfg = TrainConfig(optimizer=AdamWConfig(eps=1e-4), base_lr=1e-3,
                       warmup_steps=0, total_steps=100)
    for arch in TRAIN_CHECK_ARCHS:
        cfg = dataclasses.replace(get_config(arch),
                                  n_layers=TRAIN_CHECK_LAYERS,
                                  compute_dtype="float32")
        host = build_model(cfg, "cpu").init(0)
        states = {"cpu": init_train_state(cfg, tcfg, device="cpu",
                                          params=host),
                  "cuda": init_train_state(cfg, tcfg, device=dev, params=(
                      tree_map(lambda _, a: a.to(dev), host)))}
        steps = {d: make_train_step(cfg, tcfg, device=d if d == "cpu"
                                    else dev) for d in states}
        dcfg = SyntheticLMConfig(vocab=cfg.vocab, seq_len=TRAIN_CHECK_T,
                                 batch=TRAIN_CHECK_B)
        losses = {d: [] for d in states}
        t0 = time.perf_counter()
        for i in range(TRAIN_CHECK_STEPS):
            batch = lm_batch(dcfg, i)
            for d in states:
                states[d], m = steps[d](states[d], batch)
                losses[d].append(float(m["loss"]))
        worst = max(float((a.to("cpu") - b_).abs().max()) for a, b_ in zip(
            tree_leaves(states["cuda"]["params"]),
            tree_leaves(states["cpu"]["params"])))
        rel = max(abs(a - b_) / abs(b_) for a, b_ in zip(losses["cuda"],
                                                          losses["cpu"]))
        print(f"train: {arch} full width, {TRAIN_CHECK_LAYERS} layers, "
              f"float32, B={TRAIN_CHECK_B} T={TRAIN_CHECK_T}: card losses "
              f"{losses['cuda']} host {losses['cpu']} (max rel diff "
              f"{rel:.3g}, rtol {TRAIN_LOSS_RTOL}); parameters after "
              f"{TRAIN_CHECK_STEPS} steps max abs diff {worst:.3g} (atol "
              f"{TRAIN_PARAM_ATOL}); {time.perf_counter() - t0:.1f} s",
              flush=True)
        if not (rel <= TRAIN_LOSS_RTOL and worst <= TRAIN_PARAM_ATOL):
            fail(f"train: {arch}: the card's steps leave the host's")
        out["card_vs_host"][arch] = {"losses_card": losses["cuda"],
                                     "losses_host": losses["cpu"],
                                     "loss_rel_diff": rel,
                                     "param_max_abs_diff": worst}
        del states, steps, host

    cfg = get_config(TRAIN_ARCH)
    tcfg = TrainConfig(base_lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, tcfg, device=dev)
    step = make_train_step(cfg, tcfg, device=dev)
    dcfg = SyntheticLMConfig(vocab=cfg.vocab, seq_len=TRAIN_T, batch=TRAIN_B)
    print(f"train: {cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"params={cfg.param_count() / 1e9:.3f} B, compute "
          f"{cfg.compute_dtype}, remat {cfg.remat}; B={TRAIN_B} "
          f"T={TRAIN_T}, {TRAIN_STEPS} steps", flush=True)
    wr = wrappers()
    for w in wr.values():
        w.launches = 0
    rows = []
    for i in range(TRAIN_STEPS):
        batch = lm_batch(dcfg, i)
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev0.record()
        state, m = step(state, batch)
        ev1.record()
        loss = float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rows.append({"step": i, "loss": loss, "lr": float(m["lr"]),
                     "wall_ms": wall * 1e3,
                     "gpu_elapsed_ms": ev0.elapsed_time(ev1),
                     "tok_per_s": TRAIN_B * TRAIN_T / wall})
        print("train step " + json.dumps(rows[-1]), flush=True)
    launches = {n: w.launches for n, w in wr.items()}
    if any(launches.values()):
        fail(f"train: the training step launched inference kernels "
             f"{launches}")
    losses = [r["loss"] for r in rows]
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail(f"train: losses {losses}: not finite, or the last not below "
             "the first")
    batch = lm_batch(dcfg, TRAIN_STEPS)
    prof = profile_fn(torch, f"train: profile one {cfg.name} step",
                      lambda: step(state, batch), "host_profile_train.txt")
    out.update({"arch": cfg.name, "layers": cfg.n_layers, "batch": TRAIN_B,
                "seq": TRAIN_T, "steps": rows,
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                "step_profile": prof})
    print(f"train: {cfg.name} losses {[round(x, 4) for x in losses]}; "
          f"median step {statistics.median(r['wall_ms'] for r in rows[1:]):.1f}"
          f" wall ms, {prof['device_ms']:.1f} device ms; "
          f"{statistics.median(r['tok_per_s'] for r in rows[1:]):.0f} "
          f"tokens/s; peak {out['peak_mem_gib']:.2f} GiB", flush=True)
    write_line("train", "train.json", out)
    del state, step
    torch.cuda.empty_cache()
    return {w: 0 for w in wr}


def run_qwen2vl_engine(torch, dev) -> dict:
    """Phase 4d: full-width qwen2-vl-2b (QWEN2VL_ENGINE_LAYERS of its 28
    layers; M-RoPE with the three ids equal, as token prompts give; QKV
    biases; GQA 12/2) through the
    engine on ``serve-default`` packs with a bf16 KV cache, with the checks
    of the olmo-1b phase.  The engine takes token prompts only, as the
    reference's does.  Returns the launch counts and (cfg, api, packs) for
    the embeds phase."""
    from repro_torch.configs import EngineConfig
    from repro_torch.core.approx_linear import iter_tensors
    from repro_torch.launch.serve import mixed_trace

    t0 = time.perf_counter()
    cfg, api, packed = build_packed(torch, dev, "qwen2-vl-2b",
                                    QWEN2VL_ENGINE_LAYERS)
    label = "qwen2-vl"
    members = check_packs(label, packed)
    pack_gib = storage_gib(iter_tensors(packed))
    print(f"{label}: {cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"heads={cfg.n_heads} kv={cfg.kv_heads} head_dim={cfg.head_dim} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab} rope={cfg.rope} "
          f"sections={cfg.mrope_sections} theta={cfg.rope_theta:g} "
          f"qkv_bias={cfg.qkv_bias} tied={cfg.tie_embeddings}; init + pack "
          f"{time.perf_counter() - t0:.1f} s; serving params {pack_gib:.3f} "
          f"GiB, K-major weight codes {k_major_gib(packed):.3f} GiB "
          f"({members} fused-group members read row slices of their "
          "group's)", flush=True)
    ecfg = EngineConfig(slots=4, max_len=256, prefill_chunk=32,
                        cache_dtype="bfloat16")
    trace = mixed_trace(cfg, 8, ecfg.max_len, ecfg.prefill_chunk, seed=0)
    warm_up(torch, api, packed, ecfg)
    spec = pallas_spec()
    run = engine_run(torch, label, cfg, api, packed, ecfg, trace,
                     dense_calls(cfg, ecfg.slots), spec.name)
    check_sequential(label, run, trace, lambda p, g, calls: replay_dense(
        torch, api, packed, ecfg, p, calls))
    g = torch.Generator(device=dev).manual_seed(5)
    toks = torch.randint(0, cfg.vocab, (ecfg.slots, ecfg.prefill_chunk),
                         generator=g, device=dev)
    kernel_vs_plain(torch, label, api, packed, ecfg, toks)
    breakdown = {kind: profile_call(torch, label, api, packed, ecfg, c)
                 for kind, c in (("thin", 1), ("chunk", ecfg.prefill_chunk))}
    check_one_launch(f"{label}: thin step", breakdown["thin"])
    write_line(label, "engine_qwen2-vl.json", {
        **served_metrics(run["snap"]), "layers": cfg.n_layers,
        "peak_mem_gib": run["peak"] / 2**30, "pack_gib": pack_gib,
        "k_major_gib": k_major_gib(packed),
        "cache_gib": cache_gib(run["cache"]), "launches": run["launches"],
        "step_breakdown": breakdown})
    return run["launches"], (cfg, api, packed)


def mrope_ids(torch, b: int, t: int, dev, start: int = 64, side: int = 16):
    """(3, B, T) M-RoPE ids of a prompt with one image: text ids 0..start-1
    on all three axes, then a side x side block of patches whose temporal
    id stays at ``start`` while the height and width ids walk its rows and
    columns, then text again from ``start + side`` on all three axes (the
    layout qwen2-vl gives an image inside text)."""
    n = side * side
    ids = torch.arange(t, device=dev).repeat(3, b, 1)
    r = torch.arange(n, device=dev) // side
    c = torch.arange(n, device=dev) % side
    ids[0, :, start:start + n] = start
    ids[1, :, start:start + n] = start + r
    ids[2, :, start:start + n] = start + c
    ids[:, :, start + n:] = start + side + torch.arange(t - start - n,
                                                       device=dev)
    return ids


def run_vlm_embeds(torch, dev, built) -> dict:
    """Phase 4e: qwen2-vl-2b's multimodal prefill at full width on the
    engine phase's packs (``built``: cfg, api, packs): (4, 1024, 1536) bf16
    embeddings (the stubbed vision frontend's output, made from the seed)
    with (3, 4, 1024) M-RoPE ids holding a 16 x 16 image block, then GEN
    greedy token decode steps whose positions continue from the cache's on
    all three axes (the reference's rule).  Checks the launch counts (one
    flash a layer; the approx kernel on every packed layer), finite
    tokens and logits, that the whole run twice gives bit-equal tokens,
    that the M-RoPE ids reach the logits, and ``check_prefill``."""
    from repro_torch.core.approx_linear import iter_tensors
    from repro_torch.kernels import flash_attention as fak

    label = "vlm embeds"
    cfg, api, packed = built
    b, t = BATCH, LEGACY["qwen2-vl-2b"][0]
    g = torch.Generator(device=dev).manual_seed(11)
    emb = torch.randn(b, t, cfg.d_model, generator=g, device=dev).to(
        torch.bfloat16)
    ids = mrope_ids(torch, b, t, dev)
    print(f"{label}: {cfg.name} layers={cfg.n_layers}; embeds "
          f"{tuple(emb.shape)} bf16, M-RoPE ids {tuple(ids.shape)} with a "
          f"16 x 16 image block; then {GEN} decode steps", flush=True)

    def prefill(positions=ids):
        return api.prefill(packed, {"embeds": emb, "positions": positions},
                           t + GEN)

    def generate():
        logits, cache = prefill()
        first = logits
        tok = torch.argmax(logits, -1)[:, None]
        out = [tok]
        for _ in range(GEN):
            logits, cache = api.decode_step(packed, tok, cache)
            tok = torch.argmax(logits, -1)[:, None]
            out.append(tok)
        return first, logits, torch.cat(out, 1)

    generate()  # warm-up, not counted
    torch.cuda.synchronize()
    (first, last, toks), wall, launches, peak = counted_run(
        torch, label, generate, {
            "approx_matmul_cv_fused": cfg.n_layers * (4 + 7 * GEN),
            "flash_attention": cfg.n_layers},
        f"the schedule (one prefill, {GEN} decode steps)")
    if last.shape != (b, cfg.vocab) or not bool(torch.isfinite(last).all()):
        fail(f"{label}: last decode step's logits {tuple(last.shape)} not "
             "finite")
    if toks.shape != (b, GEN + 1) or not bool(
            ((toks >= 0) & (toks < cfg.vocab)).all()):
        fail(f"{label}: tokens {tuple(toks.shape)} out of range")
    if not torch.equal(toks, generate()[2]):
        fail(f"{label}: two identical runs gave different tokens")
    text = prefill(None)[0]  # the ids 0..T-1 on all three axes
    mrope_moves = float((text - first).abs().max())
    if mrope_moves == 0.0:
        fail(f"{label}: the M-RoPE ids did not reach the logits")
    print(f"{label}: {toks.numel()} tokens equal in two runs; the ids 0..T-1 "
          f"on every axis move the prefill logits by {mrope_moves:.4g}",
          flush=True)
    checked, _ = check_prefill(torch, label, lambda: prefill()[0],
                               (b, cfg.vocab), fak)
    breakdown = {"prefill": profile_fn(
        torch, f"{label}: profile prefill", lambda: prefill()[0],
        "host_profile_qwen2-vl_embeds_prefill.txt")}
    write_line(label, "vlm_embeds.json", {
        "arch": cfg.name, "layers": cfg.n_layers, "batch": b,
        "prompt_len": t, "gen": GEN, "wall_s": wall,
        "pack_gib": storage_gib(iter_tensors(packed)),
        "peak_mem_gib": peak / 2**30, "mrope_logit_move": mrope_moves,
        **checked, "launches": launches, "step_breakdown": breakdown})
    return {"launches": launches, **checked}


def run_hubert_encoder(torch, dev) -> dict:
    """Phase 5b: hubert-xlarge's encoder at full width and depth (48
    layers): ``forward`` over (4, 1024, 1280) bf16 frame embeddings (the
    stubbed waveform frontend's output for about 20 s of audio at HuBERT's
    50 Hz frame rate), on ``serve-default`` packs.  Checks one
    non-causal flash launch at D=80 a layer, the packed layers and the
    head (N=504, on the prefill tile) on the approx kernel, finite and
    deterministic logits, the logit gap to the plain flash and the
    teacher-forced per-layer flash check."""
    from repro_torch.core.approx_linear import iter_tensors
    from repro_torch.kernels import approx_matmul as amk
    from repro_torch.kernels import flash_attention as fak

    label = "hubert"
    t0 = time.perf_counter()
    cfg, api, packed = build_packed(torch, dev, "hubert-xlarge")
    check_packs(label, packed)
    pack_gib = storage_gib(iter_tensors(packed))
    b, t = BATCH, HUBERT_M // BATCH
    g = torch.Generator(device=dev).manual_seed(13)
    emb = torch.randn(b, t, cfg.d_model, generator=g, device=dev).to(
        torch.bfloat16)
    head_tile = amk.tile(b * t, *HUBERT_HEAD_KN, "perforated", 2)
    print(f"{label}: {cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"heads={cfg.n_heads} kv={cfg.kv_heads} head_dim={cfg.head_dim} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab} norm={cfg.norm} mlp={cfg.mlp} "
          f"rope={cfg.rope} causal={cfg.causal}; init + pack "
          f"{time.perf_counter() - t0:.1f} s, serving params {pack_gib:.3f} "
          f"GiB; frames {tuple(emb.shape)} bf16; head {HUBERT_HEAD_KN} on "
          f"the {head_tile} tile", flush=True)
    if head_tile == "split_k":
        fail(f"{label}: the head's prefill rows took the split-K kernel")

    def forward():
        return api.forward(packed, {"embeds": emb})

    forward()  # warm-up, not counted
    torch.cuda.synchronize()
    _, wall, launches, peak = counted_run(
        torch, label, forward, {
            "approx_matmul_cv_fused": cfg.n_layers * 4 + 1,
            "flash_attention": cfg.n_layers}, "one forward")
    checked, calls = check_prefill(torch, label, forward,
                                   (b, t, cfg.vocab), fak)
    print(f"{label}: flash calls (head dim, causal) {sorted(calls)}",
          flush=True)
    if calls != {(cfg.head_dim, False)}:
        fail(f"{label}: flash calls {sorted(calls)}, want non-causal at "
             f"D={cfg.head_dim}")
    breakdown = {"forward": profile_fn(torch, f"{label}: profile forward",
                                       forward, "host_profile_hubert.txt")}
    write_line(label, "encoder_hubert.json", {
        "arch": cfg.name, "layers": cfg.n_layers, "batch": b, "frames": t,
        "forward_ms": wall * 1e3, "pack_gib": pack_gib,
        "k_major_gib": k_major_gib(packed), "peak_mem_gib": peak / 2**30,
        **checked, "launches": launches, "step_breakdown": breakdown})
    return {"launches": launches, **checked}


# ---------------------------------------------------------------------------
# the paper's CNN path
# ---------------------------------------------------------------------------


#: depth of moonshot-v1-16b-a3b in the "moe" phase (widths full; 48
#: layers cut to 8 for the phase's time and the card's memory)
MOON_LAYERS = 8


def build_by_layer(torch, dev, cfg) -> tuple[dict, dict]:
    """``serve-default`` packs on the approx kernel of a full-width model
    through the port's layer-at-a-time build
    (``build_serving_params_by_layer``, byte-equal on the CPU to
    ``build_serving_params(api.init(0))``), which the serve CLI takes
    where the float32 init and its serving copy do not fit on the card
    together (deepseek-v2-lite-16b: 62.8 GB of float32).  Fails unless the
    packed layers are the plan's for the whole model.  Returns the tree
    and the build's seconds, peak GiB and the CLI's route."""
    import gc

    from repro_torch.core.approx_linear import packed_layer_paths
    from repro_torch.launch.serve import (ServeConfig, _float_tree_fits,
                                          build_serving_params_by_layer)
    from repro_torch.models import build_model

    # earlier engines hold reference cycles: free what they kept, so that
    # the build's peak is its own
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    route = ("whole" if _float_tree_fits(cfg, torch.device(dev))
             else "by layer")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scfg = ServeConfig(spec=pallas_spec())
    packed = build_serving_params_by_layer(cfg, scfg, seed=0, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    plan = scfg.numerics_spec().resolve(build_model(cfg, "meta").init(0))
    want = sorted(e.path for e in plan.packed)
    if packed_layer_paths(packed) != want:
        fail(f"{cfg.name}: layer-by-layer packs {packed_layer_paths(packed)}"
             f" != the plan's {want}")
    return packed, {"build_s": seconds, "build_peak_gib": peak,
                    "cli_build_route": route}


def run_moe_arch(torch, dev, arch: str, n_layers: int | None = None,
                 paged: bool = False, want_calls=None, keep=None) -> dict:
    """One MoE arch through the engine at full width (``n_layers`` cuts the
    depth only): 8 requests of ``mixed_trace(seed=0)``, slots 4, max_len
    256, chunk 32, bf16 KV cache, on ``serve-default`` kernel packs built
    layer by layer.  The engine checks of the olmo-1b phase (launch counts,
    tokens equal a sequential decode, kernel path bit-equal to the plain
    path chunk-shaped and thin, one CUDA launch a thin step's fused call),
    then with ``paged`` the paged layout (``run_paged``).  ``want_calls``
    = (chunk, thin) fused calls a step the phase must count.  Returns the
    launches by path; a ``keep`` dict receives the packs, the trace and
    the run's tokens and launches (the distributed phase serves them
    again)."""
    import dataclasses

    from repro_torch.configs import EngineConfig, get_config
    from repro_torch.core.approx_linear import iter_tensors
    from repro_torch.launch.serve import mixed_trace
    from repro_torch.models import build_model

    cfg = get_config(arch)
    label = f"moe {arch}"
    if n_layers is not None and n_layers != cfg.n_layers:
        print(f"{label}: depth cut {cfg.n_layers} -> {n_layers} layers for "
              "the phase's time and memory (widths unchanged)", flush=True)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    packed, build = build_by_layer(torch, dev, cfg)
    api = build_model(cfg, dev)
    members = check_packs(label, packed)
    expert_gib = storage_gib([t for t in iter_tensors(
        packed["blocks"]["mlp"]["experts"])])
    pack_gib = storage_gib(iter_tensors(packed))
    print(f"{label}: layers={cfg.n_layers} (dense {cfg.first_dense_layers})"
          f" d_model={cfg.d_model} heads={cfg.n_heads} attn={cfg.attn} "
          f"experts={cfg.n_experts} top_k={cfg.top_k} shared="
          f"{cfg.n_shared_experts} d_ff_expert={cfg.d_ff_expert} d_ff="
          f"{cfg.d_ff} vocab={cfg.vocab}; built layer by layer (the CLI's "
          f"route here: {build['cli_build_route']}) in "
          f"{build['build_s']:.1f} s, peak {build['build_peak_gib']:.2f} "
          f"GiB; serving params {pack_gib:.3f} GiB, of which the float "
          f"routed experts {expert_gib:.3f} GiB (the rest "
          f"{pack_gib - expert_gib:.3f} GiB), K-major weight codes "
          f"{k_major_gib(packed):.3f} GiB ({members} fused-group members "
          "read row slices of their group's)", flush=True)
    ecfg = EngineConfig(slots=4, max_len=256, prefill_chunk=32,
                        cache_dtype="bfloat16")
    per_call = dense_calls(cfg, ecfg.slots)
    calls = (per_call(ecfg.prefill_chunk), per_call(1))
    if want_calls is not None and calls != want_calls:
        fail(f"{label}: {calls} fused calls a (chunk, thin) step, want "
             f"{want_calls}")
    print(f"{label}: {calls[0]} fused calls a chunk step, {calls[1]} a thin "
          "step", flush=True)
    trace = mixed_trace(cfg, 8, ecfg.max_len, ecfg.prefill_chunk, seed=0)
    spec = pallas_spec()
    warm_up(torch, api, packed, ecfg)
    run = engine_run(torch, label, cfg, api, packed, ecfg, trace, per_call,
                     spec.name)
    check_sequential(label, run, trace, lambda p, g, c: replay_dense(
        torch, api, packed, ecfg, p, c))
    g = torch.Generator(device=dev).manual_seed(5)
    toks = torch.randint(0, cfg.vocab, (ecfg.slots, ecfg.prefill_chunk),
                         generator=g, device=dev)
    kernel_vs_plain(torch, label, api, packed, ecfg, toks)
    breakdown = {kind: profile_call(torch, label, api, packed, ecfg, c)
                 for kind, c in (("thin", 1), ("chunk", ecfg.prefill_chunk))}
    check_one_launch(f"{label}: thin step", breakdown["thin"])
    kv = cache_gib(run["cache"])
    if cfg.attn == "mla":
        per_tok, gqa_per_tok = (cfg.kv_lora_rank + cfg.qk_rope_dim,
                                2 * cfg.n_heads * cfg.v_head_dim)
    else:
        per_tok = gqa_per_tok = 2 * cfg.kv_heads * cfg.head_dim
    line = {**served_metrics(run["snap"]), "layers": cfg.n_layers,
            "numerics": spec.name, "cache_dtype": ecfg.cache_dtype,
            **build, "run_peak_gib": run["peak"] / 2**30,
            "pack_gib": pack_gib, "expert_gib": expert_gib,
            "pack_gib_without_experts": pack_gib - expert_gib,
            "k_major_gib": k_major_gib(packed), "kv_gib": kv,
            "kv_values_per_token_layer": per_tok,
            "gqa_kv_gib_same_heads": kv * gqa_per_tok / per_tok,
            "launches": run["launches"], "fused_calls_chunk_thin": calls,
            "step_breakdown": breakdown}
    print(f"{label}: KV cache {kv:.4f} GiB ({per_tok} values a "
          f"token-layer); a GQA cache of the same heads would need "
          f"{line['gqa_kv_gib_same_heads']:.4f} GiB ({gqa_per_tok}); peak "
          f"GiB build {build['build_peak_gib']:.2f}, run "
          f"{line['run_peak_gib']:.2f}", flush=True)
    out = {label: run["launches"]}
    if paged:
        out[f"paged {arch}"] = run_paged(
            torch, f"paged {arch}", cfg, api, packed, ecfg, trace, run,
            spec.name)
    if keep is not None:
        keep.update(cfg=cfg, packed=packed, ecfg=ecfg, trace=trace,
                    per_call=per_call, numerics=spec.name,
                    tokens=[list(r.generated) for r in run["reqs"]],
                    launches=run["launches"], wall_s=run["wall_s"])
    del run
    write_line(label, f"moe_{arch}.json", line)
    return out


#: the serve CLI's route where the float32 init does not fit
BY_LAYER = "build_serving_params_by_layer (a layer at a time)"


def run_serve_cli(torch, arch: str, requests: int, by_layer: bool) -> dict:
    """The serve CLI (``repro_torch.launch.serve.main`` in this process,
    ``--engine``) on ``arch`` at full width and depth on ``serve-default``
    kernel packs, ``requests`` requests of ``mixed_trace(seed=0)``, slots
    4, max_len 256, chunk 32, bf16 KV.  The CLI's engine is logged (each
    step's shape, each request's calls) and its build timed.  Prints the
    build route, seconds and peak GiB, the params GiB with the K-major
    codes apart, the engine metrics and one profiled thin and chunk step.
    Fails unless the CLI built the serving params a layer at a time
    exactly when ``by_layer`` (the float32 init and its serving copy do
    not fit on the card together), every request finishes with its token
    count, the tokens equal a sequential decode on the same packs, the
    fused wrapper's launches (zeroed just before) equal the steps' fused
    calls, ``compile_count() == 2``, the packs hold their codes only
    K-major, the kernel path equals the plain one and a thin step's fused
    calls are one CUDA launch each.  Returns the launches."""
    import gc
    import io

    from repro_torch import serving
    from repro_torch.configs import get_config
    from repro_torch.core.approx_linear import iter_tensors
    from repro_torch.launch import serve

    label = f"cli {arch}"
    t_start = time.perf_counter()
    cfg = get_config(arch)
    spec_path = ROOT / "chiprun_out" / "cli_spec.json"
    os.makedirs(spec_path.parent, exist_ok=True)
    spec_path.write_text(pallas_spec().to_json())
    argv = ["--engine", "--arch", arch, "--spec-json", str(spec_path),
            "--requests", str(requests), "--slots", "4", "--max-len", "256",
            "--chunk", "32"]
    seen: dict = {"reqs": [], "steps": [], "sched": {}}
    base_engine, base_init = serving.ServingEngine, serve._packed_init

    class Logged(base_engine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen["engine"] = self
            dispatch = self._dispatch

            def logged(p, batch, *rest):
                c = batch.tokens.shape[1]
                seen["steps"].append(c)
                for r in batch.rows:
                    seen["sched"].setdefault(r.rid, []).append(
                        (c, int(batch.n_valid[r.slot])))
                return dispatch(p, batch, *rest)

            self._dispatch = logged

        def submit(self, *a, **kw):
            r = super().submit(*a, **kw)
            seen["reqs"].append(r)
            return r

    def timed_init(*a, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params_float, packed = base_init(*a, **kw)
        torch.cuda.synchronize()
        seen["build_s"] = time.perf_counter() - t0
        seen["build_peak"] = torch.cuda.max_memory_allocated()
        seen["route"] = ("the float32 init, then build_serving_params"
                         if params_float is not None else BY_LAYER)
        return params_float, packed

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    wr = wrappers()
    for w in wr.values():
        w.launches = 0
    buf = io.StringIO()
    serving.ServingEngine, serve._packed_init = Logged, timed_init
    try:
        with contextlib.redirect_stdout(buf):
            serve.main(argv)
        torch.cuda.synchronize()
    finally:
        serving.ServingEngine, serve._packed_init = base_engine, base_init
    cli_s = time.perf_counter() - t_start
    launches = {n: w.launches for n, w in wr.items()}
    out = buf.getvalue()
    (ROOT / "chiprun_out" / f"cli_{arch}.txt").write_text(out)
    eng, reqs = seen["engine"], seen["reqs"]
    trace = serve.mixed_trace(cfg, requests, 256, 32)
    if (seen["route"] == BY_LAYER) != by_layer:
        fail(f"{label}: the CLI built by {seen['route']}")
    if f"finished {requests}/{requests} requests, 2 compiled shapes" \
            not in out or eng.compile_count() != 2:
        fail(f"{label}: the CLI did not finish {requests}/{requests} "
             f"requests on 2 compiled shapes: {out[-600:]}")
    if len(reqs) != len(trace) or not all(
            r.finished and r.finish_reason == "length"
            and len(r.generated) == g for r, (_, g) in zip(reqs, trace)):
        fail(f"{label}: requests {[(r.finish_reason, len(r.generated)) for r in reqs]} "
             f"against the trace's {[g for _, g in trace]} tokens")
    per_call = dense_calls(cfg, 4)
    want = {n: 0 for n in wr}
    want["approx_matmul_cv_fused"] = sum(per_call(c) for c in seen["steps"])
    snap = eng.snapshot()
    print(f"{label}: python -m repro_torch.launch.serve {' '.join(argv)}: "
          f"built by {seen['route']} in {seen['build_s']:.1f} s (peak "
          f"{seen['build_peak'] / 2**30:.2f} GiB); {requests}/{requests} requests, "
          f"{eng.compile_count()} compiled shapes, the CLI {cli_s:.1f} s; "
          f"steps prefill={snap['prefill_steps']} mixed={snap['mixed_steps']} "
          f"decode={snap['decode_steps']}; wrapper launches {launches}, the "
          f"steps imply {want}", flush=True)
    if launches != want:
        fail(f"{label}: launches {launches} != {want}")
    api, packed, ecfg = eng.api, eng.params, eng.ecfg
    members = check_packs(label, packed)
    pack_gib = storage_gib(iter_tensors(packed))
    print(f"{label}: serving params {pack_gib:.3f} GiB, of which K-major "
          f"weight codes {k_major_gib(packed):.3f} GiB ({members} fused-group "
          "members read row slices of their group's)", flush=True)
    check_sequential(label, {"reqs": reqs, "sched": seen["sched"]}, trace,
                     lambda p, g, calls: replay_dense(
                         torch, api, packed, ecfg, p, calls))
    g = torch.Generator(device=api.device).manual_seed(5)
    toks = torch.randint(0, cfg.vocab, (ecfg.slots, ecfg.prefill_chunk),
                         generator=g, device=api.device)
    kernel_vs_plain(torch, label, api, packed, ecfg, toks)
    line = {**served_metrics(snap), "layers": cfg.n_layers,
            "numerics": pallas_spec().name, "cache_dtype": ecfg.cache_dtype,
            "build_route": seen["route"], "build_s": seen["build_s"],
            "build_peak_gib": seen["build_peak"] / 2**30,
            "pack_gib": pack_gib, "k_major_gib": k_major_gib(packed),
            "cache_gib": cache_gib(eng.pool.cache),
            "ttft_p95_s": eng.metrics.ttfts.percentile(0.95),
            "cli_s": cli_s, "launches": launches}
    line["step_breakdown"] = {
        kind: profile_call(torch, label, api, packed, ecfg, c)
        for kind, c in (("thin", 1), ("chunk", ecfg.prefill_chunk))}
    check_one_launch(f"{label}: thin step", line["step_breakdown"]["thin"])
    line["seconds"] = time.perf_counter() - t_start
    write_line(label, f"cli_{arch}.json", line)
    del eng, seen, api, packed
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def run_moe_phase(torch, dev, between=None) -> dict:
    """The "moe" phase: deepseek-v2-lite-16b at full width and depth (27
    layers: MLA, one leading dense layer, 64 routed experts top-6 and 2
    shared) on the contiguous and the paged layout, then through the serve
    CLI, then moonshot-v1-16b-a3b at full width and MOON_LAYERS of its 48
    layers.  ``between(keep)`` runs after deepseek's engine, on its packs
    (``run_moe_arch``'s ``keep``), and returns launches by path too.
    Returns the launches by path."""
    import gc

    t0 = time.perf_counter()
    keep = {}
    out = run_moe_arch(torch, dev, "deepseek-v2-lite-16b", paged=True,
                       want_calls=(109, 136), keep=keep)
    if between is not None:
        out.update(between(keep))
    keep.clear()
    gc.collect()
    torch.cuda.empty_cache()
    out["cli deepseek-v2-lite-16b"] = run_serve_cli(
        torch, "deepseek-v2-lite-16b", 4, by_layer=True)
    out.update(run_moe_arch(torch, dev, "moonshot-v1-16b-a3b",
                            n_layers=MOON_LAYERS))
    gc.collect()
    torch.cuda.empty_cache()
    print(f"moe: phase {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# the distributed phase
# ---------------------------------------------------------------------------

#: the sharded training step's arch, depth (widths full), batch and steps,
#: as the train phase's card-vs-host check cuts it
DIST_ARCH, DIST_LAYERS, DIST_B, DIST_T, DIST_STEPS = "olmo-1b", 2, 4, 512, 2
#: an olmo-1b layer's up projection over a B=4, T=1024 prefill
OVERLAP_M, OVERLAP_K, OVERLAP_N = 4 * 1024, 2048, 8192
#: dry-run cells counted in parallel (niced) while the earlier phases run
DRYRUN_WORKERS = 3
DRYRUN_LOG = ROOT / "chiprun_out" / "dryrun.log"


def start_dryrun():
    """Starts the dry run of every reference cell on both production
    meshes (``python -m repro_torch.launch.dryrun --all --force``: CPU
    only, on the ``meta`` device) in the background, at a lower priority,
    writing its records to ``chiprun_out/dryrun/`` (``--force``: records
    of an earlier run there are recomputed, never reported as cached).  Returns the process, which the
    distributed phase waits for; it is stopped at exit."""
    import atexit

    out = ROOT / "chiprun_out" / "dryrun"
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    log = open(DRYRUN_LOG, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--force", "--workers", str(DRYRUN_WORKERS), "--out", str(out)],
        cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
        preexec_fn=lambda: os.nice(10), start_new_session=True)
    log.close()

    def stop():
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()

    atexit.register(stop)
    return proc, time.perf_counter()


def finish_dryrun(proc_t0) -> dict:
    """Waits for the background dry run; prints one line a cell (dominant
    term, its seconds, per-device GiB), the production-cell table and the
    total seconds.  Fails unless every reference cell on both meshes was
    counted or skipped as the reference skips it."""
    from repro_torch.launch.dryrun import device_gib

    proc, t0 = proc_t0
    try:
        proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        fail("distributed: the dry run did not finish in 600 s more")
    lines = DRYRUN_LOG.read_text().splitlines()
    cells = [ln for ln in lines if ln.startswith("[")]
    for ln in cells:
        print("dryrun " + ln, flush=True)
    total = next((ln for ln in lines if ln.startswith("dry run:")), "")
    print(f"distributed: {total} ({DRYRUN_WORKERS} niced worker processes "
          f"beside the earlier phases; {time.perf_counter() - t0:.1f} s "
          "from its start to the end of the wait)", flush=True)
    recs = [json.loads(p.read_text()) for p in sorted(
        (ROOT / "chiprun_out" / "dryrun").glob("*.json"))]
    ok = [r for r in recs if r["status"] == "ok"]
    skip = [r for r in recs if r["status"] == "skip"]
    if proc.returncode != 0 or len(recs) != 80 or len(ok) != 62 \
            or len(skip) != 18:
        fail(f"distributed: dry run rc {proc.returncode}, {len(ok)} cells "
             f"counted and {len(skip)} skipped of {len(recs)} (want 62 and "
             "18 of 80)")
    return {"cells": len(ok), "skipped": len(skip), "summary": total,
            "table": [{"arch": r["arch"], "shape": r["shape"],
                       "mesh": r["mesh"],
                       "dominant": r["roofline"]["dominant"],
                       "seconds": r["roofline"][
                           r["roofline"]["dominant"] + "_s"],
                       "per_device_gib": device_gib(r),
                       "useful_flops_ratio": r["useful_flops_ratio"]}
                      for r in ok]}


def timed_step(torch, step, state, batch):
    """(new state, loss, wall ms, device ms) of one training step."""
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev0.record()
    state, m = step(state, batch)
    ev1.record()
    loss = float(m["loss"])
    torch.cuda.synchronize()
    return (state, loss, (time.perf_counter() - t0) * 1e3,
            ev0.elapsed_time(ev1))


def tree_gap(torch, a, b) -> float:
    """Largest absolute difference of two trees' tensors, leaf by path."""
    from repro_torch.optim.adamw import tree_map

    got = {}
    tree_map(lambda path, t: got.__setitem__(path, t), a)
    gaps = []
    tree_map(lambda path, t: gaps.append(float(
        (got[path].float() - t.float()).abs().max())) if torch.is_tensor(t)
        else None, b)
    return max(gaps)


def run_distributed_phase(torch, dev, keep: dict, dryrun) -> dict:
    """The "distributed" phase, over an NCCL process group of one rank
    (``file://`` init; no gloo, no CPU fallback) and a (1, 1) ("data",
    "model") mesh on the card:

    - expert parallelism: the moe phase's full-width deepseek-v2-lite-16b
      packs through the engine with ``moe_impl="ep_psum"`` and ``mesh=``
      on the same trace: tokens and approx-matmul launches equal the
      phase's local run's, one NCCL all-reduce a MoE layer a call;
    - the sharded training step: olmo-1b at full width and DIST_LAYERS
      layers in bf16 with ``fsdp`` and ``sequence_parallel`` on (1, 1),
      then ``dp_only`` on a (1,) mesh, DIST_STEPS steps each against the
      unsharded step on the same batches: losses and parameters bit-equal,
      each step's wall and device ms;
    - the overlap collectives: ``rs_matmul_overlapped`` at an olmo-1b
      layer's (4096, 2048) x (2048, 8192) and ``compressed_psum`` of the
      sharded step's gradients, each bit-equal to its plain form;
    - re-mesh: the sharded training state saved under (1, 1) (codec none,
      a temporary directory under build/) and restored under (1,),
      bit-equal;
    - the dry run (``finish_dryrun``).
    The process group is destroyed before the later phases run.  Returns
    the launches by path."""
    import dataclasses
    import gc
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager, restore_with_sharding
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticLMConfig, lm_batch
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.train import (TrainConfig, init_train_state,
                                          make_train_step,
                                          train_state_shardings)
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import tree_map
    from repro_torch.parallel import comm
    from repro_torch.parallel.sharding import tree_gather, tree_shard
    from repro_torch.runtime.overlap import (compressed_psum,
                                             rs_matmul_overlapped)

    t_phase = time.perf_counter()
    label = "distributed"
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    pg_dir = tempfile.mkdtemp(dir=build, prefix="dist_")
    dist.init_process_group("nccl", init_method=f"file://{pg_dir}/pg",
                            rank=0, world_size=1)
    out, line = {}, {}
    try:
        mesh = make_test_mesh((1, 1), ("data", "model"), device="cuda")
        print(f"{label}: {dist.get_backend()} process group of "
              f"{dist.get_world_size()} rank; mesh {mesh}", flush=True)

        # -- expert parallelism through the engine ------------------------
        cfg = dataclasses.replace(keep["cfg"], moe_impl="ep_psum")
        packed, ecfg = keep.pop("packed"), keep["ecfg"]
        api = build_model(cfg, dev)
        calls = []
        counting = dataclasses.replace(api, decode_slots=lambda *a, **kw: (
            calls.append(1), api.decode_slots(*a, **kw))[1])
        warm_up(torch, api, packed, ecfg)
        comm.reset_counts()
        t0 = time.perf_counter()
        run = engine_run(torch, f"{label}: ep {cfg.name}", cfg, counting,
                         packed, ecfg, keep["trace"], keep["per_call"],
                         keep["numerics"], engine_kw={"mesh": mesh})
        ep_s = time.perf_counter() - t0
        tokens = [list(r.generated) for r in run["reqs"]]
        moe_layers = cfg.n_layers - cfg.first_dense_layers
        all_reduces = comm.COUNTS["all-reduce"]
        print(f"{label}: ep {cfg.name} (moe_impl=ep_psum, mesh (1, 1)): "
              f"{len(tokens)} requests, serving loop {run['wall_s']:.3f} s "
              f"(the local run's {keep['wall_s']:.3f} s), tokens equal the "
              f"local run's: {tokens == keep['tokens']}; approx launches "
              f"{run['launches']} (local {keep['launches']}); NCCL "
              f"all-reduces {all_reduces} = {moe_layers} MoE layers x "
              f"{len(calls)} calls: {all_reduces == moe_layers * len(calls)}"
              f"; collectives {dict(comm.COUNTS)}", flush=True)
        if tokens != keep["tokens"]:
            fail(f"{label}: EP tokens differ from the local run's")
        if run["launches"] != keep["launches"]:
            fail(f"{label}: EP launches {run['launches']} != local "
                 f"{keep['launches']}")
        if all_reduces != moe_layers * len(calls) or set(comm.COUNTS) != {
                "all-reduce"}:
            fail(f"{label}: collectives {dict(comm.COUNTS)}, want "
                 f"{moe_layers} all-reduces a call x {len(calls)}")
        out[f"ep {cfg.name}"] = run["launches"]
        line["ep"] = {"arch": cfg.name, "requests": len(tokens),
                      "seconds": ep_s, "loop_s": run["wall_s"],
                      "local_loop_s": keep["wall_s"], "calls": len(calls),
                      "all_reduces": all_reduces,
                      "launches": run["launches"],
                      "snapshot": served_metrics(run["snap"])}
        del run, packed, api, counting
        gc.collect()
        torch.cuda.empty_cache()

        # -- the sharded training step ------------------------------------
        tcfg = TrainConfig(fsdp=True, base_lr=1e-3, warmup_steps=0,
                           total_steps=100)
        tcfg_dp = dataclasses.replace(tcfg, fsdp=False)
        cfg = dataclasses.replace(get_config(DIST_ARCH),
                                  n_layers=DIST_LAYERS,
                                  sequence_parallel=True)
        dcfg = SyntheticLMConfig(vocab=cfg.vocab, seq_len=DIST_T,
                                 batch=DIST_B)
        batches = [lm_batch(dcfg, i) for i in range(DIST_STEPS)]
        init = init_train_state(cfg, tcfg, seed=0, device=dev)
        plain = make_train_step(cfg, tcfg, device=dev)
        timed_step(torch, plain, init, batches[0])  # warm-up, discarded
        state, ref_losses, ref_ms = init, [], []
        for b in batches:
            state, loss, wall, gpu = timed_step(torch, plain, state, b)
            ref_losses.append(loss)
            ref_ms.append({"wall_ms": wall, "device_ms": gpu})
        ref_state = state
        mesh1 = make_test_mesh((1,), ("data",), device="cuda")
        runs = {}
        for name, m, tc, dp_only in (("fsdp+sp (1, 1)", mesh, tcfg, False),
                                     ("dp_only (1,)", mesh1, tcfg_dp, True)):
            sh = train_state_shardings(cfg, tc, m, dp_only=dp_only)
            local = tree_shard(init, sh, m)
            step = make_train_step(cfg, tc, device=dev, mesh=m,
                                   param_sh=sh["params"], dp_only=dp_only)
            comm.reset_counts()
            losses, ms = [], []
            for b in batches:
                local, loss, wall, gpu = timed_step(torch, step, local, b)
                losses.append(loss)
                ms.append({"wall_ms": wall, "device_ms": gpu})
            colls = {k: (v, comm.BYTES[k]) for k, v in comm.COUNTS.items()}
            full = tree_gather(local, sh, m)
            gap = max(abs(a - b_) / abs(b_) for a, b_ in zip(losses,
                                                              ref_losses))
            pgap = tree_gap(torch, full, ref_state)
            print(f"{label}: train {cfg.name} {DIST_LAYERS} layers bf16 "
                  f"B={DIST_B} T={DIST_T}, {name}: losses {losses} vs "
                  f"unsharded {ref_losses}: largest relative gap {gap} and "
                  f"largest parameter/moment gap {pgap} (gate: bit-equal, "
                  f"0); wall/device ms a step {ms} vs unsharded {ref_ms}; "
                  f"collectives (count, bytes) over {DIST_STEPS} steps "
                  f"{colls}", flush=True)
            if gap != 0 or pgap != 0:
                fail(f"{label}: the {name} step leaves the unsharded one "
                     f"(loss gap {gap}, state gap {pgap})")
            runs[name] = {"losses": losses, "ms": ms, "loss_gap": gap,
                          "state_gap": pgap, "collectives": colls}
            if not dp_only:
                sharded = (local, sh, step)
        line["train"] = {"arch": cfg.name, "layers": DIST_LAYERS,
                         "batch": DIST_B, "seq": DIST_T,
                         "unsharded_losses": ref_losses,
                         "unsharded_ms": ref_ms, "runs": runs}

        # -- the overlap collectives --------------------------------------
        local, sh, step = sharded
        gen = torch.Generator(device=dev).manual_seed(11)
        x = torch.randn(OVERLAP_M, OVERLAP_K, generator=gen,
                        device=dev).to(torch.bfloat16)
        w = torch.randn(OVERLAP_K, OVERLAP_N, generator=gen,
                        device=dev).to(torch.bfloat16)
        world = mesh.group(mesh.axis_names)

        def plain_mm():
            y = torch.matmul(x.float(), w.float())
            return comm.all_reduce(y, mesh.group(("model",))).to(x.dtype)

        y = rs_matmul_overlapped(x, w, mesh, "model")
        y_plain = plain_mm()
        mm_ms = time_calls(torch, [lambda: rs_matmul_overlapped(
            x, w, mesh, "model")], reps=5) * 1e3
        plain_ms = time_calls(torch, [plain_mm], reps=5) * 1e3
        _, grads = step.grads(local["params"], batches[0])
        t0 = time.perf_counter()
        psum = compressed_psum(grads, mesh, "data")
        torch.cuda.synchronize()
        psum_ms = (time.perf_counter() - t0) * 1e3

        def dequant(_, g):
            g32 = g.float()
            scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
            q = torch.clip(torch.round(g32 / scale), -127, 127)
            return (q.to(torch.int8).float() * scale).to(g.dtype)

        want = tree_map(dequant, grads)
        mm_eq = torch.equal(y, y_plain)
        psum_gap = tree_gap(torch, psum, want)
        print(f"{label}: rs_matmul_overlapped ({OVERLAP_M}, {OVERLAP_K}) x "
              f"({OVERLAP_K}, {OVERLAP_N}) bf16 on (1, 1): bit-equal to the "
              f"plain matmul + all-reduce: {mm_eq}; {mm_ms:.3f} ms against "
              f"{plain_ms:.3f} (device, CUDA graph); compressed_psum of the "
              f"sharded step's gradient tree: largest gap "
              f"to the plain int8 round trip {psum_gap} (gate: 0), "
              f"{psum_ms:.1f} wall ms", flush=True)
        if not mm_eq or psum_gap != 0:
            fail(f"{label}: an overlap collective leaves its plain form")
        line["overlap"] = {"rs_matmul_ms": mm_ms, "plain_ms": plain_ms,
                           "bit_equal": mm_eq, "compressed_psum_gap":
                           psum_gap, "compressed_psum_wall_ms": psum_ms}
        del x, w, y, y_plain, grads, psum, want

        # -- re-mesh: save under (1, 1), restore under (1,) ---------------
        ck = tempfile.mkdtemp(dir=build, prefix="remesh_")
        try:
            full = tree_gather(local, sh, mesh)
            t0 = time.perf_counter()
            CheckpointManager(ck, codec="none").save(local, DIST_STEPS,
                                                     shardings=sh, mesh=mesh)
            save_s = time.perf_counter() - t0
            sh_b = train_state_shardings(cfg, tcfg, mesh1)
            template = init_train_state(cfg, tcfg, seed=0, device="meta")
            t0 = time.perf_counter()
            restored, at = restore_with_sharding(
                CheckpointManager(ck), template, sh_b, mesh=mesh1)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            want = tree_shard(full, sh_b, mesh1)
            rgap = tree_gap(torch, restored, want)
            nbytes = sum(os.path.getsize(os.path.join(dp, f))
                         for dp, _, fs in os.walk(ck) for f in fs)
        finally:
            shutil.rmtree(ck, ignore_errors=True)
        print(f"{label}: re-mesh: the sharded state saved under (1, 1) "
              f"({nbytes / 1e9:.3f} GB, codec none, {save_s:.2f} s) and "
              f"restored under (1,) ({restore_s:.2f} s) at step {at}: "
              f"largest gap {rgap} (gate: bit-equal, 0)", flush=True)
        if rgap != 0 or at != DIST_STEPS:
            fail(f"{label}: the re-mesh restore is not bit-equal")
        line["remesh"] = {"gb": nbytes / 1e9, "save_s": save_s,
                          "restore_s": restore_s, "gap": rgap}
        del local, full, restored, want, init, state, ref_state, sharded
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(pg_dir, ignore_errors=True)
    line["dryrun"] = finish_dryrun(dryrun)
    line["seconds"] = time.perf_counter() - t_phase
    print(f"{label}: phase {line['seconds']:.1f} s (the dry run's wait "
          "included)", flush=True)
    write_line(label, "distributed.json", line)
    return out



def cnn_net(torch, dev, name: str, classes: int = 10):
    """(cfg, seeded float params on the card, their float plan) of one
    CNN_SUITE net at full width (torch.Generator seed 0)."""
    from repro_torch.configs.cnn_suite import get_cnn
    from repro_torch.nn.cnn import init_cnn
    from repro_torch.numerics import uniform_spec

    cfg = get_cnn(name, classes)
    params = init_cnn(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                      device=dev)
    return cfg, params, uniform_spec(None).resolve(params)


def cnn_kn(torch, dev) -> list[tuple[int, int]]:
    """Every (K, N) of the CNN suite's convs and fcs, at 10 and 100
    classes."""
    from repro_torch.configs.cnn_suite import CNN_SUITE

    return sorted({e.w_shape for name in CNN_SUITE for classes in (10, 100)
                   for e in cnn_net(torch, dev, name, classes)[2].entries})


@contextlib.contextmanager
def recorded_calls(calls: list):
    """Appends (M, K, N) of every approx-matmul kernel call inside the block
    to ``calls``.  The kernel still runs; its launches are counted on the
    recorder (the wrapper counts under its module name), so no counted run
    may hold this block."""
    from repro_torch.kernels import approx_matmul as amk

    kern = amk.approx_matmul_cv_fused

    def rec(x, *a, **kw):
        calls.append((x.shape[0], kw["k"], kw["n"]))
        return kern(x, *a, **kw)

    rec.launches = 0
    amk.approx_matmul_cv_fused = rec
    try:
        yield
    finally:
        amk.approx_matmul_cv_fused = kern


def conv_time(torch, dev, card: str, mm: int, k: int, n: int) -> dict:
    """One conv-shaped approx call, float32 in and out: the kernel (the
    route it takes) at perforated m=2 + CV, its plain version, float32
    ``torch.matmul`` (TF32 off) at the same (M, K, N), and the bound; and
    the kernel at truncated m=7 (eight products a code, the most of any
    mode) beside its own bound.  The activations (M x K float32, hundreds of
    MB at B = 250) exceed the 50 MB L2, so one operand copy serves every
    replay, as the path reads them."""
    from repro_torch.kernels import approx_matmul as amk

    gen = torch.Generator(device=dev).manual_seed(2)
    _, _, b = random_pack(torch, k, n, "perforated", 2, gen, dev)
    _, _, b7 = random_pack(torch, k, n, "truncated", 7, gen, dev)
    x = torch.randn(mm, k, generator=gen, device=dev)
    w = torch.randn(k, n, generator=gen, device=dev)
    args = (x, b.w_qbt, b.epilogue, b.meta)
    kw = dict(k=k, n=n, mode="perforated", m=2)
    bound, by = approx_bound(mm, k, n, b.w_qbt.numel(), b.epilogue.numel(),
                             b.meta.numel(), 4, 4, card)
    bound7, by7 = approx_bound(mm, k, n, b7.w_qbt.numel(),
                               b7.epilogue.numel(), b7.meta.numel(), 4, 4,
                               card, "truncated", 7)
    return {
        "M": mm, "K": k, "N": n, "route": amk.tile(mm, k, n, "perforated", 2),
        "kernel_us": time_calls(torch, [
            lambda: amk.approx_matmul_cv_fused(*args, **kw)] * 3) * 1e6,
        "plain_us": time_calls(torch, [
            lambda: amk.approx_matmul_cv_fused_plain(*args, **kw)],
            reps=3) * 1e6,
        "library_us": time_calls(torch, [lambda: torch.matmul(x, w)] * 3)
        * 1e6,
        "library": "float32 torch.matmul, TF32 off",
        "bound_us": bound * 1e6, "bound_by": by,
        "truncated7_us": time_calls(torch, [
            lambda: amk.approx_matmul_cv_fused(
                x, b7.w_qbt, b7.epilogue, b7.meta, k=k, n=n,
                mode="truncated", m=7)] * 3) * 1e6,
        "truncated7_bound_us": bound7 * 1e6, "truncated7_bound_by": by7}


def check_conv_launches(label: str, prof: dict, calls: list,
                        forwards: int) -> None:
    """Each approx call of ``forwards`` profiled forwards (one forward's
    (M, K, N) calls in ``calls``) launched what its route launches: a
    conv-shaped call one conv kernel and no prep kernel, a decode-shaped
    one one split-K kernel, any other the prep kernel and one wgmma tile.
    The source's own launch counts must equal that exactly; the trace,
    which can drop a record at its window's edge but shows no kernel that
    did not run, must hold no other kernel and no more launches."""
    from repro_torch.kernels import approx_matmul as amk

    want: dict[str, int] = {}
    for mm, k, n in calls:
        route = amk.tile(mm, k, n, "perforated", 2)
        kerns = (("am_conv_kernel",) if route == "conv" else
                 ("am_splitk_kernel",) if route == "split_k" else
                 ("prep_kernel", "am_wgmma_kernel"))
        for kern in kerns:
            want[kern] = want.get(kern, 0) + forwards
    counted, traced = prof["counted_launches"], prof["approx_launches"]
    if counted != want or any(v > want.get(k, 0) for k, v in traced.items()):
        fail(f"{label}: the profiled forwards launched {counted} (traced "
             f"{traced}), want {want} (one conv launch a conv-shaped call, "
             "no prep kernel)")
    print(f"{label}: {prof['fused_calls']} approx calls in {forwards} "
          f"profiled forwards, CUDA launches {counted} (traced {traced}): "
          "one a conv-shaped call, no prep kernel", flush=True)


def run_cnn_net(torch, dev, card: str, name: str, data: dict) -> dict:
    """Phase 6, one net: calibration on CNN_CALIB train images, one pack
    per 10-class paper-grid point with the CV on and off, each evaluated on
    the CNN_TEST test images in batches of CNN_BATCH (launches counted); the
    relative logit error and top-1 agreement against the float model, the
    modelled power saving, the ``int8`` preset's error; kernel-path logits
    bit-equal to the plain version's at one point per mode, CV on and off;
    one point per mode at 100 classes; a profiled B = CNN_BATCH forward and
    the timing of its largest approx call."""
    from repro_torch.core.approx_linear import (iter_tensors,
                                                packed_layer_paths)
    from repro_torch.core.cost_model import power_saving
    from repro_torch.kernels import approx_matmul as amk
    from repro_torch.nn.cnn import cnn_apply
    from repro_torch.numerics import (apply_numerics, get_preset,
                                      paper_grid_specs)
    from repro_torch.quant.observers import CalibrationRecorder

    label = f"cnn {name}"
    grid = {cv: paper_grid_specs(use_cv=cv, backend="pallas")
            for cv in (True, False)}
    out = {"launches": {}, "c10": [], "c100": []}

    def add(launches):
        for key, v in launches.items():
            out["launches"][key] = out["launches"].get(key, 0) + v

    def calibrated(classes):
        cfg, params, plan = cnn_net(torch, dev, name, classes)
        paths = sorted(e.path for e in plan.entries)
        if len(paths) != CNN_LAYERS[name]:
            fail(f"{label}: {len(paths)} layers, want {CNN_LAYERS[name]}")
        calib, test = data[classes]
        with CalibrationRecorder() as rec:
            cnn_apply(params, calib, cfg)
        ranges = rec.ranges()
        if sorted(ranges) != paths:
            fail(f"{label}: calibration paths {sorted(ranges)[:4]} are not "
                 f"the layer paths {paths[:4]}")

        def logits(p, x=test):
            return torch.cat([cnn_apply(p, x[i:i + CNN_BATCH], cfg)
                              for i in range(0, x.shape[0], CNN_BATCH)])

        def pack(spec):
            packed = apply_numerics(params, spec.resolve(params),
                                    act_ranges=ranges)
            if packed_layer_paths(packed) != paths:
                fail(f"{label}: {spec.name} packed "
                     f"{len(packed_layer_paths(packed))} of {len(paths)} "
                     "layers")
            check_packs(label, packed)
            return packed

        y_float = logits(params)
        if not bool(torch.isfinite(y_float).all()):
            fail(f"{label}: float logits not finite")
        return cfg, paths, test, logits, pack, y_float, params, ranges

    def sweep(classes, points, pack, logits, paths, y_float):
        packs = {(i, cv): pack(grid[cv][i]) for i in points
                 for cv in (True, False)}
        logits(packs[(points[0], True)])  # warm-up, not counted
        torch.cuda.synchronize()
        n_fwd = len(packs) * (CNN_TEST // CNN_BATCH)
        ys, wall, launches, _ = counted_run(
            torch, f"{label} c{classes}",
            lambda: {key: logits(p) for key, p in packs.items()},
            {"approx_matmul_cv_fused": n_fwd * len(paths)},
            f"{len(packs)} packs x {CNN_TEST // CNN_BATCH} batches x "
            f"{len(paths)} layers")
        add(launches)
        yn = y_float.norm()
        top = y_float.argmax(-1)
        rows = []
        for i in points:
            pol = grid[True][i].default
            row = {"mode": pol.mode, "m": pol.m,
                   "power_saving_pct": power_saving(pol.mode, pol.m, 64)}
            for cv, tag in ((True, "cv"), (False, "no_cv")):
                y = ys[(i, cv)]
                if not bool(torch.isfinite(y).all()):
                    fail(f"{label}: {grid[cv][i].name} logits not finite")
                row[f"rel_err_{tag}"] = float((y - y_float).norm() / yn)
                row[f"top1_agree_{tag}"] = float(
                    (y.argmax(-1) == top).float().mean())
            row["err_ratio_no_cv_over_cv"] = (row["rel_err_no_cv"]
                                              / row["rel_err_cv"])
            rows.append(row)
            print(f"{label} c{classes} {pol.mode}(m={pol.m}): rel logit err "
                  f"cv {row['rel_err_cv']:.5f} no-cv {row['rel_err_no_cv']:.5f}"
                  f" (ratio {row['err_ratio_no_cv_over_cv']:.3f}); top-1 "
                  f"agreement cv {row['top1_agree_cv']:.3f} no-cv "
                  f"{row['top1_agree_no_cv']:.3f}; modelled power saving "
                  f"{row['power_saving_pct']:.2f}% (N=64)", flush=True)
        return packs, ys, wall, rows

    t0 = time.perf_counter()
    cfg, paths, test, logits, pack, y_float, params, ranges = calibrated(10)
    packs, ys, wall, out["c10"] = sweep(10, list(range(len(grid[True]))),
                                        pack, logits, paths, y_float)
    x0 = test[:CNN_BATCH]
    # the exact baseline: the int8 preset (no kernel: folded float32 GEMMs
    # at fan-ins up to 258, the plain exact-integer product above)
    pack8 = pack(get_preset("int8"))
    y8, *_ = counted_run(torch, f"{label} int8", lambda: logits(pack8), {},
                         "the int8 preset (no kernel)")
    del pack8
    out["int8_rel_err"] = float((y8 - y_float).norm() / y_float.norm())
    out["int8_top1_agree"] = float(
        (y8.argmax(-1) == y_float.argmax(-1)).float().mean())
    # determinism, and the kernel path against the plain version on the card
    key = (CNN_POINTS[0], True)
    if not torch.equal(cnn_apply(packs[key], x0, cfg), ys[key][:CNN_BATCH]):
        fail(f"{label}: two identical forwards gave different logits")
    for i in CNN_POINTS:
        for cv in (True, False):
            with plain_swapped(label, [(amk, "approx_matmul_cv_fused",
                                        amk.approx_matmul_cv_fused_plain)]):
                yp = cnn_apply(packs[(i, cv)], x0, cfg)
            if not torch.equal(yp, ys[(i, cv)][:CNN_BATCH]):
                fail(f"{label}: {grid[cv][i].name} kernel-path logits differ "
                     "from the plain version's: max "
                     f"{float((yp - ys[(i, cv)][:CNN_BATCH]).abs().max())}")
    print(f"{label}: int8 preset rel logit err {out['int8_rel_err']:.5f}, "
          f"top-1 agreement {out['int8_top1_agree']:.3f}; kernel-path "
          f"logits bit-equal to the plain version's at {len(CNN_POINTS)} "
          f"points x CV on/off (B={CNN_BATCH}); two forwards bit-equal",
          flush=True)

    out["folds"] = cnn_fold_points(torch, label, cfg, params, ranges, logits,
                                   y_float, out["c10"], x0)

    # the profiled forward and its largest approx call
    fwd = packs[key]
    calls: list = []
    with recorded_calls(calls):
        cnn_apply(fwd, x0, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cnn_apply(fwd, x0, cfg)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    prof = profile_fn(torch, f"{label}: profile B={CNN_BATCH} forward",
                      lambda: cnn_apply(fwd, x0, cfg),
                      f"host_profile_cnn_{name}.txt")
    if prof["fused_calls"] != 3 * len(paths):
        fail(f"{label}: the profiled forwards made {prof['fused_calls']} "
             f"approx calls, want {3 * len(paths)}")
    check_conv_launches(label, prof, calls, 3)
    big = max(calls, key=lambda c: c[0] * c[1] * c[2])
    row = {"net": name, **conv_time(torch, dev, card, *big),
           "calls_per_forward": calls.count(big)}
    print("time " + json.dumps(row), flush=True)
    # the first layer's call (fan-in 3 x 3 x 3 = 27) and the calls the
    # rule leaves on prep + tile (vgg's two widest), beside float32 matmul
    others = []
    for c in sorted({c for c in calls if c[1] == 27 or amk._takes_prep(*c)}
                    - {big}):
        others.append({"net": name, **conv_time(torch, dev, card, *c),
                       "calls_per_forward": calls.count(c)})
        print("time " + json.dumps(others[-1]), flush=True)

    # one point per mode at 100 classes
    del packs, ys
    _, paths100, _, logits100, pack100, yf100, *_ = calibrated(100)
    _, _, _, out["c100"] = sweep(100, list(CNN_POINTS), pack100, logits100,
                                 paths100, yf100)
    write_line(label, f"cnn_{name}.json", {
        "net": name, "family": cfg.family, "width": cfg.width,
        "depth": cfg.depth, "layers": len(paths), "batch": CNN_BATCH,
        "sweep_s": wall, "phase_s": time.perf_counter() - t0,
        "pack_gib": storage_gib(iter_tensors(fwd)),
        "peak_mem_gib": peak / 2**30, "forward": prof, "largest_call": row,
        "other_calls": others, "calls": sorted(set(calls)), **out})
    out["largest_call"], out["other_calls"] = row, others
    return out


#: the fold phase's tolerances, per net and grid point (CV on): the folded
#: logits' distance to the exact-integer path's (``fold=False``) at most
#: FOLD_GAP_MAX of that path's own distance to the float model (the
#: quantization error), and the folded sweep's relative logit error within
#: FOLD_ERR_RTOL of the kernel sweep's at the same point.  Per layer the
#: fold agrees with the integer path to float32 rounding; an activation
#: code that rounds the other way is then carried through every later
#: layer, and a CPU rehearsal at full width (100 images) measured gaps of
#: 0.03-0.32 of the quantization error (largest at recursive m=3, whose
#: error is smallest) and errors within 0.8% of the kernel sweep's
FOLD_GAP_MAX, FOLD_ERR_RTOL = 0.5, 0.05


def cnn_fold_points(torch, label: str, cfg, params, ranges, logits, y_float,
                    rows: list, x0) -> list:
    """Phase 6, folds and grouped CV: one point per mode of
    ``paper_grid_specs(backend="jnp")`` (the reference's default), CV on,
    packed three ways from the phase's calibration: with the folded
    float32 operands (every layer of fan-in up to 258), with ``fold=False``
    (the plain exact-integer product), and with grouped CV (4 groups where
    the fan-in divides, single-C elsewhere).  Fails unless the folds are
    where ``build_fold`` puts them, their bytes and each pack's bytes equal
    the plan's, no kernel launches, and the folded logits are within the
    FOLD_* tolerances.  Prints each pack's relative logit error beside the
    kernel sweep's, and profiles a B = CNN_BATCH forward of the folded and
    of the ``fold=False`` packs (first point only)."""
    import dataclasses

    from repro_torch.core.approx_linear import QuantizedDense, pack_params
    from repro_torch.core.multipliers import _F32_EXACT_K
    from repro_torch.nn.cnn import cnn_apply
    from repro_torch.numerics import apply_numerics, paper_grid_specs
    from repro_torch.numerics.plan import _fold_bytes

    grid = paper_grid_specs(use_cv=True)  # backend "jnp"
    yn = y_float.norm()
    res = []
    for i in CNN_POINTS:
        spec = grid[i]
        pol = spec.default
        plan = spec.resolve(params)
        fan_in = {e.path: e.w_shape[-2] for e in plan.entries}
        folded = apply_numerics(params, plan, act_ranges=ranges)
        exact = apply_numerics(params, plan, act_ranges=ranges, fold=False)
        grouped = pack_params(params, lambda path: dataclasses.replace(
            pol, groups=4 if fan_in["/".join(path)] % 4 == 0 else 1),
            act_ranges=ranges)
        mods = [m for m in modules(folded) if isinstance(m, QuantizedDense)]
        if any((m.fold is not None) != (m.w_q.shape[0] <= _F32_EXACT_K)
               for m in mods):
            fail(f"{label}: {spec.name} folds missing or misplaced")
        fold_b = sum(m.fold[key].numel() * 4 for m in mods if m.fold
                     for key in ("A", "B", "delta") if key in m.fold)
        plan_fold_b = sum(_fold_bytes(e.w_shape[-2], e.w_shape[-1], e.policy)
                          for e in plan.packed)
        pack_b = sum(b.numel() * b.element_size() for m in mods
                     for b in m.buffers() if b is not None and b.ndim)
        if fold_b != plan_fold_b or pack_b != sum(e.packed_bytes
                                                  for e in plan.packed):
            fail(f"{label}: {spec.name} fold bytes {fold_b} (plan "
                 f"{plan_fold_b}), pack bytes {pack_b} (plan "
                 f"{sum(e.packed_bytes for e in plan.packed)})")
        n_grouped = sum(m.c.ndim == 2 for m in modules(grouped)
                        if isinstance(m, QuantizedDense))
        (y_f, y_e, y_g), *_ = counted_run(
            torch, f"{label} folds {pol.mode}(m={pol.m})",
            lambda: (logits(folded), logits(exact), logits(grouped)), {},
            "folded, exact-integer and grouped-CV packs (no kernel)")
        err = {tag: float((y - y_float).norm() / yn)
               for tag, y in (("fold", y_f), ("exact", y_e), ("grouped", y_g))}
        gap = float((y_f - y_e).norm() / (y_e - y_float).norm())
        err_kernel = rows[i]["rel_err_cv"]
        row = {"mode": pol.mode, "m": pol.m, "rel_err_fold": err["fold"],
               "rel_err_exact_integer": err["exact"],
               "rel_err_kernel": err_kernel,
               "rel_err_grouped4": err["grouped"],
               "grouped_layers": n_grouped, "layers": len(mods),
               "fold_gap_over_quant_err": gap,
               "top1_fold_vs_exact": float(
                   (y_f.argmax(-1) == y_e.argmax(-1)).float().mean()),
               "fold_bytes": fold_b, "pack_bytes": pack_b}
        print(f"{label} folds {pol.mode}(m={pol.m}): rel logit err folded "
              f"{err['fold']:.5f}, exact-integer {err['exact']:.5f}, kernel "
              f"sweep {err_kernel:.5f}, grouped CV (g=4 on {n_grouped} of "
              f"{len(mods)} layers) {err['grouped']:.5f}; folded-vs-integer "
              f"gap {gap:.3g} of the quantization error; fold bytes "
              f"{fold_b:,} = the plan's", flush=True)
        if gap > FOLD_GAP_MAX or abs(err["fold"] - err_kernel) \
                > FOLD_ERR_RTOL * err_kernel:
            fail(f"{label}: {spec.name} folded logits outside the "
                 f"tolerance: gap {gap:.3g} (max {FOLD_GAP_MAX}), error "
                 f"{err['fold']:.5f} against the kernel sweep's "
                 f"{err_kernel:.5f} (rtol {FOLD_ERR_RTOL})")
        if not res:
            for key, tree, what in (("forward", folded, "folded"),
                                    ("forward_exact_integer", exact,
                                     "fold=False")):
                row[key] = profile_fn(
                    torch, f"{label}: profile {what} B={CNN_BATCH} forward",
                    lambda tree=tree: cnn_apply(tree, x0, cfg),
                    f"host_profile_{label.replace(' ', '_')}_{key}.txt")
        res.append(row)
    return res


def run_cnn_suite(torch, dev, card: str) -> dict:
    """Phase 6: the paper's six CNNs (CNN_SUITE) at full width, seeded
    float weights, on ``backend: "pallas"`` packs of every paper-grid point.
    Returns each net's result (``run_cnn_net``)."""
    from repro_torch.configs.cnn_suite import CNN_SUITE
    from repro_torch.data.vision import VisionConfig, make_vision_dataset

    t0 = time.perf_counter()
    data = {}
    for classes in (10, 100):
        vcfg = VisionConfig(num_classes=classes)
        data[classes] = tuple(
            torch.from_numpy(make_vision_dataset(vcfg, split, n)[0]).to(dev)
            for split, n in (("train", CNN_CALIB), ("test", CNN_TEST)))
    print(f"cnn: procedural data {time.perf_counter() - t0:.1f} s: "
          f"{CNN_CALIB} calibration and {CNN_TEST} test images (32 x 32 x 3) "
          "at 10 and 100 classes", flush=True)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the depthwise convs
    try:
        res = {}
        for name in CNN_SUITE:
            res[name] = run_cnn_net(torch, dev, card, name, data)
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return res


def teacher_forced(torch, label: str, mod, run) -> list[float]:
    """Each layer's attention (or WKV) in the kernel path's own prefill,
    fed that layer's input as the kernel path made it, once through the
    kernel and once through its plain version: the per-layer gap cannot
    compound across layers.  Fails (``close``) if any layer's gap is
    outside the kernel's per-call tolerance (flash: FLASH_RTOL, each row to
    its own scale; scan: SCAN_RTOL on the output and the final state).
    The model goes on with the kernel's output.  Returns each layer's max
    abs error and the (last dim, causal flag) of the calls."""
    name = "rwkv6_scan" if hasattr(mod, "rwkv6_scan") else "flash_attention"
    kern, plain = getattr(mod, name), getattr(mod, f"{name}_plain")
    gaps, calls = [], set()

    def both(*a, **kw):
        calls.add((a[0].shape[-1], kw.get("causal")))
        got, want = kern(*a, **kw), plain(*a, **kw)
        if name == "rwkv6_scan":
            gaps.append(max(close(torch, g, w, SCAN_RTOL)
                            for g, w in zip(got, want)))
        else:
            gaps.append(close(torch, got, want,
                              FLASH_RTOL[str(got.dtype).split(".")[-1]],
                              per_row=True))
        return got

    both.launches = 0  # the kernel counts its launches under the module name
    setattr(mod, name, both)
    try:
        run()
    finally:
        setattr(mod, name, kern)
    torch.cuda.synchronize()
    if not gaps:
        fail(f"{label}: the prefill never called {name}")
    worst = max(range(len(gaps)), key=gaps.__getitem__)
    print(f"{label}: teacher-forced per-layer {name} against its plain "
          f"version on the kernel path's own layer inputs, {len(gaps)} layers:"
          f" every layer within the per-call tolerance; largest max abs err "
          f"{gaps[worst]:.4g} (layer {worst}); by layer "
          f"{[float(f'{g:.3g}') for g in gaps]}", flush=True)
    return gaps, calls


# ---------------------------------------------------------------------------
# the paper's own evaluation
# ---------------------------------------------------------------------------

#: the paper phase's bounds: the conv-error bench's Eq. 20 variance
#: prediction (tests/test_control_variate.py::test_eq20_variance_prediction);
#: a trained net's float test accuracy at least PAPER_CHANCE_X times chance;
#: the kernel path's top-1 predictions against the ``backend: "jnp"``
#: pack's on the 1,000 test images, for a net that trained (both evaluate
#: the same integer products; an activation code that rounds the other way
#: after a float ulp may flip a near-tie, and a collapsed net's outputs
#: are all near-ties: its agreement is printed only)
PAPER_EQ20_MAX, PAPER_CHANCE_X, PAPER_TOP1_MIN = 0.1, 2.0, 0.99
#: the card's training path against the host's: the first PAPER_SGD_STEPS
#: steps of the recipe from the same initial weights, every loss within
#: PAPER_SGD_RTOL (float32 sums in other orders; the CPU tests hold the
#: recipe against the reference's over 20 steps to 1e-3)
PAPER_SGD_STEPS, PAPER_SGD_RTOL = 5, 1e-3
#: the reference's recipe (BN as a plain affine, so nothing normalises the
#: activations; SGD at lr 0.05 with momentum) does not train every net
#: from every initialisation (ROADMAP queue 3).  Its two failure modes are
#: kept out of the summary and do not fail the phase: "diverged" (weights
#: not finite) and "collapsed" (the last 50 steps' mean loss within
#: PAPER_COLLAPSE_RTOL of ln(classes), the loss of a constant uniform
#: prediction).  Any other net below the accuracy margin fails it, and so
#: does a class count at which no net trains
PAPER_COLLAPSE_RTOL = 0.05


@contextlib.contextmanager
def pack_recorder(t24, packed: list):
    """Records (packed layer count, plan layer count) of every pack the
    Tables 2-4 bench builds inside the block, and fails on a pack that
    leaves a layer float or holds its codes other than K-major."""
    from repro_torch.core.approx_linear import packed_layer_paths

    build = t24.apply_numerics

    def checked(params, plan, **kw):
        tree = build(params, plan, **kw)
        paths = packed_layer_paths(tree)
        if paths != sorted(e.path for e in plan.entries):
            fail(f"paper: {plan.name} packed {len(paths)} of "
                 f"{len(plan.entries)} layers")
        check_packs("paper", tree)
        packed.append(len(paths))
        return tree

    t24.apply_numerics = checked
    try:
        yield
    finally:
        t24.apply_numerics = build


def paper_error_model(torch, dev) -> dict:
    """Phase 6b, first half: Table 1 (every entry: the device's integer
    error sums equal the host's, mu and sigma beside the paper's and the
    analytic uniform moments), the conv-error bench (every row: the mean
    nullified, Eq. 20 within PAPER_EQ20_MAX), Figs. 7-9 and Table 5."""
    from repro_torch.core import control_variate as cv
    from repro_torch.core import multipliers as am
    from repro_torch.paper import (conv_error_validation, fig7_9_power,
                                   table1_error, table5_overhead)

    t0 = time.perf_counter()
    n_sums = 0
    for mode, dist, w, a in table1_error.samples():
        wd, ad = torch.from_numpy(w).to(dev), torch.from_numpy(a).to(dev)
        for m in table1_error.PAPER[(mode, dist)]:
            sums = []
            for ww, aa in ((wd, ad), (w, a)):
                e = am.am_error(ww, aa, mode, m).to(torch.int64)
                sums.append((int(e.sum()), int((e * e).sum())))
            if sums[0] != sums[1]:
                fail(f"paper table1 {mode}/{dist}/m{m}: device error sums "
                     f"{sums[0]} != the host's {sums[1]}")
            n_sums += 1
    table1 = table1_error.run(device=dev)
    for r in table1:
        _, mode, dist, m = r["name"].split("/")
        mu_a, sig_a = am.analytic_error_moments_uniform(mode, int(m[1:]))
        print(f"paper {r['name']}: mu {r['mu']} (paper {r['mu_paper']}, "
              f"analytic uniform {mu_a:.2f}), sigma {r['sigma']} (paper "
              f"{r['sigma_paper']}, analytic uniform {sig_a:.2f})",
              flush=True)
    print(f"paper table1: {n_sums} entries x {table1_error.N_SAMPLES:,} "
          "samples, device integer "
          "error sums and sums of squares equal the host's", flush=True)
    conv = conv_error_validation.run(device=dev)
    for r in conv:
        _, mode, m = r["name"].split("/")
        mu12, sig12 = cv.predicted_conv_error_no_cv_uniform(
            mode, int(m[1:]), conv_error_validation.K)
        print(f"paper {r['name']}: Eq. 12 mean {mu12:.1f} std {sig12:.1f}; "
              + json.dumps({k: v for k, v in r.items() if k != "name"}),
              flush=True)
        if not r["mean_nullified"] or r.get("eq20_var_rel_err", 0.0) \
                >= PAPER_EQ20_MAX:
            fail(f"paper {r['name']}: mean not nullified or Eq. 20 off by "
                 f"{r.get('eq20_var_rel_err')} (max {PAPER_EQ20_MAX})")
    figs = fig7_9_power.run() + table5_overhead.run()
    for r in figs:
        print(f"paper {r['name']}: "
              + json.dumps({k: v for k, v in r.items() if k != "name"}),
              flush=True)
    return {"table1": table1, "conv_error": conv, "fig7_9_table5": figs,
            "seconds": time.perf_counter() - t0}


def paper_checks(torch, dev, t24, net: str, classes: int, data,
                 row0: dict) -> dict:
    """Phase 6b, per net after the Tables 2-4 run: the first training steps
    on the card against the host's; the run's training: trained (the loss
    fell, the float accuracy reached PAPER_CHANCE_X x chance), or one of
    the recipe's failure modes (PAPER_COLLAPSE_RTOL); then, for finite
    weights, at one grid point per mode, CV on and off:
    kernel-path logits bit-equal to the plain version's (first CNN_BATCH
    test images) and, for a net that trained, top-1 predictions agreeing
    with the ``jnp`` pack's on the test images."""
    from repro_torch.configs.cnn_suite import get_cnn
    from repro_torch.kernels import approx_matmul as amk
    from repro_torch.nn.cnn import cnn_apply
    from repro_torch.numerics import apply_numerics, paper_grid_specs

    label = f"paper {net} c{classes}"
    xtr, ytr, xte, _ = data
    cfg = get_cnn(net, classes)
    init = t24.initial_params(cfg, dev)
    card = t24.sgd_steps(init, cfg, xtr, ytr, PAPER_SGD_STEPS, dev)[1]
    host = t24.sgd_steps(init, cfg, xtr.cpu(), ytr.cpu(), PAPER_SGD_STEPS,
                         torch.device("cpu"))[1]
    params, losses = t24.train_cnn(net, cfg, xtr, ytr, device=dev)
    same = "equal to" if card == losses[:PAPER_SGD_STEPS] else "not"
    print(f"{label}: first {PAPER_SGD_STEPS} training steps' losses on the "
          f"card {card} ({same} the run's), on the host {host}", flush=True)
    if not all(math.isclose(c, h, rel_tol=PAPER_SGD_RTOL)
               or math.isnan(c) and math.isnan(h)
               for c, h in zip(card, host)):
        fail(f"{label}: the card's training steps leave the host's "
             f"(rtol {PAPER_SGD_RTOL})")
    first, last = (statistics.fmean(losses[:50]),
                   statistics.fmean(losses[-50:]))
    chance, uniform = 1.0 / classes, math.log(classes)
    finite = all(bool(torch.isfinite(t).all()) for t in t24._leaves(params))
    if not finite:
        status = "diverged"
    elif last < first and row0["acc_float"] >= PAPER_CHANCE_X * chance:
        status = "trained"
    elif abs(last - uniform) <= PAPER_COLLAPSE_RTOL * uniform:
        status = "collapsed"
    else:
        fail(f"{label}: the loss fell from {first:.4f} to {last:.4f} and the "
             f"float accuracy is {row0['acc_float']}: neither trained (loss "
             f"falling, accuracy at least {PAPER_CHANCE_X} x chance) nor the "
             "recipe's collapse or divergence")
    print(f"{label}: training loss first 50 steps {first:.4f}, last 50 "
          f"{last:.4f} (uniform prediction {uniform:.4f}); float test "
          f"accuracy {row0['acc_float']} (chance {chance}): {status}",
          flush=True)
    res = {"loss_first50": first, "loss_last50": last, "status": status,
           "sgd_card": card, "sgd_host": host, "points": []}
    if not finite:
        print(f"{label}: non-finite weights, no pack checks", flush=True)
        return res
    ranges = t24.calibrate(params, cfg, xtr[:t24.N_CALIB])
    x0 = xte[:CNN_BATCH]
    for i in CNN_POINTS:
        for cv in (True, False):
            kspec = paper_grid_specs(use_cv=cv, backend="pallas")[i]
            jspec = paper_grid_specs(use_cv=cv)[i]
            kpack = apply_numerics(params, kspec.resolve(params),
                                   act_ranges=ranges)
            jpack = apply_numerics(params, jspec.resolve(params),
                                   act_ranges=ranges)
            with torch.no_grad():
                yk = torch.cat([cnn_apply(kpack, xte[j:j + CNN_BATCH], cfg)
                                for j in range(0, len(xte), CNN_BATCH)])
                plain = [(amk, "approx_matmul_cv_fused",
                          amk.approx_matmul_cv_fused_plain)]
                with plain_swapped(label, plain):
                    yp = cnn_apply(kpack, x0, cfg)
                yj = torch.cat([cnn_apply(jpack, xte[j:j + CNN_BATCH], cfg)
                                for j in range(0, len(xte), CNN_BATCH)])
            if not torch.equal(yp, yk[:CNN_BATCH]):
                fail(f"{label}: {kspec.name} kernel-path logits differ from "
                     "the plain version's: max "
                     f"{float((yp - yk[:CNN_BATCH]).abs().max())}")
            agree = float((yk.argmax(-1) == yj.argmax(-1)).float().mean())
            pol = kspec.default
            res["points"].append({"mode": pol.mode, "m": pol.m, "cv": cv,
                                  "top1_kernel_vs_jnp": agree})
            if agree < PAPER_TOP1_MIN and status == "trained":
                fail(f"{label}: {kspec.name} top-1 agreement with the jnp "
                     f"pack {agree:.4f} < {PAPER_TOP1_MIN}")
    print(f"{label}: kernel-path logits bit-equal to the plain version's at "
          f"{len(CNN_POINTS)} points x CV on/off (B={CNN_BATCH}); top-1 "
          "agreement with the jnp packs "
          f"{[p['top1_kernel_vs_jnp'] for p in res['points']]}", flush=True)
    return res


def run_paper(torch, dev) -> dict:
    """Phase 6b: the paper's own evaluation on the card (error model, then
    Tables 2-4 through ``repro_torch.paper.tables2_4_accuracy.run``:
    the six CNN_SUITE nets trained on the card at 10 and 100 classes, every
    grid point with the CV on and off on ``backend: "pallas"`` packs,
    launches counted; per-net checks; the summary and Fig. 10).  Returns
    the launch counts of each class count's run."""
    import shutil

    from repro_torch.configs.cnn_suite import CNN_SUITE
    from repro_torch.core.cost_model import power_saving
    from repro_torch.paper import fig10_pareto
    from repro_torch.paper import tables2_4_accuracy as t24

    t_start = time.perf_counter()
    line = {"error_model": paper_error_model(torch, dev)}
    t24.ART_DIR = str(ROOT / "build" / "paper_cnn")  # trained here, afresh
    shutil.rmtree(t24.ART_DIR, ignore_errors=True)
    n_grid = 9
    make_data, data = t24.dataset, {}

    def kept(classes, d):
        data[classes] = make_data(classes, d)
        return data[classes]

    launches, rows, checks, seconds = {}, [], {}, {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the depthwise convs
    t24.dataset = kept
    try:
        for classes in (10, 100):
            packed: list = []
            n_batches = -(-t24.N_TEST // 250)
            want = {"approx_matmul_cv_fused": sum(
                2 * n_grid * n_batches * CNN_LAYERS[n] for n in CNN_SUITE)}
            with pack_recorder(t24, packed):
                got, wall, counts, _ = counted_run(
                    torch, f"paper tables2_4 c{classes}",
                    lambda: t24.run(class_counts=(classes,), device=dev),
                    want, f"{len(CNN_SUITE)} nets x {2 * n_grid} packs x "
                    f"{n_batches} "
                    "batches x their layers")
            if packed != [CNN_LAYERS[n] for n in CNN_SUITE
                          for _ in range(2 * n_grid)]:
                fail(f"paper c{classes}: packs of {packed} layers, want each "
                     f"net's CNN_LAYERS count {2 * n_grid} times")
            launches[f"paper tables2_4 c{classes}"] = counts
            seconds[f"c{classes}"] = wall
            rows += got
            for j, net in enumerate(CNN_SUITE):
                net_rows = got[j * n_grid:(j + 1) * n_grid]
                for r in net_rows:
                    print(f"paper {r['name']}: " + json.dumps(
                        {k: v for k, v in r.items() if k != "name"}),
                        flush=True)
                checks[f"{net}/c{classes}"] = paper_checks(
                    torch, dev, t24, net, classes, data[classes], net_rows[0])
            if not any(checks[f"{net}/c{classes}"]["status"] == "trained"
                       for net in CNN_SUITE):
                fail(f"paper c{classes}: no net trained")
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
        t24.dataset = make_data
    line["tables2_4"] = rows
    line["checks"] = checks
    line["tables2_4_seconds"] = seconds

    # the summary: findings, printed, never failed on
    def summary(sel):
        n = len(sel)
        if not n:
            return {"rows": 0}
        loss_cv = sum(r["loss_cv_pct"] for r in sel) / n
        loss_no = sum(r["loss_no_cv_pct"] for r in sel) / n
        acc_cv = sum(r["acc_cv"] for r in sel) / n
        acc_no = sum(r["acc_no_cv"] for r in sel) / n
        return {"rows": n, "mean_loss_cv_pct": loss_cv,
                "mean_loss_no_cv_pct": loss_no,
                # a ratio only where the CV loses at least 0.01 points
                "loss_ratio_no_cv_over_cv": loss_no / loss_cv
                if loss_cv >= 0.01 else None,
                "mean_acc_cv": acc_cv, "mean_acc_no_cv": acc_no,
                "acc_ratio_cv_over_no_cv": acc_cv / acc_no if acc_no
                else None}

    trained = [r for r in rows if checks["/".join(
        r["name"].split("/")[1:3])]["status"] == "trained"]
    points = {}
    for r in trained:
        mode, m = r["name"].split("/")[3:]
        points.setdefault((mode, int(m[1:])), []).append(r)
    per_point = {f"{mode}/m{m}": {
        "power_saving_pct_n64": power_saving(mode, m, 64),
        **summary(sel)} for (mode, m), sel in points.items()}
    under_1pct = [(v["power_saving_pct_n64"], k) for k, v in
                  per_point.items() if v["mean_loss_cv_pct"] < 1.0]
    line["summary"] = {
        "all_nets": summary(rows), "trained_nets": summary(trained),
        "per_point_trained_nets": per_point,
        "best_saving_under_1pct_cv_loss": max(under_1pct, default=None),
        # the reference's default (resnet44, 100 classes), then every net
        "fig10": [r for net in CNN_SUITE
                  for r in fig10_pareto.run(net, 100)]}
    line["seconds"] = time.perf_counter() - t_start
    print("paper summary: " + json.dumps(line["summary"]), flush=True)
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    shutil.copy(os.path.join(t24.ART_DIR, "results_cache.json"),
                ROOT / "chiprun_out" / "paper_results_cache.json")
    write_line("paper", "paper.json", line)
    print(f"paper: {line['seconds']:.1f} s (error model "
          f"{line['error_model']['seconds']:.1f} s; Tables 2-4 "
          f"{json.dumps(seconds)} s, training included); TF32 off",
          flush=True)
    return launches


#: flash's float32 route as ``attn_scan_times`` and ``--compare-flash-f32``
#: time it: the quickstart example's olmo-1b forward and its ``main``'s
#: olmo-1b-reduced (D=16), olmo-1b's prefill shape and hubert-xlarge's
#: encoder (non-causal, D=80)
FLASH_F32_TIMED = (
    ("flash_attention f32 quickstart", QUICKSTART_FLASH[0]),
    ("flash_attention f32 quickstart main", QUICKSTART_FLASH[1]),
    ("flash_attention f32", FLASH_CASES[0][:8] + ("float32",)),
    ("flash_attention f32 hubert-xlarge", HUBERT_FLASH[:8] + ("float32",)))


def flash_rows(torch, dev, card: str, shapes, gen, plain: bool = True
               ) -> dict:
    """Flash attention timed at each (key, case) of ``shapes``: kernel,
    plain version (unless ``plain`` is False), SDPA, and the bound.  A
    bfloat16 row is bound at the bf16 tensor-core rate; a float32 row at
    its three TF32 passes (half the bf16 rate on Hopper), with the float32
    CUDA-core rate's figure for one pass beside it."""
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.launch import roofline

    bw, _, bf16_peak, f32_peak = peaks(card)
    rows = {}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for key, (b, hq, hkv, t, _, d, causal, window, dtype) in shapes:
        # 28-160 MB of q, k, v per call: three copies exceed the 50 MB L2
        # (quickstart's 3 MB: its repeated calls read from the L2)
        dt = getattr(torch, dtype)
        qkv = [tuple(torch.randn(b, h, t, d, generator=gen, device=dev).to(dt)
                     for h in (hq, hkv, hkv)) for _ in range(3)]
        # QK and PV over the visible (query, key) pairs: causal, or a
        # window of W keys (query i sees min(i + 1, W)); q and out, k and v
        nbytes, flops = roofline.flash_attention_work(
            b, hq, hkv, t, t, d, causal, window, dt.itemsize)
        # SDPA's own GQA (enable_gqa), or, in a PyTorch without it, KV heads
        # repeated beforehand (the yardstick then reads the copies); a
        # window is SDPA's boolean mask (SDPA has no window argument)
        mask = {"is_causal": causal}
        if window is not None:
            i = torch.arange(t, device=dev)
            mask = {"attn_mask": (i[None, :] <= i[:, None])
                    & (i[None, :] > i[:, None] - window)}
        lib, gqa = qkv, {"enable_gqa": True}
        if hq != hkv:
            try:
                sdpa(*qkv[0], **mask, **gqa)
            except TypeError:
                reps, gqa = hq // hkv, {}
                lib = [(q, k.repeat_interleave(reps, 1),
                        v.repeat_interleave(reps, 1)) for q, k, v in qkv]
        else:
            gqa = {}
        if dt == torch.bfloat16:
            bound, by = roofline.bound(nbytes, flops, bf16_peak, bw)
        else:
            bound, by = roofline.bound(nbytes, 3 * flops, bf16_peak / 2, bw)
        rows[key] = {
            "shape": [b, hq, hkv, t, d], "dtype": dtype, "causal": causal,
            "window": window,
            "kernel_us": time_calls(torch, [
                lambda a=a: fak.flash_attention(*a, causal=causal,
                                                window=window)
                for a in qkv]) * 1e6,
            "plain_us": time_calls(torch, [
                lambda a=a: fak.flash_attention_plain(*a, causal=causal,
                                                      window=window)
                for a in qkv[:2]], reps=5) * 1e6 if plain else None,
            "library_us": time_calls(torch, [
                lambda a=a: sdpa(*a, **mask, **gqa)
                for a in lib]) * 1e6,
            "library": ("scaled_dot_product_attention"
                        + (" enable_gqa" if gqa else "")
                        + (" attn_mask" if window is not None else "")),
            "bound_us": bound * 1e6, "bound_by": by}
        if dt != torch.bfloat16:
            rows[key]["cuda_core_bound_us"] = roofline.bound(
                nbytes, flops, f32_peak, bw)[0] * 1e6
        print("time " + json.dumps(rows[key]), flush=True)
        del qkv, lib
    return rows


def attn_scan_times(torch, dev, card: str) -> dict:
    """Phase 7, second half: flash attention at the prefill shapes of
    olmo-1b, qwen3-4b, qwen2-vl-2b and hymba-1.5b (window 1024) and of
    hubert-xlarge's encoder, its float32 route at ``FLASH_F32_TIMED``
    (SDPA in float32 with TF32 off), and the scan at the rwkv6-1.6b
    prefill shape (kernel, plain, library, bound)."""
    from repro_torch.kernels import rwkv6_scan as rsk
    from repro_torch.launch import roofline

    bw, _, bf16_peak, _ = peaks(card)
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = flash_rows(torch, dev, card, (
        ("flash_attention", FLASH_CASES[0]),
        ("flash_attention qwen3-4b", QWEN_FLASH),
        ("flash_attention qwen2-vl-2b", QWEN2VL_FLASH),
        ("flash_attention hubert-xlarge", HUBERT_FLASH),
        ("flash_attention hymba-1.5b", HYMBA_FLASH),
        *FLASH_F32_TIMED), gen)

    bf = torch.bfloat16
    b, t, h, dk, dv, *_ = SCAN_CASES[0]
    ins = [scan_inputs(torch, b, t, h, dk, dv, bf, gen, dev) for _ in range(3)]
    # the products on the TF32 tensor cores (half the bf16 rate on Hopper)
    nbytes, flops = roofline.rwkv6_scan_work(b, t, h, dk, dv, 2, 32)
    bound, by = roofline.bound(nbytes, flops, bf16_peak / 2, bw)
    rows["rwkv6_scan"] = {
        "shape": [b, t, h, dk, dv], "dtype": "bfloat16",
        "blocks": rsk.grid_blocks(b, h),
        "kernel_us": time_calls(torch, [lambda a=a: rsk.rwkv6_scan(*a)
                                        for a in ins]) * 1e6,
        "plain_us": time_calls(torch, [lambda a=a: rsk.rwkv6_scan_plain(*a)
                                       for a in ins[:2]], reps=5) * 1e6,
        "library_us": None,
        "bound_us": bound * 1e6, "bound_by": by}
    print("time " + json.dumps(rows["rwkv6_scan"]), flush=True)
    return rows


# ---------------------------------------------------------------------------
# granite-8b through the serve CLI, and the repo-root examples
# ---------------------------------------------------------------------------

GRANITE = "granite-8b"
#: the "examples" phase: serve_approx's qwen3-4b depth (widths full; None:
#: all 36 layers) and train_lm's steps (the example's default is 300; cut
#: to 100 to keep the whole check inside its time limit on a slow host)
SERVE_APPROX_LAYERS, TRAIN_LM_STEPS = None, 100
#: quickstart's entry point on the card against the host.  The float
#: forward's logits: float32 sums in another order (flash, cuBLAS), the
#: flash kernel's own float32 tolerance.  The uint8 activation codes of
#: the approximate layer calls: in each forward the first call whose codes
#: differ must differ only where the host's value lies within
#: QUICKSTART_BOUNDARY codes of a rounding boundary (what float32 sums in
#: another order can move); later calls inherit the change, and an
#: approximate product turns one code into several.  The seven mean
#: |logit err| rows: within QUICKSTART_RTOL (the card's gap was 1.79e-3,
#: H100 80GB HBM3, 700.00 W).  The witness printed beside them: the host's
#: own rows with one code a forward (the nearest a boundary, in call
#: QUICKSTART_FLIP_CALL: layer 0's gate|up input) pushed across it.
QUICKSTART_FLOAT_RTOL = 2e-5
QUICKSTART_BOUNDARY = 1e-3
QUICKSTART_RTOL = 5e-3
QUICKSTART_FLIP_CALL = 2
#: the pareto_sweep's accuracy losses (``jnp`` packs) against the paper
#: phase's rows (``pallas`` packs, top-1 agreement >= PAPER_TOP1_MIN
#: between the two): 1 point, plus the rows' rounding to 0.01
PARETO_POINTS = 1.0 + 0.005


def _zero_launches() -> dict:
    wr = wrappers()
    for w in wr.values():
        w.launches = 0
    return wr


def _example_launches(label: str, wr: dict, flash: int = 0) -> dict:
    """The examples keep the reference's ``backend: "jnp"`` policy: since
    ``_zero_launches`` no approx-matmul wrapper may have launched, and
    flash ``flash`` times (a float or packed forward's prefill attention
    on the card is the flash kernel, a launch a layer)."""
    launches = {n: w.launches for n, w in wr.items()}
    want = {n: 0 for n in wr}
    want["flash_attention"] = flash
    if launches != want:
        fail(f"{label}: kernel launches {launches}, want {want}")
    return launches


@contextlib.contextmanager
def folded_inputs(edit):
    """Every folded approximate layer call (the only kind quickstart's
    ``serve-default`` packs make) inside the block passes its input
    through ``edit(i, a, fold)`` first, i counting the calls from 0."""
    from repro_torch.core import approx_linear as al

    base, n = al.folded_linear, [0]

    def folded(a, fold, *rest, **kw):
        a = edit(n[0], a, fold)
        n[0] += 1
        return base(a, fold, *rest, **kw)

    al.folded_linear = folded
    try:
        yield
    finally:
        al.folded_linear = base


def quickstart_main(torch, argv: list) -> dict:
    """``repro_torch.examples.quickstart.main(argv)`` in this process: its
    printed text, its table and rows, and, in call order, the uint8
    activation codes of each folded layer call with each value's distance
    to the nearest rounding boundary (x.5) in codes, all on the host."""
    import io

    from repro_torch.examples import quickstart
    from repro_torch.quant.quantize import QMAX, QMIN

    rec = {"codes": [], "margin": []}
    base = quickstart.quickstart

    def record(i, a, fold):
        t = a.float() / fold["sa"]
        r = torch.round(t)
        rec["codes"].append(torch.clamp(r + fold["za"], QMIN, QMAX).to(
            torch.int16).cpu())
        rec["margin"].append((0.5 - (t - r).abs()).cpu())
        return a

    def table(*a, **kw):
        rec["table"], rec["rows"] = base(*a, **kw)
        return rec["table"], rec["rows"]

    buf = io.StringIO()
    quickstart.quickstart = table
    try:
        with folded_inputs(record), contextlib.redirect_stdout(buf):
            quickstart.main(argv)
    finally:
        quickstart.quickstart = base
    rec["text"] = buf.getvalue()
    return rec


def quickstart_card_vs_host(torch, dev, cfg, card: dict, host: dict
                            ) -> dict:
    """quickstart's ``main`` on the card (``card``) against the host
    (``host``), both ``quickstart_main`` records: the plan table and the
    labels equal; the float forward's logits within QUICKSTART_FLOAT_RTOL;
    in each forward, the first call whose codes differ differs only where
    the host's value lies within QUICKSTART_BOUNDARY of a rounding
    boundary; the rows within QUICKSTART_RTOL.  Prints beside them the
    witness: the host's rows with one code a forward pushed across its
    boundary (QUICKSTART_FLIP_CALL).  Returns the readings."""
    from repro_torch.examples import quickstart
    from repro_torch.launch.serve import _to_device
    from repro_torch.models import build_model

    label = "examples quickstart main"
    for side, rec in (("card", card), ("host", host)):
        print(f"{label} ({side}): {rec['text'].strip().splitlines()[-8:]}",
              flush=True)
    if card["table"] != host["table"] or [lb for lb, _ in card["rows"]] != [
            lb for lb, _ in host["rows"]]:
        fail(f"{label}: the card's plan table or labels differ from the "
             "host's")
    params, toks = quickstart.example_inputs(cfg)
    with torch.no_grad():
        want = build_model(cfg, "cpu").forward(params, {"tokens": toks})
        got = build_model(cfg, dev).forward(_to_device(params, dev),
                                            {"tokens": toks.to(dev)})
    float_err = close(torch, got.cpu(), want, QUICKSTART_FLOAT_RTOL)
    n_rows = len(host["rows"])
    per_forward, extra = divmod(len(host["codes"]), n_rows)
    if extra or len(card["codes"]) != len(host["codes"]) or any(
            c.shape != h.shape for c, h in zip(card["codes"],
                                               host["codes"])):
        fail(f"{label}: the card made other folded layer calls than the "
             f"host, or not {per_forward} in each of {n_rows} forwards")
    diffs = [(c.int() - h.int()).abs() for c, h in zip(card["codes"],
                                                       host["codes"])]
    first = []  # (call in its forward, codes, largest host margin)
    for f in range(n_rows):
        for i in range(f * per_forward, (f + 1) * per_forward):
            bad = diffs[i] > 0
            if bool(bad.any()):
                first.append((i % per_forward, int(bad.sum()),
                              float(host["margin"][i][bad].max())))
                break
    gaps = [abs(c - h) / h for (_, c), (_, h) in zip(card["rows"],
                                                     host["rows"])]

    def flip(i, a, fold):
        if i % per_forward != QUICKSTART_FLIP_CALL:
            return a
        t = (a.float() / fold["sa"]).flatten()
        frac = t - torch.round(t)
        j = int((0.5 - frac.abs()).argmin())
        a = a.clone()
        a.view(-1)[j] = ((torch.round(t[j]) + torch.sign(frac[j]) * 0.501)
                         * fold["sa"]).to(a.dtype)
        return a

    with folded_inputs(flip):
        _, w_rows = quickstart.quickstart(cfg, params, toks, "cpu")
    witness = [abs(w - h) / h for (_, w), (_, h) in zip(w_rows,
                                                        host["rows"])]
    out = {"float_logits_max_abs_err": float_err,
           "codes": sum(d.numel() for d in diffs),
           "codes_differing": sum(int((d > 0).sum()) for d in diffs),
           "code_max_abs_diff": max(int(d.max()) for d in diffs),
           "first_divergence": first,
           "rows_card": card["rows"], "rows_host": host["rows"],
           "rows_max_rel_gap": max(gaps),
           "host_one_flip_rows_max_rel_gap": max(witness)}
    margin = max((m for _, _, m in first), default=0.0)
    print(f"{label}: card against host: float logits max abs err "
          f"{float_err:.3g} (rtol {QUICKSTART_FLOAT_RTOL}); "
          f"{out['codes_differing']} of {out['codes']} activation codes "
          f"differ, by at most {out['code_max_abs_diff']}; each forward's "
          f"first divergence (call, codes, largest host margin) {first}: "
          f"within {margin:.3g} of a rounding boundary (limit "
          f"{QUICKSTART_BOUNDARY}); rows' largest relative gap "
          f"{max(gaps):.3g} (tolerance {QUICKSTART_RTOL}); the host with "
          f"one code a forward flipped at call {QUICKSTART_FLIP_CALL}: "
          f"{max(witness):.3g}", flush=True)
    if margin > QUICKSTART_BOUNDARY or max(gaps) > QUICKSTART_RTOL:
        fail(f"{label}: the card's table differs from the host's beyond "
             f"the cascade of a rounding-boundary code: {out}")
    return out


def run_examples(torch, dev) -> dict:
    """Phase 6c, "examples", after the paper phase: the repo-root examples
    through ``repro_torch.examples``, each on the card.

    - quickstart at olmo-1b's full width (16 layers, float32, (4, 32)
      tokens): the seven mean |logit err| rows (fails on a non-finite
      one); then its ``main`` at its defaults (olmo-1b-reduced, head dim
      16) on the card and on the host (``quickstart_card_vs_host``).
    - serve_approx at qwen3-4b's full width (SERVE_APPROX_LAYERS deep):
      10 requests, slots 4, max_len 128, chunk 32, int8 KV; fails unless
      every request finishes with its token count or is rejected for the
      admission controller's reason.
    - train_lm at its ~100M default, TRAIN_LM_STEPS steps of B=8, T=256
      (checkpoints every 50 under codec none in a directory under build/,
      removed after): tokens/s, step ms, peak GiB, the loss every 50
      steps, checkpoints, stragglers; fails unless every loss is finite
      and the last 20 steps' mean loss is below the first 20's.
    - pareto_sweep on the paper phase's cached resnet44/c10 weights: the
      rows and the front; fails unless every power equals the cost
      model's and every accuracy loss is within PARETO_POINTS of the
      paper phase's row for that point.

    Every example runs the plain ``jnp`` path: no approx-matmul kernel
    may launch; quickstart's forwards run the flash kernel in their
    prefill attention.  Returns the launches by path."""
    import dataclasses
    import gc
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.configs.cnn_suite import get_cnn
    from repro_torch.core import cost_model as cm
    from repro_torch.examples import (pareto_sweep, quickstart, serve_approx,
                                      train_lm)
    from repro_torch.launch.serve import _to_device, mixed_trace
    from repro_torch.models import build_model
    from repro_torch.paper import tables2_4_accuracy as t24
    from repro_torch.serving import AdmissionController, Request, RequestQueue

    t_start = time.perf_counter()
    paths, line, seconds = {}, {}, {}

    # quickstart, full width
    t0 = time.perf_counter()
    cfg = quickstart.quickstart_config("olmo-1b")
    params = build_model(cfg, dev).init(0)
    toks = torch.randint(0, cfg.vocab, (4, 32), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    wr = _zero_launches()
    table, rows = quickstart.quickstart(cfg, params, toks, dev)
    # the float forward and one a point
    paths["examples quickstart"] = _example_launches(
        "quickstart", wr, (1 + len(rows)) * cfg.n_layers)
    del params
    for lbl, err in rows:
        print(f"examples quickstart olmo-1b: {lbl:34s} {err:18.4f}",
              flush=True)
    if not all(math.isfinite(err) for _, err in rows):
        fail(f"quickstart: a non-finite error in {rows}")
    line["quickstart"] = {"arch": cfg.name, "layers": cfg.n_layers,
                          "rows": rows, "plan_lines": len(table.splitlines())}
    # the entry point at its defaults (olmo-1b-reduced, head dim 16) on
    # the card against the host, both from main's host-seeded init
    wr = _zero_launches()
    card = quickstart_main(torch, [])
    rcfg = quickstart.quickstart_config()
    paths["examples quickstart main"] = _example_launches(
        "quickstart main", wr, (1 + len(card["rows"])) * rcfg.n_layers)
    host = quickstart_main(torch, ["--device", "cpu"])
    line["quickstart"]["main"] = quickstart_card_vs_host(
        torch, dev, rcfg, card, host)
    seconds["quickstart"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()

    # serve_approx, qwen3-4b at full width
    t0 = time.perf_counter()
    cfg = get_config("qwen3-4b")
    if SERVE_APPROX_LAYERS is not None:
        cfg = dataclasses.replace(cfg, n_layers=SERVE_APPROX_LAYERS)
    params = build_model(cfg, dev).init(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wr = _zero_launches()
    res = serve_approx.serve_approx(
        cfg, params, dev,
        out=lambda s: print(f"examples serve_approx: {s}", flush=True))
    paths["examples serve_approx"] = _example_launches("serve_approx", wr)
    del params
    trace = mixed_trace(cfg, 10, 128, 32)
    adm, queue = AdmissionController(max_queue=256, max_len=128,
                                     prefill_chunk=32), RequestQueue()
    want_rej = [(i, reason) for i, (p, g) in enumerate(trace)
                for _, reason in [adm.check(queue, Request(
                    rid=i, prompt=p, max_new_tokens=g))[:2]] if reason]
    done = [r for r in res["requests"] if r.state.value != "rejected"]
    if res["rejected"] != want_rej or not all(
            r.finished and len(r.generated) == g for r, (_, g) in zip(
                res["requests"], trace) if r.state.value != "rejected"):
        fail(f"serve_approx: rejected {res['rejected']} (the admission "
             f"controller's: {want_rej}); finished "
             f"{[(r.rid, len(r.generated)) for r in done]}")
    snap = res["snapshot"]
    line["serve_approx"] = {
        **served_metrics(snap), "layers": cfg.n_layers,
        "depth": "full" if SERVE_APPROX_LAYERS is None else "cut",
        "rejected": res["rejected"],
        "compiled_shapes": res["engine"].compile_count(),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del res
    seconds["serve_approx"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()

    # train_lm, the ~100M default
    t0 = time.perf_counter()
    cfg = train_lm.train_lm_config()
    tcfg, dcfg = train_lm.example_configs(cfg, TRAIN_LM_STEPS)
    ckpt = ROOT / "build" / "train_lm_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    print(f"examples train_lm: arch={cfg.name} "
          f"~{cfg.param_count() / 1e6:.0f}M params, {TRAIN_LM_STEPS} steps "
          f"of B={dcfg.batch}, T={dcfg.seq_len}", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wr = _zero_launches()
    try:
        res = train_lm.train_lm(
            cfg, tcfg, dcfg, str(ckpt), dev, codec="none",
            out=lambda s: print(f"examples train_lm: {s}", flush=True))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    paths["examples train_lm"] = _example_launches("train_lm", wr)
    losses = res["losses"]
    n = len(losses)
    first, last = (statistics.mean(losses[:20]),
                   statistics.mean(losses[-20:]))
    step_ms = statistics.median(res["step_s"]) * 1e3
    tok = dcfg.batch * dcfg.seq_len
    line["train_lm"] = {
        "arch": cfg.name, "params": cfg.param_count(), "steps": n,
        "tokens_per_s": n * tok / sum(res["step_s"]),
        "step_ms_median": step_ms,
        "step_ms_min_max": [min(res["step_s"]) * 1e3,
                            max(res["step_s"]) * 1e3],
        "wall_s": res["seconds"],
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "loss_every_50": {i: losses[i] for i in range(0, n, 50)}
        | {n - 1: losses[-1]},
        "loss_first20_mean": first, "loss_last20_mean": last,
        "checkpoints_written": -(-n // train_lm.CHECKPOINT_EVERY),
        "checkpoints_kept": res["checkpoints"],
        "stragglers": res["flagged"]}
    print(f"examples train_lm: {n} steps, {line['train_lm']['tokens_per_s']:.0f} "
          f"tokens/s, median step {step_ms:.2f} ms, loss "
          f"{json.dumps(line['train_lm']['loss_every_50'])}, mean of the "
          f"first 20 {first:.4f} -> last 20 {last:.4f}", flush=True)
    if n != TRAIN_LM_STEPS or not all(math.isfinite(x) for x in losses) \
            or not last < first:
        fail(f"train_lm: {n} steps, loss {first} -> {last} (must fall and "
             "stay finite)")
    del res
    seconds["train_lm"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()

    # pareto_sweep on the paper phase's cached resnet44/c10 weights
    t0 = time.perf_counter()
    cfg = get_cnn("resnet44", 10)
    if not os.path.exists(t24.weights_path("resnet44", cfg)):
        fail("pareto_sweep: no cached resnet44/c10 weights from the paper "
             f"phase under {t24.ART_DIR}")
    cache = t24._load_cache()
    xtr, ytr, xte, yte = t24.dataset(10, dev)
    params, _ = t24.train_cnn("resnet44", cfg, xtr, ytr, device=dev)
    wr = _zero_launches()
    res = pareto_sweep.pareto_sweep(
        cfg, params, xtr, xte, yte, dev,
        out=lambda s: print(f"examples pareto_sweep: {s}", flush=True))
    paths["examples pareto_sweep"] = _example_launches("pareto_sweep", wr)
    gaps = []
    for lbl, power, d_cv, d_no in res["rows"]:
        mode, m = lbl.split("/m")
        ref = cache[f"tables2_4/resnet44/c10/{mode}/m{m}"]
        gap = max(abs(d_cv - ref["loss_cv_pct"]),
                  abs(d_no - ref["loss_no_cv_pct"]))
        gaps.append(gap)
        if power != 1 - cm.power_saving(mode, int(m), 64) / 100 \
                or gap > PARETO_POINTS:
            fail(f"pareto_sweep {lbl}: power {power}, loss {d_cv:.2f} / "
                 f"{d_no:.2f} points against the paper phase's "
                 f"{ref['loss_cv_pct']} / {ref['loss_no_cv_pct']}")
    line["pareto_sweep"] = {"acc_float": res["acc_float"],
                            "rows": res["rows"], "front": res["front"],
                            "max_gap_to_paper_points": max(gaps)}
    print(f"examples pareto_sweep: every power equals the cost model's; "
          f"accuracy losses within {max(gaps):.2f} points of the paper "
          f"phase's pallas rows; float accuracy {res['acc_float']:.3f} "
          "against chance 0.100"
          + (": the reference's recipe barely trains this net (ROADMAP "
             "queue 3), so the front is noise on a near-collapsed net"
             if res["acc_float"] < 0.3 else ""), flush=True)
    del params, res
    seconds["pareto_sweep"] = time.perf_counter() - t0
    line["seconds"] = seconds
    write_line("examples", "examples.json", line)
    print(f"examples: {time.perf_counter() - t_start:.1f} s "
          f"{json.dumps(seconds)}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return paths


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=8,
                    help="olmo-1b depth for its engine path (widths are "
                    "never cut; the other paths run at full depth)")
    ap.add_argument("--compare-codes-entry", type=pathlib.Path,
                    metavar="OTHER", help="instead of the check: the "
                    "codes-in entry's olmo-1b layer times of the checkout "
                    "at OTHER and of this one, in turn")
    ap.add_argument("--compare-flash-f32", type=pathlib.Path,
                    metavar="OTHER", help="instead of the check: flash's "
                    "float32 route at its timed shapes in the checkout at "
                    "OTHER and in this one, in turn")
    ap.add_argument("--tree-times", nargs=2, metavar=("KIND", "ROOT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree_times is not None:
        tree_times(args.tree_times[0],
                   pathlib.Path(args.tree_times[1]).resolve())
        return 0
    for kind, other in (("codes-entry", args.compare_codes_entry),
                        ("flash-f32", args.compare_flash_f32)):
        if other is not None:
            compare_trees(kind, other.resolve())
            return 0
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this check runs on the card only")
    import repro_torch  # noqa: F401  (fails outside a checkout)

    # the dry run needs no card: it runs beside the earlier phases
    dryrun = start_dryrun()

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

    # seconds of each phase, printed at the end (the whole run must stay
    # inside the card check's time limit)
    laps, lap_t = {"build": time.perf_counter() - t0}, [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        laps[name] = round(now - lap_t[0], 1)
        lap_t[0] = now

    errs = check_kernels(torch, dev)
    lap("kernels")
    errs.update(check_attention_and_scan(torch, dev))
    lap("attention and scan")
    # every path is driven with the launch counts zeroed just before it and
    # read just after it
    built = run_main_path(torch, dev, args.layers)
    paths = {"engine olmo-1b": built["launches"]}
    paths["legacy-pack olmo-1b"] = run_legacy_packs(torch, built)
    paths["paged olmo-1b"] = run_paged(
        torch, "paged olmo-1b", built["cfg"], built["api"], built["packed"],
        built["ecfg"], built["trace"], built["run"], built["numerics"])
    paths["deadlines olmo-1b"] = run_deadlines(torch, built)
    paths.update(run_speculative(torch, built))
    lap("olmo-1b engine, legacy packs, paged, deadlines, speculative")
    phase_s, t0 = {}, time.perf_counter()
    launches, probe_summ = run_probe_phase(torch, built)
    paths.update(launches)
    phase_s["probe"], t0 = time.perf_counter() - t0, time.perf_counter()
    paths.update(run_faults(torch, built))
    phase_s["faults"], t0 = time.perf_counter() - t0, time.perf_counter()
    paths.update(run_governor(torch, built, probe_summ["probe olmo-1b"][
        "logits_err_var"]))
    phase_s["governor"], t0 = time.perf_counter() - t0, time.perf_counter()
    paths.update(run_observability(torch, built, probe_summ))
    phase_s["observability"], t0 = (time.perf_counter() - t0,
                                    time.perf_counter())
    paths.update(run_fleet_phase(torch, built))
    phase_s["fleet"], t0 = time.perf_counter() - t0, time.perf_counter()
    paths.update(run_checkpoint_phase(torch, built))
    phase_s["checkpoint"], t0 = (time.perf_counter() - t0,
                                 time.perf_counter())
    del built
    torch.cuda.empty_cache()
    run_auto(torch, dev)
    phase_s["auto"] = time.perf_counter() - t0
    print("robustness, observability, fleet and checkpoint phases, "
          "seconds: "
          + json.dumps(phase_s), flush=True)
    lap("robustness, observability, fleet, auto")
    torch.cuda.empty_cache()
    paths.update(run_qwen3_engine(torch, dev))
    lap("qwen3-4b engines")
    torch.cuda.empty_cache()
    paths["engine rwkv6-1.6b"] = run_rwkv_engine(torch, dev)
    lap("rwkv6-1.6b engine")
    torch.cuda.empty_cache()
    paths["engine qwen2-vl-2b"], built = run_qwen2vl_engine(torch, dev)
    res = run_vlm_embeds(torch, dev, built)  # on the engine phase's packs
    del built
    paths["embeds qwen2-vl-2b"] = res["launches"]
    per_layer = {"embeds qwen2-vl-2b": max(res["per_layer_max_abs_err"])}
    torch.cuda.empty_cache()
    lap("qwen2-vl-2b engine, embeds")
    paths["cli granite-8b"] = run_serve_cli(torch, GRANITE, 8,
                                            by_layer=False)
    lap("granite-8b")
    paths.update(run_moe_phase(torch, dev, between=lambda keep: (
        run_distributed_phase(torch, dev, keep, dryrun))))
    lap("moe, distributed")
    for arch in LEGACY:
        if arch == HYMBA:
            continue
        line = run_legacy_path(torch, dev, arch)
        paths[f"legacy {arch}"] = line["launches"]
        per_layer[arch] = max(line["per_layer_max_abs_err"])
        torch.cuda.empty_cache()
    lap("lock-step")
    line = run_legacy_path(torch, dev, HYMBA)
    paths[f"legacy {HYMBA}"] = line["launches"]
    paths[f"legacy {HYMBA} int8-cache"] = line["int8_cache"]["launches"]
    per_layer[HYMBA] = max(line["per_layer_max_abs_err"])
    del line
    torch.cuda.empty_cache()
    lap("hybrid")
    paths["train"] = run_train_phase(torch, dev)
    lap("train")
    res = run_hubert_encoder(torch, dev)
    lap("hubert-xlarge encoder")
    paths["encoder hubert-xlarge"] = res["launches"]
    per_layer["encoder hubert-xlarge"] = max(res["per_layer_max_abs_err"])
    torch.cuda.empty_cache()
    cnn = run_cnn_suite(torch, dev, card)
    lap("cnn suite")
    for name, res in cnn.items():
        paths[f"cnn {name}"] = res["launches"]
    torch.cuda.empty_cache()
    paths.update(run_paper(torch, dev))
    lap("paper")
    paths.update(run_examples(torch, dev))
    lap("examples")
    ratios = {f"{r['mode']}(m={r['m']})": [
        round(cnn[name]["c10"][i]["err_ratio_no_cv_over_cv"], 3)
        for name in cnn] for i, r in enumerate(next(iter(cnn.values()))["c10"])}
    print(f"cnn: relative logit error without the CV over with it, 10 "
          f"classes, nets {list(cnn)}: " + json.dumps(ratios), flush=True)
    print("prefills and the encoder, teacher-forced per layer: every layer "
          "of every prefill inside its kernel's per-call tolerance; largest "
          "max abs err by path " + json.dumps(per_layer), flush=True)
    launches = {n: sum(p[n] for p in paths.values()) for n in wrappers()}
    print("launches by path: " + json.dumps(paths), flush=True)
    rows = kernel_times(torch, dev, card)
    new_rows = attn_scan_times(torch, dev, card)
    lap("kernel times")
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "kernel_times.json").write_text(
        json.dumps({"card": card, "rows": rows, "attention_scan": new_rows,
                    "cnn_largest_calls": [r["largest_call"]
                                          for r in cnn.values()],
                    "cnn_other_calls": [c for r in cnn.values()
                                        for c in r["other_calls"]]},
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
        print(f"{name} per layer, qwen3-4b decode step (7 launches, M=4): "
              + json.dumps(step_entry(rows, name, QWEN_DECODE_KN, 4)),
              flush=True)
        print(f"{name} per layer, qwen3-4b engine chunk step (4 launches, "
              "M=128): " + json.dumps(step_entry(rows, name, QWEN_KN, 128)),
              flush=True)
        for label, kn, mm in (
                ("deepseek-v2-lite-16b decode step (MoE layer, 5 launches, "
                 "M=4)", DSV2_DECODE_KN, 4),
                ("deepseek-v2-lite-16b engine chunk step (MoE layer, 4 "
                 "launches, M=128)", DSV2_KN, 128),
                ("deepseek-v2-lite-16b decode step (dense layer, 5 "
                 "launches, M=4)", DSV2_DENSE_DECODE_KN, 4),
                ("deepseek-v2-lite-16b engine chunk step (dense layer, 4 "
                 "launches, M=128)", DSV2_DENSE_KN, 128),
                ("deepseek-v2-lite-16b head, decode step (1 launch, M=4)",
                 [DSV2_HEAD_KN], 4),
                ("deepseek-v2-lite-16b head, engine chunk step (1 launch, "
                 "M=128)", [DSV2_HEAD_KN], 128),
                ("qwen2-vl-2b decode step (7 launches, M=4)",
                 QWEN2VL_DECODE_KN, 4),
                ("qwen2-vl-2b engine chunk step (4 launches, M=128)",
                 QWEN2VL_KN, 128),
                ("hubert-xlarge --legacy decode step shapes, kernel only "
                 "(no phase drives them; 6 launches, M=4)",
                 HUBERT_DECODE_KN, 4),
                ("hubert-xlarge head at --legacy decode rows, kernel only "
                 "(no phase drives it; 1 launch, M=4)",
                 [HUBERT_HEAD_KN], 4),
                ("hymba-1.5b decode step (9 launches, M=4)",
                 HYMBA_DECODE_KN, 4),
                ("hymba-1.5b head, a prefill or decode step (1 launch, "
                 "M=4)", [HYMBA_HEAD_KN], 4)):
            print(f"{name} per layer, {label}: "
                  + json.dumps(step_entry(rows, name, kn, mm)), flush=True)
        if name == "approx_matmul_cv":
            for label, nm in (("", name),
                              (f" (the other design, {CODES_OTHER})",
                               f"{name}/{CODES_OTHER}")):
                for mm in (128, OLMO_PREFILL_M):
                    print(f"{name} per layer{label}, olmo-1b "
                          f"{'chunk' if mm == 128 else 'prefill'} "
                          f"({len(PREFILL_KN)} launches, M={mm}): "
                          + json.dumps(step_entry(rows, nm, PREFILL_KN, mm)),
                          flush=True)
        if name == "approx_matmul_cv_fused":
            for label, kn, mm in (
                    ("olmo-1b", PREFILL_KN, OLMO_PREFILL_M),
                    ("rwkv6-1.6b", RWKV_KN, RWKV_PREFILL_M),
                    ("qwen3-4b", QWEN_KN, QWEN_PREFILL_M),
                    ("qwen2-vl-2b", QWEN2VL_KN, QWEN2VL_PREFILL_M),
                    ("hubert-xlarge encoder", HUBERT_KN, HUBERT_M),
                    ("hubert-xlarge encoder head", [HUBERT_HEAD_KN],
                     HUBERT_M),
                    ("hymba-1.5b", HYMBA_KN, HYMBA_PREFILL_M)):
                print(f"{name} per layer, {label} prefill "
                      f"({len(kn)} launches, M={mm}): "
                      + json.dumps(step_entry(rows, name, kn, mm)),
                      flush=True)
        entries.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/approx_matmul.cu",
            "replaces": f"src/repro/kernels/approx_matmul.py:{src_line}",
            # wrapper calls on every path (a fused call is one CUDA launch
            # at decode rows and conv shapes, the prep and a matmul kernel
            # at other shapes)
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
    print("phases, seconds: " + json.dumps(laps), flush=True)
    print(f"smoke: {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
