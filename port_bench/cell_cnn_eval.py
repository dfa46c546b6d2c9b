"""Cell runner ``cnn_eval``: a CNN's batched inference through the port's
``nn.cnn.cnn_apply`` on a pack of the paper's approximate multiplier
with the CV, under an image stream.

Set-up makes the float weights (:mod:`port_bench.weights`) and the
images (:mod:`port_bench.traffic`: a calibration batch and a pool, the
pool in pinned host memory) from the seed, calibrates the activation
ranges through the program on the calibration batch
(``quant.observers.CalibrationRecorder``), packs through the program
(``numerics.apply_numerics`` under the configuration's numerics spec)
and warms up the batch shape.  The window serves the pool in batches,
dispatched one ahead: batch i + 1's copy from pinned memory is enqueued
on a copy stream while batch i computes, and each batch's logits come
back to the host.  With ``--trace 1`` the profiler traces the middle
``TRACE_SECONDS``.

Correctness: once the window has closed and the pack is freed, batches
drawn from the seed among those served are run through the plain
reference (:mod:`port_bench.ref_cnn`), which calibrates and quantizes
for itself; the compared number is the widest logit difference over the
reference's logit RMS.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from port_bench import ref_cnn, trace, traffic, weights
from port_bench.harness import stamp

TRACE_SECONDS = 4.0
_SAMPLE = 4


class Stream:
    """Batches of the pool, one in flight ahead of the one being read."""

    def __init__(self, forward, pool: torch.Tensor, batch: int, dev,
                 classes: int):
        self.forward, self.pool, self.batch = forward, pool, batch
        self.cuda = dev.type == "cuda"
        self.n = pool.shape[0] // batch
        shape = (batch,) + tuple(pool.shape[1:])
        self.x = [torch.empty(shape, device=dev) for _ in range(2)]
        self.out = [torch.empty((batch, classes),
                                pin_memory=self.cuda) for _ in range(2)]
        if self.cuda:
            self.copy = torch.cuda.Stream()
            self.copied = [torch.cuda.Event() for _ in range(2)]
            self.freed = [torch.cuda.Event() for _ in range(2)]
            self.ready = [torch.cuda.Event() for _ in range(2)]

    def dispatch(self, i: int) -> None:
        """Enqueue batch i: its copy in, forward and copy out."""
        b, j = i % 2, i % self.n
        src = self.pool[j * self.batch:(j + 1) * self.batch]
        with torch.profiler.record_function("bench.dispatch"):
            if not self.cuda:
                self.out[b].copy_(self.forward(src))
                return
            with torch.cuda.stream(self.copy):
                if i >= 2:
                    self.copy.wait_event(self.freed[b])
                self.x[b].copy_(src, non_blocking=True)
                self.copied[b].record(self.copy)
            cur = torch.cuda.current_stream()
            cur.wait_event(self.copied[b])
            logits = self.forward(self.x[b])
            self.freed[b].record(cur)
            self.out[b].copy_(logits, non_blocking=True)
            self.ready[b].record(cur)

    def collect(self, i: int) -> np.ndarray:
        """Wait for batch i's logits on the host."""
        b = i % 2
        with torch.profiler.record_function("bench.wait"):
            if self.cuda:
                self.ready[b].synchronize()
            return self.out[b].numpy().copy()


def run(cell):
    from repro_torch.nn.cnn import CNNConfig, cnn_apply
    from repro_torch.numerics import NumericsSpec, apply_numerics
    from repro_torch.quant.observers import CalibrationRecorder
    from port_bench.harness import Outcome

    dev = torch.device(cell.device)
    cuda = dev.type == "cuda"
    cnn, mix = cell.config["cnn"], cell.traffic
    cfg = CNNConfig(**cnn)
    stamp(cell, "imports and the card")
    tree = weights.resnet_tree(cnn, cell.seed, dev)
    calib_np, pool_np = traffic.images(mix, cell.seed, cnn["img_size"],
                                       cnn["in_channels"])
    pool = torch.from_numpy(pool_np)
    if cuda:
        pool = pool.pin_memory()
    stamp(cell, "weights and images")
    with CalibrationRecorder() as rec:
        cnn_apply(tree, torch.from_numpy(calib_np).to(dev), cfg)
    stamp(cell, "calibration")
    spec = NumericsSpec.from_dict(cell.config["numerics"])
    packed = apply_numerics(tree, spec.resolve(tree), act_ranges=rec.ranges())
    del tree
    stamp(cell, "pack")

    def forward(x):
        return cnn_apply(packed, x, cfg)

    if "cnn_apply" in cell.hooks:
        forward = cell.hooks["cnn_apply"](forward)
    batch = mix["batch"]
    stream = Stream(forward, pool, batch, dev, cnn["num_classes"])
    for i in range(2):  # warm-up: the batch shape, both buffers
        stream.dispatch(i)
        stream.collect(i)
    stamp(cell, "warm-up")
    if cell.trace:
        trace.warm()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - cell.t_start

    seconds = cell.seconds
    tr_lo = max(0.0, (seconds - TRACE_SECONDS) / 2)
    tr_t0 = 0.0
    served: dict[int, np.ndarray] = {}
    traced_batches = 0
    box = None
    in_trace = False
    with contextlib.ExitStack() as stack:
        t0 = time.perf_counter()
        stream.dispatch(0)
        i = 0
        while True:
            now = time.perf_counter()
            if cell.trace and box is None and now - t0 >= tr_lo:
                served[i] = stream.collect(i)  # drain before the trace
                i += 1
                box = stack.enter_context(trace.traced())
                in_trace, tr_t0 = True, time.perf_counter()
                stream.dispatch(i)
                traced_batches += 1
            elif in_trace and now - tr_t0 >= TRACE_SECONDS:
                stack.close()
                in_trace = False
            stream.dispatch(i + 1)
            traced_batches += in_trace
            served[i] = stream.collect(i)
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        t1 = time.perf_counter()
        stream.collect(i)  # the batch in flight: served after the window
    summary = trace.summarise(box["prof"]) if box is not None else None
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    rec = {"kind": "cnn_eval", "setup_s": setup_s, "t0": t0, "t1": t1,
           "window_s": t1 - t0, "images": len(served) * batch,
           "batch": batch, "cnn": cnn, "traced_batches": traced_batches,
           "trace": summary, "x_bytes": 4}
    del stream, packed
    if cuda:
        torch.cuda.empty_cache()

    g = traffic.rng(cell.seed, _SAMPLE)
    picks = sorted(g.choice(sorted(served), size=min(
        mix["check"]["batches"], len(served)), replace=False).tolist())
    limit = cell.config["checks"]["logit_gap_rel"]
    checks = {}
    if picks:
        idx = np.concatenate([np.arange(batch) + (j % (len(pool) // batch))
                              * batch for j in picks])
        got = np.concatenate([served[j] for j in picks])
        want, control = reference(cell, calib_np, pool_np[idx], dev)
        checks["logit_gap_rel"] = (gap(got, want), limit)
        if control is not None:
            checks["control_logit_gap_rel"] = (gap(control, want), limit)
    else:
        checks["logit_gap_rel"] = (float("inf"), limit)
    rec["checked_images"] = len(picks) * batch
    return Outcome(rec=rec, checks=checks, attempted=len(served) * batch,
                   failed=0, memory_peak_bytes=peak, trace=summary)


def gap(got: np.ndarray, want: np.ndarray) -> float:
    """The widest logit difference over the reference's logit RMS."""
    got, want = got.astype(np.float64), want.astype(np.float64)
    return float(np.abs(got - want).max() / np.sqrt((want ** 2).mean()))


def reference(cell, calib_np, images_np, dev):
    """The reference's logits of ``images_np`` and, when the cell's hooks
    ask for the control (``control_dtype``), the reference's logits with
    its activations in that type."""
    cnn, ap = cell.config["cnn"], cell.config["approx"]
    tree = weights.resnet_tree(cnn, cell.seed, dev)
    ranges = ref_cnn.calibrate(tree, cnn, torch.from_numpy(calib_np).to(dev))
    nets = [ref_cnn.ResNet(tree, cnn, ap, ranges)]
    if "control_dtype" in cell.hooks:
        nets.append(ref_cnn.ResNet(tree, cnn, ap, ranges,
                                   getattr(torch, cell.hooks["control_dtype"])))
    # in the program's batches, so that every reduction has its shape
    b = cell.traffic["batch"]
    outs = []
    for net in nets:
        outs.append(np.concatenate([
            net(torch.from_numpy(images_np[i:i + b]).to(dev)).cpu().numpy()
            for i in range(0, len(images_np), b)]))
    return outs[0], (outs[1] if len(outs) > 1 else None)
