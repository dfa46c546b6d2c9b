"""Op count of one rank's step on the ``meta`` device: the port's
counterpart of ``repro.launch.hlo_analysis``.

There is no HLO here.  The reference compiles a cell for 512 placeholder
devices and reads the per-device program's dots, bytes and collectives
out of XLA's optimized HLO, multiplying scan bodies by their trip counts.
The port runs the step itself, as rank 0 of a ``launch.mesh.TracingMesh``,
on ``meta`` tensors (shapes and dtypes, no values, no memory), under a
dispatch mode that sees every ATen op of the forward and the backward:

  flops        matmuls, convolutions and attention by the formulas of
               ``torch.utils.flop_counter``'s registry; pointwise ops one
               flop an output element, reductions one an input element;
               views and copies none.
  bytes        each non-view op's tensor inputs and outputs (eager torch
               fuses nothing, so this is the eager program's traffic).
  peak live    the most bytes of tensors made inside the step alive at
               once (a tensor counts from the op that makes it until it
               is freed; views share their base's).
  kernels      each hand-written kernel call (approx-matmul, flash
               attention, the RWKV6 scan) is counted from its shapes by
               the work formulas of ``launch/roofline.py``, the ones
               ``chip_smoke.py`` bounds its measured times with; the call
               itself returns an empty output of the right shape.  The
               trace takes the card's routes (``kernels.trace_card``).
  collectives  what the step issues through ``parallel.comm`` under the
               tracing mesh: by kind, count and bytes, and the seconds of
               each at its group's link rate (NVLink inside an 8-GPU
               node, InfiniBand across nodes).

A Python layer loop runs every layer, so every layer is counted: the
counterpart of the reference's trip counts.  The dry run counts a deep
stack by difference (``count_stack``): the step at one and at two stacked
layers, the second minus the first being one layer, times the stack's
depth — what the reference's trip-count multiplication does for its scan
body, and the same numbers a full trace gives, the layers being equal.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch import roofline
from repro_torch.parallel import comm

_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod",
               "logsumexp", "_softmax", "_log_softmax", "norm",
               "linalg_vector_norm", "var", "std", "var_mean", "cumsum",
               "argmax", "argmin", "topk", "sort", "argsort"}
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "detach", "lift_fresh", "_to_copy",
               "alias", "set_"}


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of an op's arguments or results (nested lists, tuples
    and dicts)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return []
    out = []
    for t in tree:
        out.extend(_tensors(t))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class KernelWork:
    calls: int = 0
    bytes: float = 0.0
    ops: float = 0.0


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.live = 0
        self.peak = 0
        self.paused = 0

    def alloc(self, t: torch.Tensor) -> None:
        n = _nbytes(t)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.paused:
            return out
        packet = func.overloadpacket
        name = packet.__name__.rstrip("_")
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        elif torch.Tag.pointwise in func.tags:
            self.flops += sum(o.numel() for o in outs)
        elif name in _REDUCTIONS and ins:
            self.flops += ins[0].numel()
        if not func.is_view and name not in _NO_TRAFFIC:
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        ids = {id(t) for t in ins}
        for o in outs:
            if o._base is None and id(o) not in ids:
                self.alloc(o)
        return out


@contextlib.contextmanager
def _kernel_stubs(counter: _Counter, kernels: dict):
    """The hand-written kernels' wrappers replaced by their work counts."""
    import repro_torch.kernels as kernels_pkg
    from repro_torch.kernels import approx_matmul as amk
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.kernels import rwkv6_scan as rsk

    def record(name: str, nbytes: float, ops: float) -> None:
        w = kernels.setdefault(name, KernelWork())
        w.calls += 1
        w.bytes += nbytes
        w.ops += ops

    def made(*shape_dtype):
        counter.paused += 1
        try:
            outs = [torch.empty(s, dtype=d, device="meta")
                    for s, d in shape_dtype]
        finally:
            counter.paused -= 1
        for o in outs:
            counter.alloc(o)
        return outs

    def fused(x, w_qbt, epilogue, meta, *, k, n, mode, m, use_cv=True):
        nbytes, ops = roofline.approx_matmul_work(
            x.shape[0], k, n, w_qbt.numel(), epilogue.numel(), meta.numel(),
            x.element_size(), x.element_size(), mode, m)
        record("approx_matmul_cv_fused", nbytes, ops)
        return made(((x.shape[0], n), x.dtype))[0]

    def flash(q, k, v, *, causal=True, window=None, scale=None):
        b, hq, tq, d = q.shape
        nbytes, flops = roofline.flash_attention_work(
            b, hq, k.shape[1], tq, k.shape[2], d, causal, window,
            q.element_size())
        record("flash_attention", nbytes, flops)
        return made((tuple(q.shape), q.dtype))[0]

    def scan(r, k, v, w, u, *, chunk=rsk.DEFAULT_CHUNK):
        b, t, h, dk = r.shape
        dv = v.shape[-1]
        nbytes, flops = roofline.rwkv6_scan_work(b, t, h, dk, dv,
                                                 r.element_size(), chunk)
        record("rwkv6_scan", nbytes, flops)
        return tuple(made(((b, t, h, dv), torch.float32),
                          ((b, h, dk, dv), torch.float32)))

    saved = (amk.approx_matmul_cv_fused, fak.flash_attention,
             rsk.rwkv6_scan, kernels_pkg.trace_card)
    amk.approx_matmul_cv_fused, fak.flash_attention = fused, flash
    rsk.rwkv6_scan, kernels_pkg.trace_card = scan, True
    try:
        yield
    finally:
        (amk.approx_matmul_cv_fused, fak.flash_attention, rsk.rwkv6_scan,
         kernels_pkg.trace_card) = saved


@dataclasses.dataclass
class OpCount:
    flops: float
    bytes_accessed: float
    peak_live_bytes: int
    argument_bytes: int
    output_bytes: int
    kernels: dict
    collectives: dict
    collective_counts: dict
    collective_seconds: float

    @property
    def int8_ops(self) -> float:
        w = self.kernels.get("approx_matmul_cv_fused")
        return w.ops if w else 0.0

    @property
    def tf32_flops(self) -> float:
        w = self.kernels.get("rwkv6_scan")
        return w.ops if w else 0.0

    def terms(self) -> roofline.RooflineTerms:
        """The roofline terms: the plain ops' flops and flash's at the bf16
        rate, the scan's at the TF32 rate, the approx kernel's at the int8
        rate."""
        flops = self.flops + sum(w.ops for w in self.kernels.values())
        kernel_bytes = sum(w.bytes for w in self.kernels.values())
        return roofline.RooflineTerms(
            flops=flops, bytes_accessed=self.bytes_accessed + kernel_bytes,
            collective_bytes=float(sum(self.collectives.values())),
            collectives=dict(self.collectives),
            collective_counts=dict(self.collective_counts),
            int8_ops=self.int8_ops, tf32_flops=self.tf32_flops,
            collective_seconds=self.collective_seconds,
            raw_cost={"plain_op_flops": self.flops,
                      "int8_ops": self.int8_ops,
                      "tf32_flops": self.tf32_flops,
                      "kernels": {k: dataclasses.asdict(w)
                                  for k, w in self.kernels.items()}})


def count(fn, *args) -> tuple[OpCount, object]:
    """Runs ``fn(*args)`` on ``meta`` tensors under the counter (a
    ``TracingMesh`` in ``args`` or ``fn`` makes its collectives traced)
    and returns (the count, ``fn``'s result)."""
    comm.reset_counts()
    counter = _Counter()
    kernels: dict = {}
    arg_bytes = sum(map(_nbytes, _tensors(args)))
    with _kernel_stubs(counter, kernels), counter:
        out = fn(*args)
    coll_s = sum(nbytes / roofline.link_rate(g.ranks)
                 for _, nbytes, g in comm.LOG)
    res = OpCount(
        flops=counter.flops,
        bytes_accessed=counter.bytes, peak_live_bytes=counter.peak,
        argument_bytes=arg_bytes,
        output_bytes=sum(map(_nbytes, _tensors(out))), kernels=kernels,
        collectives={k: int(v) for k, v in comm.BYTES.items()},
        collective_counts={k: int(v) for k, v in comm.COUNTS.items()},
        collective_seconds=coll_s)
    return res, out


def _combine(a: OpCount, b: OpCount, n: int) -> OpCount:
    """a + n * (b - a), field by field: ``a`` a one-layer stack's count,
    ``b`` a two-layer stack's, ``n`` the stack's depth - 1."""
    def lin(x, y):
        return x + n * (y - x)

    def lin_d(x: dict, y: dict) -> dict:
        return {k: lin(x.get(k, 0), y.get(k, 0)) for k in set(x) | set(y)}

    kernels = {k: KernelWork(*(lin(getattr(a.kernels.get(k, KernelWork()),
                                           f),
                                   getattr(b.kernels.get(k, KernelWork()), f))
                               for f in ("calls", "bytes", "ops")))
               for k in set(a.kernels) | set(b.kernels)}
    return OpCount(
        flops=lin(a.flops, b.flops),
        bytes_accessed=lin(a.bytes_accessed, b.bytes_accessed),
        peak_live_bytes=lin(a.peak_live_bytes, b.peak_live_bytes),
        argument_bytes=lin(a.argument_bytes, b.argument_bytes),
        output_bytes=lin(a.output_bytes, b.output_bytes), kernels=kernels,
        collectives=lin_d(a.collectives, b.collectives),
        collective_counts=lin_d(a.collective_counts, b.collective_counts),
        collective_seconds=lin(a.collective_seconds, b.collective_seconds))


def count_stack(make, depth: int) -> OpCount:
    """The count of a step whose stack has ``depth`` layers: ``make(d)``
    returns (fn, args) of the step at stack depth d; counted at depth 1
    and 2 and extended linearly (the layers are equal), or counted whole
    at depth <= 2."""
    if depth <= 2:
        return count(*_call(make(depth)))[0]
    one = count(*_call(make(1)))[0]
    two = count(*_call(make(2)))[0]
    return _combine(one, two, depth - 1)


def _call(fn_args):
    fn, args = fn_args
    return (fn, *args)
