"""The collectives the distributed layer issues, counted.

Every collective of ``repro_torch`` goes through this module, which adds
one to ``COUNTS[kind]`` and the bytes it moves (the larger of its input
and its output on this rank, as the reference's HLO parse counts a
collective's result) to ``BYTES[kind]`` each time it issues one.  The dry
run's reckoning (``launch/op_count.py``) is held against these counts.
The kinds are the reference's: "all-reduce", "all-gather",
"reduce-scatter", "collective-permute".

Under a ``launch.mesh.TracingMesh`` (the dry run's op count, on the
``meta`` device) the groups are :class:`FakeGroup` stand-ins: a
collective then makes an output of the right shape, is counted and
logged in ``LOG`` (kind, bytes, group), and issues nothing.

The autograd functions give each collective its adjoint, under the
convention that every rank back-propagates its own share of one global
objective: an all-gather's backward is a reduce-scatter (summed), an
all-reduce's backward an all-reduce, and a slice's backward a zero-padded
scatter.  Tensors handed to a collective are made contiguous first; a
DTensor never reaches one (the callers pass local shards).
"""

from __future__ import annotations

import collections

import torch

COUNTS: collections.Counter = collections.Counter()
BYTES: collections.Counter = collections.Counter()
LOG: list = []


class FakeGroup:
    """A traced group: the axes it spans, its size and its global ranks."""

    def __init__(self, axes: tuple[str, ...], ranks: tuple[int, ...]):
        self.axes, self.ranks, self.size = axes, ranks, len(ranks)


def reset_counts() -> None:
    COUNTS.clear()
    BYTES.clear()
    LOG.clear()


def _count(kind: str, nbytes: int, group=None) -> None:
    COUNTS[kind] += 1
    BYTES[kind] += int(nbytes)
    if isinstance(group, FakeGroup):
        LOG.append((kind, int(nbytes), group))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _size(group) -> int:
    if isinstance(group, FakeGroup):
        return group.size
    return torch.distributed.get_world_size(group)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's pieces of ``x`` concatenated along ``dim`` in group
    rank order (no autograd)."""
    n = _size(group)
    xs = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xs.shape[0],) + tuple(xs.shape[1:]),
                      dtype=x.dtype, device=x.device)
    if not isinstance(group, FakeGroup):
        torch.distributed.all_gather_into_tensor(out, xs, group=group)
    _count("all-gather", _nbytes(out), group)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Sum over the group, each rank keeping its piece along ``dim`` (no
    autograd)."""
    n = _size(group)
    xs = x.movedim(dim, 0).contiguous()
    out = torch.empty((xs.shape[0] // n,) + tuple(xs.shape[1:]),
                      dtype=x.dtype, device=x.device)
    if not isinstance(group, FakeGroup):
        rs = getattr(torch.distributed, "reduce_scatter_single", None) or \
            torch.distributed.reduce_scatter_tensor
        rs(out, xs, group=group)
    _count("reduce-scatter", _nbytes(xs), group)
    return out.movedim(0, dim)


def all_reduce(x: torch.Tensor, group, op=None) -> torch.Tensor:
    """A new tensor holding the group's reduction of ``x`` (sum by
    default; no autograd)."""
    out = x.detach().clone(memory_format=torch.contiguous_format)
    if not isinstance(group, FakeGroup):
        torch.distributed.all_reduce(
            out, op=torch.distributed.ReduceOp.SUM if op is None else op,
            group=group)
    _count("all-reduce", _nbytes(out), group)
    return out


def send_recv(send: torch.Tensor, dst: int, src: int, group):
    """Starts one ring hop: ``send`` to global rank ``dst`` and a receive
    of the same shape from ``src``.  Returns (the receive buffer, the
    requests to wait on)."""
    recv = torch.empty_like(send)
    reqs = []
    if not isinstance(group, FakeGroup):
        ops = [torch.distributed.P2POp(torch.distributed.isend,
                                       send.contiguous(), dst, group),
               torch.distributed.P2POp(torch.distributed.irecv, recv, src,
                                       group)]
        reqs = torch.distributed.batch_isend_irecv(ops)
    _count("collective-permute", _nbytes(send), group)
    return recv, reqs


def piece(x: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    """Piece ``i`` of ``n`` equal pieces of ``x`` along ``dim``."""
    step = x.shape[dim] // n
    return x.narrow(dim, i * step, step)


class _GatherFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _SliceFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, n, i):
        ctx.dim, ctx.n, ctx.i, ctx.shape = dim, n, i, x.shape
        return piece(x, dim, n, i).contiguous()

    @staticmethod
    def backward(ctx, g):
        out = g.new_zeros(ctx.shape)
        piece(out, ctx.dim, ctx.n, ctx.i).copy_(g)
        return out, None, None, None


class _AllReduceFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ShareSumFn(torch.autograd.Function):
    """The sum of every rank's share of a replicated objective: forward
    an all-reduce, backward the identity (each rank back-propagates the
    objective once, through its own share)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Differentiable all-gather along ``dim``."""
    return _GatherFn.apply(x, group, dim)


def slice_dim(x: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    """Differentiable piece ``i`` of ``n`` along ``dim`` (no collective)."""
    return _SliceFn.apply(x, dim, n, i)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-reduce (sum)."""
    return _AllReduceFn.apply(x, group)


def share_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's share of one objective summed (see ``_ShareSumFn``)."""
    return _ShareSumFn.apply(x, group)
