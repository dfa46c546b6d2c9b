"""Compute/communication overlap and wire-compressed collectives (port of
``repro.runtime.overlap``).

  rs_matmul_overlapped   row-parallel matmul with a hand-scheduled ring
                         reduce-scatter + all-gather, chunked so that each
                         ring hop's send overlaps the NEXT chunk's matmul.
                         Semantically y = x @ W with x, W sharded on the
                         contraction axis; the plain form is one matmul
                         and an all-reduce, which serializes the wire
                         behind the whole matmul.  Here the matmul is n
                         independent (K/n x N/n) products interleaved with
                         the ring's sends (``batch_isend_irecv``).

  compressed_psum        data-parallel gradient combine that moves int8 on
                         the wire (pairs with ``optim.grad_compress`` error
                         feedback): quantize a leaf -> all-gather (int8 +
                         float32 scale) -> dequantized mean.  Meant for the
                         cross-pod ("pod") axis, where the slow links, not
                         the fast ones, bound the step.

Both take this rank's pieces and a ``launch.mesh.Mesh``; every collective
goes through ``parallel.comm`` (counted).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.parallel import comm


def _ring_peers(mesh, axis: str) -> tuple[int, int]:
    """Global ranks of this rank's successor and predecessor on the ring
    over ``axis`` (the other coordinates fixed)."""
    c, n = dict(mesh.coord), mesh.shape[axis]
    nxt = mesh.rank_of({**c, axis: (c[axis] + 1) % n})
    prv = mesh.rank_of({**c, axis: (c[axis] - 1) % n})
    return nxt, prv


def rs_matmul_overlapped(x: torch.Tensor, w: torch.Tensor, mesh,
                         axis: str) -> torch.Tensor:
    """y = x @ W.  x: (..., K / n), this rank's piece of K over ``axis``;
    w: (K / n, N), its rows.  Returns y (..., N), the whole product on
    every rank of the axis, in x's dtype (float32 accumulation).

    Ring schedule on rank i (n = ring size, N split into n chunks):
      reduce-scatter phase, n-1 hops: the traveling accumulator for output
      chunk c = (i - s) mod n picks up this rank's partial x_i @ W_i[:, c]
      and moves on; the send of hop s overlaps the product of hop s+1 (no
      data dependence).
      all-gather phase, n-1 hops: the finished chunks circulate back."""
    n = mesh.shape[axis]
    nn = w.shape[1]
    if nn % n:
        raise ValueError(f"N={nn} is not divisible by the ring of {n}")
    chunk = nn // n
    i = mesh.coord[axis]
    group = mesh.group((axis,))
    nxt, prv = _ring_peers(mesh, axis)
    xs = x.to(torch.float32)

    def local_part(c: int) -> torch.Tensor:
        return torch.matmul(xs, w[:, c * chunk:(c + 1) * chunk].to(
            torch.float32))

    # reduce-scatter: after n-1 hops, rank i holds the summed chunk
    # (i + 1) mod n
    acc = local_part(i % n)
    for s in range(1, n):
        recv, reqs = comm.send_recv(acc, nxt, prv, group)
        part = local_part((i - s) % n)  # overlaps the hop
        for r in reqs:
            r.wait()
        acc = recv + part
    own = (i - (n - 1)) % n  # chunk id now resident on this rank

    out = torch.empty(x.shape[:-1] + (nn,), dtype=torch.float32,
                      device=x.device)
    out[..., own * chunk:(own + 1) * chunk] = acc
    blk = acc
    # the chunk resident after hop h came from rank i - h: chunk own - h
    for h in range(1, n):
        blk, reqs = comm.send_recv(blk, nxt, prv, group)
        for r in reqs:
            r.wait()
        c = (own - h) % n
        out[..., c * chunk:(c + 1) * chunk] = blk
    return out.to(x.dtype)


# kept under both names: ag_* was the working title of the design notes
ag_matmul_overlapped = rs_matmul_overlapped


def compressed_psum(grads: Any, mesh, axis: str) -> Any:
    """Data-parallel mean of gradient trees with an int8 wire format.

    Each leaf: quantize locally (absmax/127) -> all-gather (int8) +
    all-gather (scale, float32) -> dequantized mean.  ~4x fewer wire bytes
    than a float32 all-reduce; pair with ``optim.grad_compress`` error
    feedback so that the quantization bias vanishes across steps."""
    from repro_torch.optim.adamw import tree_map

    n = mesh.shape[axis]
    group = mesh.group((axis,))

    def leaf_fn(_, g):
        g32 = g.to(torch.float32)
        scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
        q = torch.clip(torch.round(g32 / scale), -127, 127).to(torch.int8)
        qs = comm.all_gather(q[None], group)  # int8 on the wire
        ss = comm.all_gather(scale.reshape(1), group)
        deq = qs.to(torch.float32) * ss.reshape((n,) + (1,) * g.ndim)
        return torch.mean(deq, dim=0).to(g.dtype)

    return tree_map(leaf_fn, grads)
