"""Online approximation-error probe (port of ``repro.quant.error_probe``):
approximate-vs-exact output deltas of a running engine.

Every N steps the engine re-runs one already-scheduled batch row through
the model twice:

  1. the normal approximate path, with a thread-local recorder active
     that, at every packed dense layer, also computes the exact-int8
     reference on the SAME quantized codes
     (:func:`repro_torch.quant.quantize.quantized_linear` with
     ``mode="exact"``) and accumulates elementwise moments of
     ``y_approx - y_exact`` per layer path;
  2. the exact-override path, where every packed dense RETURNS the exact
     reference, so the final logits are the exact-int8 logits.

Both passes share the uint8 codes and quant params, so the deltas isolate
approximation error from quantization error: the control variate's
residual.  Under ``int8`` numerics the per-layer variance is ~0 (the
folded fast path against the integer reference), under ``perforated``
without the CV it is larger than with it.

The hooks live in :func:`repro_torch.core.approx_linear.dense` /
``dense_group``: one thread-local ``None`` check a call when no recorder
is active, which is always the case outside :meth:`ErrorProbe.run`.

The reference probes against the immutable pre-step cache.  The port's
caches are written in place, so the probe runs on a PRIVATE copy of the
row's state and never touches the live cache:

  * contiguous layout: a clone of the row's stripe with its cursor set to
    the pre-step length (positions below it are the same after the step;
    the step's own positions are overwritten by the probe's write);
  * paged layout: the blocks the row's table names, copied into a
    private pool behind a remapped table, block 0 the NULL block.

Cost: two single-row forwards a probe, plus the copy of one row's KV.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.quant.quantize import quantized_linear

_STATE = threading.local()


def active():
    """The thread-local :class:`ProbeRecorder`, or None (the common case:
    the only check on the serving path)."""
    return getattr(_STATE, "probe", None)


def exact_dense(p, x: torch.Tensor) -> torch.Tensor:
    """Exact-int8 reference output (float32) for a packed layer or fused
    group: the same quantized codes through the exact multiplier, no CV."""
    return quantized_linear(x, p.pack, p.a_qp, "exact", 0, use_cv=False)


def _moments(d: torch.Tensor) -> torch.Tensor:
    """(n, mean, var) of a delta, in float64 on its device."""
    d = d.reshape(-1)
    return torch.stack([torch.tensor(float(d.numel()), dtype=torch.float64,
                                     device=d.device),
                        d.mean(), d.var(unbiased=False)])


class ProbeRecorder:
    """Thread-local probe context for ONE forward.

    mode ``"observe"``: packed dense layers run normally; each also
    computes the exact reference and records the moments of the delta
    under its layer path.  mode ``"exact"``: packed dense layers RETURN
    the exact reference.  Nested recorders are refused.

    The moments stay on the device until :attr:`layers` is read, which
    brings every layer's three numbers back in one transfer and merges
    repeated keys in call order (Chan's formula, as the reference)."""

    def __init__(self, mode: str) -> None:
        if mode not in ("observe", "exact"):
            raise ValueError(f"probe mode must be observe|exact, got {mode!r}")
        self.mode = mode
        self._keys: list[str] = []
        self._moments: list[torch.Tensor] = []

    def observe(self, path: str, name: str, delta: torch.Tensor) -> None:
        if delta.numel() == 0:
            return
        self._keys.append(f"{path}/{name}" if path else name)
        self._moments.append(_moments(delta.to(torch.float64)))

    @property
    def layers(self) -> dict[str, tuple[int, float, float]]:
        """layer path -> (n, mean, var) over elementwise deltas."""
        from repro_torch.serving.metrics import _merge_moments

        out: dict[str, tuple[int, float, float]] = {}
        if not self._moments:
            return out
        host = torch.stack(self._moments).cpu().numpy()
        for key, (n, mean, var) in zip(self._keys, host):
            out[key] = _merge_moments(out.get(key, (0, 0.0, 0.0)),
                                      (int(n), float(mean), float(var)))
        return out

    def __enter__(self) -> "ProbeRecorder":
        if active() is not None:
            raise RuntimeError("nested ProbeRecorder")
        _STATE.probe = self
        return self

    def __exit__(self, *exc) -> None:
        _STATE.probe = None


def _private_contiguous(cache: dict, row: int, length: int) -> dict:
    """A copy of one slot's stripe of a contiguous slot cache, its cursor
    at ``length``: every leaf but ``lengths`` is (L, slots, ...)."""
    out = {k: v[:, row:row + 1].clone() for k, v in cache.items()
           if k != "lengths"}
    out["lengths"] = torch.tensor([length], dtype=cache["lengths"].dtype,
                                  device=cache["lengths"].device)
    return out


def _private_paged(cache: dict, table: np.ndarray, length: int,
                   n_tokens: int, block_size: int) -> tuple[dict, np.ndarray]:
    """The blocks of one slot's table that positions [0, length +
    n_tokens) use, copied into a private block pool (block 0 the zero NULL
    block), and the table remapped onto it."""
    n_blocks = -(-(length + n_tokens) // block_size)
    src = torch.as_tensor(table[:n_blocks].astype(np.int64),
                          device=cache["lengths"].device)
    out = {}
    for k, v in cache.items():
        if k == "lengths":
            continue
        pool = v.new_zeros((v.shape[0], n_blocks + 1) + tuple(v.shape[2:]))
        pool[:, 1:] = v.index_select(1, src)
        out[k] = pool
    out["lengths"] = torch.tensor([length], dtype=cache["lengths"].dtype,
                                  device=cache["lengths"].device)
    remap = np.zeros((1, table.shape[0]), np.int32)
    remap[0, :n_blocks] = np.arange(1, n_blocks + 1)
    return out, remap


class ErrorProbe:
    """Engine-side runner: copy one scheduled row's state, run the two
    probe forwards, return the ``{row, layers, logits}`` moment report."""

    def __init__(self, api, paged: bool = False, kv_len: int | None = None,
                 block_size: int | None = None) -> None:
        if not self.supports(api):
            # the reference's refusal: its recurrent decode step cannot
            # unroll its layers for the recorder
            raise ValueError(
                "error probe requires a decode_slots that accepts "
                "unroll_layers (the scanned layer stack must unroll for "
                "the recorder to see concrete per-layer values); this "
                "model's serving step does not")
        self._decode = api.decode_slots
        self._paged = paged
        self._kv_len = kv_len
        self._block_size = block_size

    @staticmethod
    def supports(api) -> bool:
        """True for the dense slot step; the recurrent (RWKV) step is
        refused, as the reference refuses it."""
        return api.decode_slots is not None and not api.cfg.rwkv

    def run(self, params, tokens, n_valid, cache, lengths,
            block_tables=None, row: int | None = None) -> dict | None:
        """Probe one row of a served batch.

        ``tokens``/``n_valid`` are the batch arrays, ``cache`` the LIVE
        cache after the step (read, never written), ``lengths`` the
        pre-step cursors on the host and ``block_tables`` the step's
        tables (paged layout).  Returns None when no row is active."""
        nv = np.asarray(n_valid)
        if row is None:
            live = np.nonzero(nv > 0)[0]
            if live.size == 0:
                return None
            row = int(live[0])
        elif nv[row] <= 0:
            return None
        dev = cache["lengths"].device
        toks = torch.as_tensor(np.asarray(tokens)[row:row + 1],
                               dtype=torch.long, device=dev)
        nv_row = nv[row:row + 1]
        length = int(lengths[row])
        kw = {}
        if self._paged:
            private, remap = _private_paged(
                cache, np.asarray(block_tables)[row], length, int(nv[row]),
                self._block_size)
            kw = {"block_tables": remap, "kv_len": self._kv_len}
        else:
            private = _private_contiguous(cache, row, length)
        with ProbeRecorder("observe") as rec:
            logits_a, _ = self._decode(params, toks, private, nv_row, **kw)
        private["lengths"].fill_(length)
        with ProbeRecorder("exact"):
            logits_e, _ = self._decode(params, toks, private, nv_row, **kw)
        col = int(nv[row]) - 1
        d = (logits_a[0, col].to(torch.float64)
             - logits_e[0, col].to(torch.float64))
        n, mean, var, max_abs = torch.cat(
            [_moments(d), d.abs().max()[None]]).cpu().numpy()
        return {
            "row": row,
            "layers": {path: {"n": n_, "mean": m_, "var": v_}
                       for path, (n_, m_, v_) in rec.layers.items()},
            "logits": {"n": int(n), "mean": float(mean), "var": float(var),
                       "max_abs": float(max_abs)},
        }
