"""RWKV6 (Finch) language model, the attention-free family (port of
``repro.models.rwkv_lm``: lock-step and slot surfaces).

Same public surface as :mod:`repro_torch.models.lm`: ``init_params``,
``forward``, ``init_cache``, ``prefill``, ``decode_step``,
``init_slot_cache``, ``decode_slots``.  The decode "cache" is the
constant-size recurrent state: per-layer shift vectors and WKV matrices.
:func:`decode_step` and :func:`decode_slots` update it IN PLACE and return
the same dict.  The layer ``lax.scan`` becomes a Python loop; the
reference's sharding constraints and remat have no counterpart without a
mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import seeded_generator
from repro_torch.configs.base import ArchConfig
from repro_torch.core.approx_linear import QuantizedDense, dense, layer_params
from repro_torch.nn import rwkv as rwkv_lib
from repro_torch.nn.layers import apply_norm, embed, init_norm

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> dict:
    """Seeded float32 init with the reference's distributions, built on
    ``device``."""
    gen = seeded_generator(device, seed)
    d = cfg.d_model
    rcfg = cfg.rwkv_config()
    layers = [{"ln1": init_norm("layernorm", d, device),
               "tm": rwkv_lib.init_time_mix(rcfg, generator=gen,
                                            device=device),
               "ln2": init_norm("layernorm", d, device),
               "cm": rwkv_lib.init_channel_mix(rcfg, generator=gen,
                                               device=device)}
              for _ in range(cfg.n_layers)]

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return torch.stack(nodes)

    return {
        "embed": {"table": torch.randn(cfg.vocab, d, generator=gen,
                                       device=device) * 0.02},
        "ln0": init_norm("layernorm", d, device),
        "blocks": stack(layers),
        "final_norm": init_norm("layernorm", d, device),
        "lm_head": {"w": torch.randn(d, cfg.vocab, generator=gen,
                                     device=device) * d ** -0.5},
    }


def _block(bp: dict, x: torch.Tensor, cfg: ArchConfig):
    """One block from a zero state: (x, {shift_tm, shift_cm, wkv})."""
    h = apply_norm("layernorm", bp["ln1"], x)
    tm_out, shift_tm, wkv = rwkv_lib.time_mix(bp["tm"], h, cfg.rwkv_config())
    x = x + tm_out
    h = apply_norm("layernorm", bp["ln2"], x)
    cm_out, shift_cm = rwkv_lib.channel_mix(bp["cm"], h)
    x = x + cm_out
    return x, {"shift_tm": shift_tm, "shift_cm": shift_cm, "wkv": wkv}


def backbone(params: dict, x: torch.Tensor, cfg: ArchConfig,
             want_states: bool = False):
    """Embedded input -> (final-norm output, per-layer states or None)."""
    x = apply_norm("layernorm", params["ln0"],
                   x.to(_DTYPES[cfg.compute_dtype]))
    states = []
    for i in range(cfg.n_layers):
        x, st = _block(layer_params(params["blocks"], i), x, cfg)
        if want_states:
            states.append(st)
    x = apply_norm("layernorm", params["final_norm"], x)
    return x, (states if want_states else None)


def _logits_head(params: dict, x: torch.Tensor) -> torch.Tensor:
    head = params["lm_head"]
    if isinstance(head, QuantizedDense):
        return dense(head, x).to(torch.float32)
    return torch.matmul(x, head["w"].to(x.dtype)).to(torch.float32)


def forward(params: dict, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    x, _ = backbone(params, embed(params["embed"], batch["tokens"]), cfg)
    return _logits_head(params, x)


def init_cache(cfg: ArchConfig, batch: int, max_len: int = 0,
               dtype=torch.bfloat16, device=None) -> dict:
    """Recurrent state, constant size (``max_len`` and ``dtype`` are
    accepted for the common surface and not used)."""
    rcfg = cfg.rwkv_config()
    n, d, cdt = cfg.n_layers, cfg.d_model, _DTYPES[cfg.compute_dtype]
    h, hd = rcfg.n_heads, rcfg.head_dim
    return {
        "shift_tm": torch.zeros((n, batch, d), dtype=cdt, device=device),
        "shift_cm": torch.zeros((n, batch, d), dtype=cdt, device=device),
        "wkv": torch.zeros((n, batch, h, hd, hd), dtype=torch.float32,
                           device=device),
        "pos": 0,
    }


def prefill(params: dict, batch: dict, cfg: ArchConfig, max_len: int = 0,
            cache_dtype=torch.bfloat16) -> tuple[torch.Tensor, dict]:
    """Last-token logits (B, V) float32 and the recurrent state after the
    prompt (each layer's WKV state from the scan)."""
    tokens = batch["tokens"]
    b, t = tokens.shape
    x, states = backbone(params, embed(params["embed"], tokens), cfg,
                         want_states=True)
    cache = init_cache(cfg, b, max_len, cache_dtype, x.device)
    for i, st in enumerate(states):
        for key in ("shift_tm", "shift_cm", "wkv"):
            cache[key][i] = st[key]
    cache["pos"] = t
    return _logits_head(params, x[:, -1]), cache


def decode_step(params: dict, tokens: torch.Tensor, cache: dict,
                cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    """tokens (B, 1) -> (logits (B, V) float32, cache UPDATED IN PLACE)."""
    rcfg = cfg.rwkv_config()
    x = embed(params["embed"], tokens).to(_DTYPES[cfg.compute_dtype])
    x = apply_norm("layernorm", params["ln0"], x)
    for i in range(cfg.n_layers):
        bp = layer_params(params["blocks"], i)
        h = apply_norm("layernorm", bp["ln1"], x)
        tm_out, shift_tm, wkv = rwkv_lib.time_mix_step(
            bp["tm"], h, rcfg, cache["shift_tm"][i], cache["wkv"][i])
        x = x + tm_out
        h = apply_norm("layernorm", bp["ln2"], x)
        cm_out, shift_cm = rwkv_lib.channel_mix(bp["cm"], h,
                                                cache["shift_cm"][i])
        x = x + cm_out
        cache["shift_tm"][i] = shift_tm
        cache["shift_cm"][i] = shift_cm
        cache["wkv"][i] = wkv
    x = apply_norm("layernorm", params["final_norm"], x)
    cache["pos"] = int(cache["pos"]) + 1
    return _logits_head(params, x[:, 0]), cache


def init_slot_cache(cfg: ArchConfig, slots: int, max_len: int = 0,
                    dtype=torch.bfloat16, device=None) -> dict:
    """Per-slot recurrent state (O(1) per slot) with per-slot cursors."""
    cache = init_cache(cfg, slots, max_len, dtype, device)
    del cache["pos"]
    cache["lengths"] = torch.zeros(slots, dtype=torch.int32, device=device)
    return cache


def decode_slots(params: dict, tokens: torch.Tensor, cache: dict,
                 cfg: ArchConfig, n_valid) -> tuple[torch.Tensor, dict]:
    """Fixed-shape continuous-batching step for the recurrent arch.

    tokens (slots, C); row b consumes its first ``n_valid[b]`` tokens, as C
    single-token steps (``time_mix_step`` and ``channel_mix``, not the
    scan) whose state writes are masked per row by ``i < n_valid[b]``:
    rows past their valid length, and idle slots (n_valid 0), keep their
    state bit-exact.  Returns (logits (slots, C, V) float32, cache UPDATED
    IN PLACE with cursors advanced by ``n_valid``)."""
    rcfg = cfg.rwkv_config()
    dev = tokens.device
    nv = torch.as_tensor(np.asarray(
        n_valid.cpu() if torch.is_tensor(n_valid) else n_valid),
        dtype=torch.int32, device=dev)
    logits = []
    for i in range(tokens.shape[1]):
        keep = i < nv  # (B,)
        x = embed(params["embed"], tokens[:, i:i + 1]).to(
            _DTYPES[cfg.compute_dtype])
        x = apply_norm("layernorm", params["ln0"], x)
        for j in range(cfg.n_layers):
            bp = layer_params(params["blocks"], j)
            st = {k: cache[k][j] for k in ("shift_tm", "shift_cm", "wkv")}
            h = apply_norm("layernorm", bp["ln1"], x)
            tm_out, shift_tm, wkv = rwkv_lib.time_mix_step(
                bp["tm"], h, rcfg, st["shift_tm"], st["wkv"])
            x = x + tm_out
            h = apply_norm("layernorm", bp["ln2"], x)
            cm_out, shift_cm = rwkv_lib.channel_mix(bp["cm"], h,
                                                    st["shift_cm"])
            x = x + cm_out
            for key, new in (("shift_tm", shift_tm), ("shift_cm", shift_cm),
                             ("wkv", wkv)):
                mask = keep.view((-1,) + (1,) * (new.ndim - 1))
                st[key].copy_(torch.where(mask, new.to(st[key].dtype),
                                          st[key]))
        x = apply_norm("layernorm", params["final_norm"], x)
        logits.append(_logits_head(params, x[:, 0]))
    cache["lengths"] += nv
    return torch.stack(logits, dim=1), cache
