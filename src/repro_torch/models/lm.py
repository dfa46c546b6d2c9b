"""Transformer LM (port of ``repro.models.lm``): GQA or MLA attention,
swiglu, gelu or MoE MLPs with optional leading dense layers, RoPE / M-RoPE
/ no positions, causal or bidirectional attention, token or embedding
inputs; the full-sequence forward, the lock-step prefill/decode surface
and the continuous-batching slot surface.

``forward`` and ``prefill`` take ``batch["embeds"]`` (B, T, d_model) in
place of ``batch["tokens"]`` when it is present (the stubbed vision and
audio frontends), and ``batch["positions"]``, (B, T) or M-RoPE's
(3, B, T), in place of 0..T-1.  Decode steps read token ids through the
table, their positions continuing from the cache's (broadcast to the
three M-RoPE axes), as the reference's do.

Parameters are a nested dict keyed like the reference's tree: ``embed``,
``blocks`` (every leaf stacked with a leading layer axis, as the
reference's scanned stack; packed stacks are ``LayerStack`` modules),
``dense_blocks`` (a list, one dict a leading dense layer of an MoE arch:
``first_dense_layers``, a swiglu MLP of width ``d_ff``) and
``final_norm``.  The layer ``lax.scan`` becomes a Python loop.

Prefill attention runs the flash kernel on the card for GQA
(:func:`repro_torch.kernels.flash_attention.flash_attention` on the whole
(B, Hq, T, d) block: the kernel tiles the query axis itself, so the
reference's ``Q_CHUNK`` scan is not needed) and the plain ``_sdpa`` on the
CPU, as the reference does.  MLA's attention is plain on both, with the
reference's ``Q_CHUNK`` scan over queries above 1024 tokens.

The cache holds one leaf a layer group and attention key: GQA's ``k``,
``v`` (L, B, Hkv, S, hd), MLA's ``latent`` (L, B, S, r) and ``rope`` (L,
B, S, dr), and the same keys prefixed ``dense_`` for the leading dense
layers.  Every leaf has its sequence axis at -2.  The lock-step cache adds
``pos``; :func:`decode_step` writes it IN PLACE and returns the same dict.
The pooled slot cache adds ``lengths`` (slots,) int32; :func:`decode_slots`
UPDATES IT IN PLACE (the cache writes and the cursor advance) and returns
the same dict; the reference returns a new pytree, which at olmo-1b width
would copy the whole cache every step.

The paged layout (:func:`init_paged_slot_cache`, driven by
``repro_torch.serving.paged``) indexes the leaves by physical block on
axis 1 instead: ``(L, num_blocks, ..., block_size, d)``, with per-slot
block tables passed to :func:`decode_slots`.  A step writes only its valid
entries, in place, at their (block, offset) and gathers each slot's blocks
into a contiguous view of the contiguous layout's key length for
attention, so the attention arithmetic has the contiguous layout's shapes.

An MLA cache is never int8: the reference writes the latent with a raw
cast, which zeroes most of an RMS-normed latent (ROADMAP queue 3), so the
cache constructors refuse it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import seeded_generator
from repro_torch.configs.base import ArchConfig
from repro_torch.core.approx_linear import (LayerStack, QuantizedDense, dense,
                                            layer_params)
from repro_torch.kernels import flash_attention as fak
from repro_torch.nn import attention as attn_lib
from repro_torch.nn import moe as moe_lib
from repro_torch.nn.layers import (apply_norm, embed, gelu_mlp, init_gelu_mlp,
                                   init_norm, init_swiglu, swiglu)
from repro_torch.quant import observers

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: live MLA score tile: (B, H, Q_CHUNK, T)
Q_CHUNK = 1024


def _dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def init_block(cfg: ArchConfig, generator: torch.Generator,
               device=None) -> dict:
    """One layer's float32 parameters (the reference's distributions:
    trunc-normal/sqrt(fan-in) linears); ``cfg.mlp == "moe"`` gives the MoE
    MLP, a dense layer of an MoE arch takes ``dataclasses.replace(cfg,
    mlp="swiglu")``."""
    d = cfg.d_model
    p = {"attn_norm": init_norm(cfg.norm, d, device),
         "mlp_norm": init_norm(cfg.norm, d, device)}
    if cfg.attn == "mla":
        p["attn"] = attn_lib.init_mla(cfg.mla_config(), generator=generator,
                                      device=device)
    else:
        p["attn"] = attn_lib.init_attention(cfg.attn_config(),
                                            generator=generator,
                                            device=device)
    if cfg.mlp == "moe":
        p["mlp"] = moe_lib.init_moe(cfg.moe_config(), generator=generator,
                                    device=device)
    else:
        p["mlp"] = (init_gelu_mlp if cfg.mlp == "gelu" else init_swiglu)(
            d, cfg.d_ff, generator=generator, device=device)
    return p


def stack_layers(nodes: list):
    """Per-layer trees -> one stacked tree: tensors on a new leading layer
    axis, packed modules into a :class:`LayerStack` (a serving tree built
    a layer at a time)."""
    if isinstance(nodes[0], dict):
        return {k: stack_layers([n[k] for n in nodes]) for k in nodes[0]}
    if isinstance(nodes[0], torch.nn.Module):
        return LayerStack(nodes)
    return torch.stack(nodes)


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> dict:
    """Seeded float32 init (the reference's distributions: normal*0.02
    embedding, trunc-normal/sqrt(fan-in) linears), built on ``device``."""
    gen = seeded_generator(device, seed)
    d = cfg.d_model
    table = torch.randn(cfg.vocab, d, generator=gen, device=device) * 0.02
    blocks = [init_block(cfg, gen, device) for _ in range(cfg.n_scan_layers)]
    p = {"embed": {"table": table}, "blocks": stack_layers(blocks),
         "final_norm": init_norm(cfg.norm, d, device)}
    if cfg.first_dense_layers:
        dense_cfg = dataclasses.replace(cfg, mlp="swiglu")
        p["dense_blocks"] = [init_block(dense_cfg, gen, device)
                             for _ in range(cfg.first_dense_layers)]
    if not cfg.tie_embeddings:
        p["lm_head"] = {"w": torch.randn(d, cfg.vocab, generator=gen,
                                         device=device) * d ** -0.5}
    return p


def _logits_head(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Unembedding (tied table or linear leaf, float or packed) -> f32."""
    head = params.get("lm_head", params["embed"])
    if isinstance(head, QuantizedDense):
        return dense(head, x, name="lm_head").to(torch.float32)
    w = head["table"].T if "table" in head else head["w"]
    return torch.matmul(x, w.to(x.dtype)).to(torch.float32)


def _gqa_full(bp: dict, h: torch.Tensor, cfg: ArchConfig, positions,
              want_cache: bool):
    """Full-sequence attention, h (B, T, D); returns (out, cache entry
    {"k", "v": (B, Hkv, T, hd)} or None)."""
    acfg = cfg.attn_config()
    b, t, _ = h.shape
    q, k, v = attn_lib._project_qkv(bp, h, acfg,
                                    attn_lib._angles(acfg, positions))
    if h.device.type == "cuda":
        ctx = fak.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2),
                                  causal=acfg.causal).transpose(1, 2)
    else:
        ctx = attn_lib._sdpa(q, k, v, causal=acfg.causal)
    out = dense(bp["o"], ctx.reshape(b, t, acfg.q_dim), name="o")
    entry = None
    if want_cache:
        entry = {"k": k.transpose(1, 2), "v": v.transpose(1, 2)}
    return out, entry


def _mla_full(bp: dict, h: torch.Tensor, cfg: ArchConfig, positions,
              want_cache: bool):
    """Full-sequence decompressed MLA, h (B, T, D), the queries scanned in
    Q_CHUNK pieces above Q_CHUNK tokens; returns (out, cache entry
    {"latent" (B, T, r), "rope" (B, T, dr)} or None)."""
    mcfg = cfg.mla_config()
    b, t, _ = h.shape
    q_nope, q_rope = attn_lib._mla_q(bp, h, mcfg, positions)
    latent, k_rope = attn_lib._mla_latent(bp, h, mcfg, positions)
    k_nope, v = attn_lib.mla_kv(bp, latent, mcfg)
    if t <= Q_CHUNK:
        ctx = attn_lib.mla_attend_full(q_nope, q_rope, k_nope, k_rope, v, 0,
                                       mcfg, h.dtype)
    else:
        if t % Q_CHUNK:
            raise ValueError(f"MLA prefill of {t} tokens: above {Q_CHUNK} "
                             f"the length must be a multiple of {Q_CHUNK}")
        ctx = torch.cat([attn_lib.mla_attend_full(
            q_nope[:, lo:lo + Q_CHUNK], q_rope[:, lo:lo + Q_CHUNK], k_nope,
            k_rope, v, lo, mcfg, h.dtype) for lo in range(0, t, Q_CHUNK)],
            dim=1)
    out = dense(bp["o"], ctx.reshape(b, t, -1), name="o")
    entry = {"latent": latent, "rope": k_rope} if want_cache else None
    return out, entry


def _mlp(bp: dict, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The layer's MLP: MoE where the layer has a router (a leading dense
    layer of an MoE arch has none), else gelu or swiglu."""
    if cfg.mlp == "moe" and "router" in bp:
        return moe_lib.moe_apply(bp, h, cfg.moe_config())
    return (gelu_mlp if cfg.mlp == "gelu" else swiglu)(bp, h)


def _block_forward(bp: dict, x: torch.Tensor, cfg: ArchConfig, positions,
                   want_cache: bool = False):
    h = apply_norm(cfg.norm, bp.get("attn_norm"), x)
    full = _mla_full if cfg.attn == "mla" else _gqa_full
    a, entry = full(bp["attn"], h, cfg, positions, want_cache)
    x = (x + a).to(x.dtype)
    h = apply_norm(cfg.norm, bp.get("mlp_norm"), x)
    return (x + _mlp(bp["mlp"], h, cfg)).to(x.dtype), entry


def _positions(positions, b: int, t: int, device) -> torch.Tensor:
    """The caller's (B, T) or (3, B, T) position ids, else 0..T-1."""
    if positions is None:
        return torch.arange(t, device=device).expand(b, t)
    return torch.as_tensor(positions, device=device)


def _embed_input(params: dict, batch: dict) -> torch.Tensor:
    if "embeds" in batch:
        return batch["embeds"]
    return embed(params["embed"], batch["tokens"])


def _layers(params: dict, cfg: ArchConfig):
    """(cache key prefix, layer index, layer params, observer scope) of
    every layer in order: the leading dense layers, then the stack."""
    for i, bp in enumerate(params.get("dense_blocks", [])):
        yield "dense_", i, bp, ("dense_blocks", i)
    for i in range(cfg.n_scan_layers):
        yield "", i, layer_params(params["blocks"], i), ("blocks", i)


def backbone(params: dict, x: torch.Tensor, cfg: ArchConfig,
             positions=None) -> torch.Tensor:
    """Embedded input -> final-norm output (the forward path).  The dense
    layers run under their ``dense_blocks/i`` scope, the stack unscoped,
    as the reference's scan."""
    x = x.to(_dtype(cfg.compute_dtype))
    positions = _positions(positions, x.shape[0], x.shape[1], x.device)
    for prefix, _, bp, scope in _layers(params, cfg):
        with observers.scope(*(scope if prefix else ())):
            x, _ = _block_forward(bp, x, cfg, positions)
    return apply_norm(cfg.norm, params.get("final_norm"), x)


def forward(params: dict, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """Full-sequence logits (B, T, V) float32."""
    x = backbone(params, _embed_input(params, batch), cfg,
                 batch.get("positions"))
    return _logits_head(params, x)


def _attn_keys(cfg: ArchConfig) -> tuple[str, str]:
    """The cache keys of one attention layer."""
    return ("latent", "rope") if cfg.attn == "mla" else ("k", "v")


def _check_cache_dtype(cfg: ArchConfig, dtype: torch.dtype) -> None:
    if cfg.attn == "mla" and dtype == torch.int8:
        raise ValueError(
            f"{cfg.name}: an int8 cache is refused on an MLA arch.  The "
            "reference writes the RMS-normed latent with a raw int8 cast "
            "(no fixed-point scale), which zeroes most of it (ROADMAP queue "
            "3); serve MLA with a bfloat16 or float32 cache")


def _cache_leaves(cfg: ArchConfig, rows: int, s: int, dtype, device) -> dict:
    """Zeroed per-layer leaves for ``rows`` sequences (or blocks) of ``s``
    positions: the stack's and the dense layers' (``dense_`` keys)."""
    _check_cache_dtype(cfg, dtype)
    if cfg.attn == "mla":
        tails = {"latent": (s, cfg.kv_lora_rank), "rope": (s, cfg.qk_rope_dim)}
    else:
        tails = {k: (cfg.kv_heads, s, cfg.head_dim) for k in ("k", "v")}
    out = {}
    for prefix, n in (("", cfg.n_scan_layers),
                      ("dense_", cfg.first_dense_layers)):
        if n:
            for key, tail in tails.items():
                out[prefix + key] = torch.zeros((n, rows) + tail, dtype=dtype,
                                                device=device)
    return out


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Stacked-over-layers lock-step decode cache."""
    return {**_cache_leaves(cfg, batch, max_len, dtype, device), "pos": 0}


def prefill(params: dict, batch: dict, cfg: ArchConfig, max_len: int,
            cache_dtype=torch.bfloat16) -> tuple[torch.Tensor, dict]:
    """Single-pass prompt processing: last-token logits (B, V) float32 and
    the filled cache (each layer's entries written into it as they are
    made)."""
    x = _embed_input(params, batch).to(_dtype(cfg.compute_dtype))
    b, t = x.shape[:2]
    if t > max_len:
        raise ValueError(f"prompt of {t} tokens exceeds max_len {max_len}")
    positions = _positions(batch.get("positions"), b, t, x.device)
    cache = init_cache(cfg, b, max_len, cache_dtype, x.device)
    for prefix, i, bp, scope in _layers(params, cfg):
        with observers.scope(*(scope if prefix else ())):
            x, entry = _block_forward(bp, x, cfg, positions,
                                      want_cache=True)
        for key in _attn_keys(cfg):
            cache[prefix + key][i][..., :t, :] = attn_lib._to_cache(
                entry[key], cache_dtype)
    cache["pos"] = t
    x = apply_norm(cfg.norm, params.get("final_norm"), x)
    return _logits_head(params, x[:, -1]), cache


def _block_decode(bp: dict, x: torch.Tensor, lc: dict,
                  cfg: ArchConfig) -> torch.Tensor:
    """One block's decode step; ``lc`` this layer's cache views + pos."""
    h = apply_norm(cfg.norm, bp.get("attn_norm"), x)
    if cfg.attn == "mla":
        a, _ = attn_lib.mla_decode_step(bp["attn"], h, lc, cfg.mla_config())
    else:
        a, _ = attn_lib.attention_decode_step(bp["attn"], h, lc,
                                              cfg.attn_config())
    x = (x + a).to(x.dtype)
    h = apply_norm(cfg.norm, bp.get("mlp_norm"), x)
    return (x + _mlp(bp["mlp"], h, cfg)).to(x.dtype)


def decode_step(params: dict, tokens: torch.Tensor, cache: dict,
                cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    """tokens (B, 1) -> (logits (B, V) float32, cache UPDATED IN PLACE)."""
    x = embed(params["embed"], tokens).to(_dtype(cfg.compute_dtype))
    pos = int(cache["pos"])
    for prefix, i, bp, _ in _layers(params, cfg):
        lc = {k: cache[prefix + k][i] for k in _attn_keys(cfg)}
        x = _block_decode(bp, x, {**lc, "pos": pos}, cfg)
    cache["pos"] = pos + 1
    x = apply_norm(cfg.norm, params.get("final_norm"), x)
    return _logits_head(params, x[:, 0]), cache


def init_slot_cache(cfg: ArchConfig, slots: int, max_len: int,
                    dtype=torch.bfloat16, device=None) -> dict:
    """Pooled (slots, ...) decode cache with per-slot write cursors."""
    return {**_cache_leaves(cfg, slots, max_len, dtype, device),
            "lengths": torch.zeros(slots, dtype=torch.int32, device=device)}


def init_paged_slot_cache(cfg: ArchConfig, num_blocks: int, block_size: int,
                          slots: int, dtype=torch.bfloat16,
                          device=None) -> dict:
    """Block-pool decode cache: every leaf indexed by PHYSICAL block id on
    axis 1, ``(L, num_blocks, ..., block_size, d)``, and the per-slot
    write cursors.  Block 0 is the NULL block padding table entries point
    at: it is never allocated or written, so it stays all zeros.  (The
    leaves are a slot cache of ``num_blocks`` rows of ``block_size``
    positions.)"""
    cache = init_slot_cache(cfg, num_blocks, block_size, dtype, device)
    cache["lengths"] = torch.zeros(slots, dtype=torch.int32, device=device)
    return cache


def rollback_slots(cache: dict, new_lengths) -> dict:
    """Retreat per-slot write cursors (in place).  A cursor move is a
    complete rollback: positions >= lengths[b] are masked and overwritten
    before they are attended."""
    cache["lengths"].copy_(torch.as_tensor(np.asarray(new_lengths),
                                           dtype=torch.int32))
    return cache


def _slot_update(cache_arr: torch.Tensor, update: torch.Tensor, idx) -> None:
    """Per-row write, in place: row b's first ``n_valid[b]`` update columns
    land at [lengths[b], lengths[b] + n_valid[b]) on the -2 axis.  ``idx``
    = (row, cache column, update column) of every valid entry; padding
    columns are not written at all, so no write can clamp over history.
    cache_arr (B, ..., S, d), update (B, ..., C, d)."""
    rows, cols, src = idx
    cache_arr[rows, ..., cols, :] = update[rows, ..., src, :]


def _paged_update(pool: torch.Tensor, update: torch.Tensor, idx) -> None:
    """The paged layout's write, in place: ``idx`` = (row, block id,
    offset in the block, update column) of every valid entry.  pool (NB,
    ..., bs, d), update (B, ..., C, d)."""
    rows, blocks, offs, src = idx
    pool[blocks, ..., offs, :] = update[rows, ..., src, :]


def _paged_gather(pool: torch.Tensor, tables: torch.Tensor,
                  kv_len: int) -> torch.Tensor:
    """Each slot's logically contiguous entries from its blocks: pool (NB,
    ..., bs, d), tables (slots, nb) -> (slots, ..., kv_len, d), the
    contiguous layout's key length (the excess of the last block is cut
    off)."""
    g = pool[tables].movedim(1, -3)  # (slots, ..., nb, bs, d)
    g = g.reshape(g.shape[:-3] + (g.shape[-3] * g.shape[-2], g.shape[-1]))
    return g[..., :kv_len, :]


def _write_read(arr: torch.Tensor, upd: torch.Tensor, idx, paged):
    """Writes one layer's new entries of one key into its cache leaf and
    returns what attention reads: the leaf itself (contiguous) or the
    gathered view (``paged`` = (tables, kv_len))."""
    upd = attn_lib._to_cache(upd, arr.dtype)
    if paged is None:
        _slot_update(arr, upd, idx)
        return arr
    _paged_update(arr, upd, idx)
    return _paged_gather(arr, *paged)


def _gqa_slots(bp: dict, h: torch.Tensor, lc: dict, idx, angles, mask,
               cfg: ArchConfig, paged=None) -> torch.Tensor:
    """Multi-token slot attention.  h (B, C, D); lc k/v this layer's cache
    leaves (written in place): (B, Hkv, S, hd), or block pools with
    ``paged``; ``angles`` the RoPE tables and ``mask`` (B, C, S) the
    visible keys, both shared by every layer of the step."""
    acfg = cfg.attn_config()
    b, c, _ = h.shape
    q, k, v = attn_lib._project_qkv(bp, h, acfg, angles)
    k_c = _write_read(lc["k"], k.transpose(1, 2), idx, paged)
    v_c = _write_read(lc["v"], v.transpose(1, 2), idx, paged)
    hq, hkv, d = acfg.n_heads, acfg.kv_heads, acfg.head_dim
    qg = q.reshape(b, c, hkv, hq // hkv, d)
    logits = torch.einsum("bqhgd,bhkd->bhgqk", qg,
                          attn_lib._from_cache(k_c, q.dtype)) * (d ** -0.5)
    logits = logits.masked_fill(~mask[:, None, None], float("-inf"))
    probs = torch.softmax(logits.to(torch.float32), dim=-1).to(q.dtype)
    ctx = torch.einsum("bhgqk,bhkd->bqhgd", probs,
                       attn_lib._from_cache(v_c, q.dtype))
    return dense(bp["o"], ctx.reshape(b, c, acfg.q_dim), name="o")


def _mla_slots(bp: dict, h: torch.Tensor, lc: dict, idx, positions, mask,
               cfg: ArchConfig, paged=None) -> torch.Tensor:
    """Weight-absorbed MLA slot attention over the pooled latent cache: lc
    latent (B, S, r) and rope (B, S, dr), or block pools with ``paged``,
    written in place; ``positions`` (B, C) and ``mask`` (B, C, S)."""
    mcfg = cfg.mla_config()
    q_nope, q_rope = attn_lib._mla_q(bp, h, mcfg, positions)
    latent_t, k_rope_t = attn_lib._mla_latent(bp, h, mcfg, positions)
    lat_c = _write_read(lc["latent"], latent_t, idx, paged)
    rope_c = _write_read(lc["rope"], k_rope_t, idx, paged)
    ctx = attn_lib.mla_attend_latent(bp, q_nope, q_rope, lat_c.to(h.dtype),
                                     rope_c.to(h.dtype), mask[:, None], mcfg,
                                     h.dtype)
    return dense(bp["o"], ctx, name="o")


def _block_decode_slots(bp: dict, x: torch.Tensor, lc: dict, idx, rope,
                        mask, cfg: ArchConfig, paged=None) -> torch.Tensor:
    """One layer of a slot step; ``rope`` the GQA angle tables, or MLA's
    positions."""
    h = apply_norm(cfg.norm, bp.get("attn_norm"), x)
    slots = _mla_slots if cfg.attn == "mla" else _gqa_slots
    a = slots(bp["attn"], h, lc, idx, rope, mask, cfg, paged)
    x = (x + a).to(x.dtype)
    h = apply_norm(cfg.norm, bp.get("mlp_norm"), x)
    return (x + _mlp(bp["mlp"], h, cfg)).to(x.dtype)


def decode_slots(params: dict, tokens: torch.Tensor, cache: dict,
                 cfg: ArchConfig, n_valid, block_tables=None,
                 kv_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """Fixed-shape continuous-batching step.

    tokens (slots, C) int — row b's first ``n_valid[b]`` entries are real
    (a prompt chunk, or one decode token), the rest padding.  Returns
    (logits (slots, C, V) float32, cache), the cache UPDATED IN PLACE with
    per-row cursors advanced by ``n_valid``.  Row b's next token is read at
    column ``n_valid[b] - 1``.  The leading dense layers run under their
    ``dense_blocks/i`` scope, the stack's under ``blocks/i``.

    ``block_tables`` (slots, nb) int selects the paged layout: row b's
    logical block i lives in physical block ``block_tables[b, i]`` of the
    block-pool cache (:func:`init_paged_slot_cache`), and attention reads
    ``kv_len`` keys a slot (default nb * block_size; the serving pool
    passes its ``max_len``, the contiguous layout's key length).  Valid
    entries are written at their (block, offset) only; a write into the
    NULL block 0 or past ``kv_len`` raises.
    """
    b, c = tokens.shape
    dev = tokens.device
    keys = _attn_keys(cfg)
    lengths = cache["lengths"].cpu().numpy().astype(np.int64)
    nv = np.asarray(n_valid.cpu() if torch.is_tensor(n_valid) else n_valid,
                    dtype=np.int64)
    pos = lengths[:, None] + np.arange(c)[None, :]
    rows, src = np.nonzero(np.arange(c)[None, :] < nv[:, None])
    cols = pos[rows, src]
    paged = None
    # every leaf's sequence (or block offset) axis is -2
    seq = cache[keys[0]].shape[-2]
    if block_tables is None:
        s = seq
        dst = (cols,)
    else:
        bt = np.asarray(block_tables.cpu() if torch.is_tensor(block_tables)
                        else block_tables, dtype=np.int64)
        bs = seq
        s = kv_len if kv_len is not None else bt.shape[1] * bs
        if s > bt.shape[1] * bs:
            raise ValueError(f"kv_len {s} exceeds the block tables' "
                             f"{bt.shape[1]} x {bs} positions")
    if cols.size and cols.max() >= s:
        raise ValueError(f"slot write past the cache capacity {s}")
    if block_tables is not None:
        blocks = bt[rows, cols // bs]
        if (blocks == 0).any():
            raise ValueError("slot write into the NULL block: a valid "
                             "position without an allocated block")
        dst = (blocks, cols % bs)
        paged = (torch.as_tensor(bt, device=dev), s)
    idx = tuple(torch.as_tensor(a, device=dev)
                for a in (rows, *dst, src))
    positions = torch.as_tensor(pos, device=dev)
    rope = (positions if cfg.attn == "mla"
            else attn_lib._angles(cfg.attn_config(), positions))
    # causal + filled-cache combined: key j visible to query i iff j <= pos_i
    mask = torch.arange(s, device=dev)[None, None, :] <= positions[:, :, None]

    x = embed(params["embed"], tokens).to(_dtype(cfg.compute_dtype))
    for prefix, i, bp, scope in _layers(params, cfg):
        lc = {k: cache[prefix + k][i] for k in keys}
        with observers.scope(*scope):
            x = _block_decode_slots(bp, x, lc, idx, rope, mask, cfg, paged)
    cache["lengths"] += torch.as_tensor(nv, dtype=torch.int32, device=dev)
    x = apply_norm(cfg.norm, params.get("final_norm"), x)
    return _logits_head(params, x), cache
