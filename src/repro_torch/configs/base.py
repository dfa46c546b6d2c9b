"""Architecture and engine configuration (port of ``repro.configs.base``).

Only the fields the ported paths read are kept (GQA or MLA attention with
rmsnorm or layernorm, qk-norm, QKV bias, RoPE / M-RoPE / no positions,
causal or bidirectional attention, swiglu, gelu or MoE MLPs with leading
dense layers; RWKV6); the other architecture families land with the
slices that serve them.  The
reference's ``mlp_bias`` and ``input_mode`` are not kept: its gelu MLP
always has biases and its models take embeddings whenever the batch holds
them, so neither field changes what a ported path does.
"""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Continuous-batching serving knobs (consumed by ``repro_torch.serving``).

    ``slots`` fixes the decode batch shape; ``max_len`` is the per-slot KV
    capacity; prompts are processed in ``prefill_chunk``-token pieces.
    Slot counts <= ``repro_torch.kernels.ops.DECODE_M_MAX`` run the packed
    kernels' decode tile configuration on thin decode steps.
    """

    slots: int = 8
    max_len: int = 256
    prefill_chunk: int = 32
    max_queue: int = 256
    cache_dtype: str = "bfloat16"  # "bfloat16" | "float32" | "int8"
    interleave: bool = True  # alternate prefill/decode when both are pending
    #: decode rows ride chunk-shaped prefill calls with n_valid=1, so a
    #: running decode advances every iteration; off falls back to
    #: whole-batch alternation (``interleave``)
    mixed_batches: bool = True
    #: "contiguous": a max_len KV stripe a slot; "paged": slots map
    #: positions onto refcounted blocks of a shared pool
    #: (``repro_torch.serving.paged``), with copy-on-write prefix reuse
    kv_layout: str = "contiguous"
    kv_block_size: int = 16  # tokens a KV block (paged layout)
    #: usable blocks in the pool; 0 = the contiguous layout's capacity
    #: (slots * ceil(max_len / kv_block_size))
    kv_blocks: int = 0
    #: content-hash cache of full prompt blocks (paged layout)
    prefix_cache: bool = True
    #: request-span tracing (``repro_torch.serving.telemetry``): typed span
    #: events into a per-engine ring of ``trace_buffer`` events (oldest
    #: dropped), exportable as JSONL or Chrome trace JSON
    trace: bool = False
    trace_buffer: int = 65536
    #: windowed time series: a sample of rates, depths and utilization
    #: every ``metrics_window_s`` seconds (0 disables)
    metrics_window_s: float = 0.0
    #: self-verifying speculative decode (``repro_torch.serving.
    #: speculative``): up to k greedy drafts a slot through the draft
    #: parameters, verified in one chunk-shaped exact call; 0 disables
    speculative_k: int = 0
    #: approximation-error probe (``repro_torch.quant.error_probe``):
    #: every N engine steps re-run one scheduled row through the
    #: approximate and the exact-int8 path on a private copy of its KV and
    #: record per-layer and logits error moments; 0 disables (two extra
    #: single-row forwards a probe)
    error_probe_every: int = 0
    #: NaN/divergence detection on every step's consumed logits columns:
    #: a flagged row is quarantined (KV cursor rolled back, the step
    #: replayed on the exact pack) before any token is emitted
    #: (``repro_torch.quant.faults``); implied by a fault injector
    detect_faults: bool = False
    #: A/B shadow serving (``repro_torch.serving.shadow``): every
    #: round(1/fraction)-th finished request replays teacher-forced through
    #: a second pack (``ServingEngine(shadow_params=)``); 0 disables
    shadow_fraction: float = 0.0


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "vlm", "audio", "ssm"]
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    attn: Literal["gqa", "mla", "none"] = "gqa"
    norm: Literal["rmsnorm", "layernorm", "nonparametric_ln"] = "rmsnorm"
    qk_norm: bool = False
    rope: Literal["rope", "mrope", "none"] = "rope"
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, int, int] = (16, 24, 24)
    causal: bool = True
    qkv_bias: bool = False
    # MLA (deepseek-v2)
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    mlp: Literal["swiglu", "gelu", "moe"] = "swiglu"
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0
    # rwkv
    rwkv: bool = False
    rwkv_head_dim: int = 64
    tie_embeddings: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    def attn_config(self):
        from repro_torch.nn.attention import AttnConfig

        return AttnConfig(d_model=self.d_model, n_heads=self.n_heads,
                          kv_heads=self.kv_heads, head_dim=self.head_dim,
                          causal=self.causal, qk_norm=self.qk_norm,
                          rope=self.rope, rope_theta=self.rope_theta,
                          mrope_sections=self.mrope_sections,
                          qkv_bias=self.qkv_bias)

    def mla_config(self):
        from repro_torch.nn.attention import MLAConfig

        return MLAConfig(d_model=self.d_model, n_heads=self.n_heads,
                         kv_lora_rank=self.kv_lora_rank,
                         qk_nope_dim=self.qk_nope_dim,
                         qk_rope_dim=self.qk_rope_dim,
                         v_head_dim=self.v_head_dim,
                         rope_theta=self.rope_theta)

    def moe_config(self):
        from repro_torch.nn.moe import MoEConfig

        return MoEConfig(d_model=self.d_model, d_ff_expert=self.d_ff_expert,
                         n_experts=self.n_experts, top_k=self.top_k,
                         n_shared=self.n_shared_experts)

    def rwkv_config(self):
        from repro_torch.nn.rwkv import RWKVConfig

        return RWKVConfig(d_model=self.d_model, d_ff=self.d_ff,
                          head_dim=self.rwkv_head_dim)

    @property
    def has_decode(self) -> bool:
        return self.causal  # encoder-only archs have no decode step

    @property
    def n_scan_layers(self) -> int:
        """Layers in the stacked ``blocks`` (after the dense ones)."""
        return self.n_layers - self.first_dense_layers

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head), the
        reference's formula."""
        d, ff, v, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd = self.head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.rwkv:
            tm = d * d * 5 + d * (5 * 32 + 5 * 32) + d * 64 * 2 + 2 * d
            cm = d * ff * 2 + d * d
            return emb + L * (tm + cm + 4 * d)
        if self.attn == "mla":
            attn = (d * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                    + d * (self.kv_lora_rank + self.qk_rope_dim)
                    + self.kv_lora_rank * self.n_heads
                    * (self.qk_nope_dim + self.v_head_dim)
                    + self.n_heads * self.v_head_dim * d)
        else:
            attn = (d * self.n_heads * hd + 2 * d * self.kv_heads * hd
                    + self.n_heads * hd * d)
        if self.mlp == "moe":
            moe_l = (3 * d * self.d_ff_expert * self.n_experts
                     + 3 * d * self.d_ff_expert * self.n_shared_experts
                     + d * self.n_experts)
            mlp_total = (self.n_scan_layers * moe_l
                         + self.first_dense_layers * 3 * d * ff)
        else:
            mlp_total = L * 3 * d * ff
        return emb + L * attn + mlp_total

    def active_param_count(self) -> int:
        """Activated parameters a token (MoE: only the routed top-k)."""
        if self.mlp != "moe":
            return self.param_count()
        per_expert = 3 * self.d_model * self.d_ff_expert
        return self.param_count() - self.n_scan_layers * per_expert * (
            self.n_experts - self.top_k)

    def reduced(self) -> "ArchConfig":
        """CPU smoke-test variant: same structure, tiny dims (the same
        values as ``repro.configs.base.ArchConfig.reduced``)."""
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=2 + self.first_dense_layers,
            d_model=64,
            n_heads=4,
            kv_heads=max(1, min(self.kv_heads, 2)),
            head_dim=16,
            d_ff=128,
            vocab=256,
            n_experts=8 if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            d_ff_expert=32 if self.d_ff_expert else 0,
            kv_lora_rank=32,
            qk_nope_dim=16,
            qk_rope_dim=8,
            v_head_dim=16,
            rwkv_head_dim=16,
            mrope_sections=((2, 3, 3) if self.rope == "mrope"
                            else self.mrope_sections),
            compute_dtype="float32",
        )
