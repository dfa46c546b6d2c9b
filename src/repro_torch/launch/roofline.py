"""Roofline terms at H100 constants (port of ``repro.launch.roofline``),
and the work formula of each hand-written kernel.

Hardware model: one NVIDIA H100 SXM5 80 GB a mesh device, 8 to a node
(data-sheet figures, dense, no sparsity):

    PEAK_BF16  989e12  FLOP/s on the bf16 tensor cores
    PEAK_INT8  1979e12 OP/s on the int8 tensor cores (the approx-matmul
               kernel's integer products)
    HBM_BW     3.35e12 bytes/s
    NVLINK_BW  450e9   bytes/s each way, a GPU inside an 8-GPU node
    IB_BW      50e9    bytes/s a GPU, a group that spans nodes (400 Gb/s
               InfiniBand)

The profile (``launch/op_count.py``) is one rank's program, so its counts
are per device:

    compute    = bf16-rate flops / PEAK_BF16 + TF32 flops / (PEAK_BF16 / 2)
                 + the approx kernel's int8 ops / PEAK_INT8
                 (``flops`` counts all three: every operation the step does)
    memory     = bytes_accessed / HBM_BW
    collective = sum over collectives of bytes / the group's link rate

A collective's bytes are the larger of its input and its output on the
rank (the reference's per-device lower bound on wire traffic), and the
breakdown is kept per kind.  These are a model at H100 constants, not a
measurement.

The kernel work formulas (:func:`approx_matmul_work`,
:func:`flash_attention_work`, :func:`rwkv6_scan_work`) are the ones
``chip_smoke.py`` bounds the measured kernel times with: the bytes a call
must move (each input read once, each output written once) over the
memory rate, and the operations it does over the peak rate of their type.
"""

from __future__ import annotations

import dataclasses

PEAK_BF16 = 989e12  # H100 SXM5 data sheet, dense bf16 tensor-core FLOP/s
PEAK_INT8 = 1979e12  # dense int8 tensor-core OP/s
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 450e9  # bytes/s each way inside an 8-GPU node
IB_BW = 50e9  # bytes/s a GPU across nodes (400 Gb/s InfiniBand)
GPUS_PER_NODE = 8

#: data-sheet peaks by card name: (memory bytes/s, dense int8 ops/s, dense
#: bf16 tensor-core FLOP/s, float32 FLOP/s outside the tensor cores)
CARD_PEAKS = {
    "H100 80GB HBM3": (HBM_BW, PEAK_INT8, PEAK_BF16, 67e12),  # SXM5
    "H100 PCIe": (2.0e12, 1513e12, 756e12, 51e12),
    "H100 NVL": (3.9e12, 1671e12, 835e12, 60e12),
}


def peaks(card: str):
    """The card's (bytes/s, int8 ops/s, bf16 FLOP/s, f32 FLOP/s), or None
    for a card without data-sheet peaks here."""
    for key, val in CARD_PEAKS.items():
        if key in card:
            return val
    return None


def bound(nbytes: float, ops: float, ops_rate: float,
          bw: float = HBM_BW) -> tuple[float, str]:
    """(least seconds, "bytes" or "operations"): the larger of the bytes
    over the memory rate and the operations over their peak rate."""
    t_bytes, t_ops = nbytes / bw, ops / ops_rate
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def approx_products(mode: str, m: int) -> int:
    """Integer products a fused approx call does per (row, column, k): one
    a plane plus the main one (perforated and exact: one; recursive: two;
    truncated: m + 1)."""
    from repro_torch.kernels.approx_matmul import decomposition

    return 1 + len(decomposition(mode, m)[1])


def approx_matmul_work(mm: int, k: int, n: int, w_qbt_numel: int,
                       epilogue_numel: int, meta_numel: int,
                       x_itemsize: int, out_itemsize: int, mode: str,
                       m: int) -> tuple[float, float]:
    """(bytes, int8 ops) of one ``approx_matmul_cv_fused`` call: x (mm,
    k), the pack's K-major codes, its float32 epilogue table and meta, the
    (mm, n) output; 2 mm k n operations a product."""
    nbytes = (mm * k * x_itemsize + w_qbt_numel + epilogue_numel * 4
              + meta_numel * 4 + mm * n * out_itemsize)
    return float(nbytes), 2.0 * mm * k * n * approx_products(mode, m)


def approx_codes_work(mm: int, k: int, n: int, mode: str,
                      m: int) -> tuple[float, float]:
    """(bytes, int8 ops) of one codes-in ``approx_matmul_cv`` call: uint8
    codes (mm, k) and (k, n), four float32 (n,) epilogue vectors, five
    float32 meta scalars, a float32 (mm, n) output."""
    nbytes = mm * k + k * n + 4 * 4 * n + 4 * 5 + mm * n * 4
    return float(nbytes), 2.0 * mm * k * n * approx_products(mode, m)


def _visible_pairs(tq: int, tk: int, causal: bool, window) -> float:
    """(query, key) pairs attended, the queries end-aligned to the keys."""
    if tq == tk:
        if window is not None:
            w = min(window, tk)
            return w * (w + 1) / 2 + (tk - w) * w
        return tk * (tk + 1) / 2 if causal else float(tk * tk)
    if not causal and window is None:
        return float(tq * tk)
    total = 0.0
    for i in range(tq):
        seen = tk - tq + i + 1
        total += min(seen, window) if window is not None else seen
    return total


def flash_attention_work(b: int, hq: int, hkv: int, tq: int, tk: int,
                         d: int, causal: bool, window, itemsize: int
                         ) -> tuple[float, float]:
    """(bytes, bf16-rate FLOPs) of one flash call: q and out (b, hq, tq,
    d), k and v (b, hkv, tk, d); QK and PV over the visible pairs."""
    flops = 4.0 * b * hq * d * _visible_pairs(tq, tk, causal, window)
    nbytes = float(itemsize) * (2 * b * hq * tq * d + 2 * b * hkv * tk * d)
    return nbytes, flops


def rwkv6_scan_work(b: int, t: int, h: int, dk: int, dv: int,
                    in_itemsize: int = 2, chunk: int = 32
                    ) -> tuple[float, float]:
    """(bytes, TF32 FLOPs) of one scan call.  The products run on the
    TF32 tensor cores (half the bf16 rate on Hopper), each in the passes
    the kernel runs: A = r~ k~^T (3) and A V (2, v bf16) over the strict
    lower triangle, r~ S (3) and k~^T V (2) in full.  Bytes: r, k, v in
    the input dtype, w and the float32 output, the float32 state, u."""
    n_ch, tri = -(-t // chunk), chunk * (chunk - 1) / 2
    flops = 2.0 * b * h * n_ch * (3 * tri * dk + 2 * tri * dv
                                  + 5 * chunk * dk * dv)
    nbytes = (b * t * h * (2 * dk * in_itemsize + dv * in_itemsize
                           + dk * 4 + dv * 4)
              + b * h * dk * dv * 4 + h * dk * 4)
    return float(nbytes), flops


def link_rate(ranks) -> float:
    """The per-GPU link rate of a group of global ranks: NVLink inside one
    node of GPUS_PER_NODE, InfiniBand across nodes."""
    nodes = {r // GPUS_PER_NODE for r in ranks}
    return NVLINK_BW if len(nodes) <= 1 else IB_BW


@dataclasses.dataclass
class RooflineTerms:
    flops: float  # every operation: bf16-rate, TF32 and int8
    bytes_accessed: float
    collective_bytes: float
    collectives: dict
    collective_counts: dict
    int8_ops: float = 0.0
    tf32_flops: float = 0.0
    collective_seconds: float = 0.0
    raw_cost: dict | None = None

    @property
    def compute_s(self) -> float:
        bf16 = self.flops - self.int8_ops - self.tf32_flops
        return (bf16 / PEAK_BF16 + self.tf32_flops / (PEAK_BF16 / 2)
                + self.int8_ops / PEAK_INT8)

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_seconds

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    def as_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops,
            "bytes_per_chip": self.bytes_accessed,
            "collective_bytes_per_chip": self.collective_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "collectives": self.collectives,
            "collective_counts": self.collective_counts,
            "raw_cost_analysis": self.raw_cost,
        }


def model_flops_estimate(cfg, shape_kind: str, seq_len: int,
                         batch: int) -> float:
    """MODEL_FLOPS: 6*N*D for training (N = active params), 2*N*D per
    generated/processed token for serving, GLOBAL (divide by chips to
    compare with per-chip counts)."""
    n_active = cfg.active_param_count()
    if shape_kind == "train":
        return 6.0 * n_active * seq_len * batch
    if shape_kind == "prefill":
        return 2.0 * n_active * seq_len * batch
    return 2.0 * n_active * batch  # decode: one token per sequence
