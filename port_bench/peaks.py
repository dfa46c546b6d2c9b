"""The table of peaks and the operation and byte counts of the work.

Frozen here so that a change to the program cannot change the yardstick.
Peaks are NVIDIA's data-sheet figures for one H100 SXM (dense rates,
700 W): the same numbers as the program's ``launch/roofline.py``, copied.
The counts are LOGICAL: what the served work needs, whatever implements
it, so a kernel that computes padding or re-reads operands gains nothing.
"""

from __future__ import annotations

#: operations per second by type, and HBM bytes per second
PEAK = {"int8": 1979e12, "fp8": 1979e12, "bf16": 989e12, "tf32": 495e12,
        "fp32": 67e12}
HBM_BYTES_S = 3.35e12

#: the approximate product's CUDA kernels, as the device trace names
#: them (a name holds one of these)
APPROX_KERNELS = ("prep_kernel", "am_wgmma_kernel", "am_splitk_kernel",
                  "am_conv_kernel", "am_rows_kernel")

#: per-column epilogue bytes of an approximate product with the CV: the
#: CV constant, the weight code sum, the weight scale and the bias
EPILOGUE_BYTES = 16


def least_time(ops: float, nbytes: float, kind: str) -> float:
    """Seconds the chip needs at least: operations at the type's peak or
    bytes at HBM speed, whichever is longer."""
    return max(ops / PEAK[kind], nbytes / HBM_BYTES_S)


def approx_group(m: int, k: int, ns, x_bytes: int, out_bytes: int
                 ) -> tuple[float, float]:
    """(operations, bytes) of approximate products of one (m, k) input
    against sibling (k, n) weights (``ns``, one width each): 2mkn
    operations each; x read once, each weight's k * n codes, its epilogue
    and its output counted once."""
    ops = sum(2.0 * m * k * n for n in ns)
    nbytes = m * k * x_bytes + sum(k * n + EPILOGUE_BYTES * n
                                   + m * n * out_bytes for n in ns)
    return ops, nbytes


def lm_layer_groups(arch: dict) -> list[tuple[int, list[int]]]:
    """A dense GQA layer's approximate products as (fan-in, sibling
    widths): q|k|v on the normed input, o, gate|up, down."""
    d, ff = arch["d_model"], arch["d_ff"]
    hd = arch.get("head_dim") or d // arch["n_heads"]
    q, kv = arch["n_heads"] * hd, arch["kv_heads"] * hd
    return [(d, [q, kv, kv]), (q, [d]), (d, [ff, ff]), (ff, [d])]


def lm_token_ops(arch: dict) -> float:
    """Operations of every approximate product for one token, all layers."""
    return arch["n_layers"] * sum(2.0 * k * sum(ns)
                                  for k, ns in lm_layer_groups(arch))


def lm_attention_ops(arch: dict, visible_keys: float) -> float:
    """QK and PV operations of one layer for queries that see
    ``visible_keys`` keys in all."""
    hd = arch.get("head_dim") or arch["d_model"] // arch["n_heads"]
    return 4.0 * arch["n_heads"] * hd * visible_keys


def lm_head_ops(arch: dict) -> float:
    """The unembedding of one served row."""
    return 2.0 * arch["d_model"] * arch["vocab"]


def resnet_layers(cnn: dict) -> list[tuple[int, int, int]]:
    """Every approximate product of one image through a CIFAR ResNet of
    ``cnn`` (family resnet: width, depth blocks a stage, img_size,
    in_channels, num_classes) as (rows, fan-in, width): rows the output
    pixels (1 for the head).  A block whose channels change (and stride
    2 past the first stage) adds a 1 x 1 projection."""
    w, side = cnn["width"], cnn["img_size"]
    out = [(side * side, 9 * cnn["in_channels"], w)]
    cin = w
    for si, cout in enumerate((w, 2 * w, 4 * w)):
        for bi in range(cnn["depth"]):
            if bi == 0 and si > 0:
                side //= 2
            out.append((side * side, 9 * cin, cout))
            out.append((side * side, 9 * cout, cout))
            if cin != cout:
                out.append((side * side, cin, cout))
            cin = cout
    out.append((1, cin, cnn["num_classes"]))
    return out
