"""The models' float weights, made from the seed on the device in a few
large calls: one ``torch.randn`` per LM layer (all its matrices), one for
the embedding table, two for a whole CNN.  The program packs them; the
references make them again from the seed, layer by layer, and read
nothing that the program derived from them.

The trees are laid out as the program's models read them: the LM's
``embed``/``blocks``/``final_norm`` with every block leaf stacked over the
layers, the CNN's ``stem``/``stages``/``head`` lists of linear leaves in
im2col layout ``(k * k * cin, cout)``.
"""

from __future__ import annotations

import torch

#: one seed's generator streams: the table, then one a layer (1 + i)
_TABLE = 0


def generator(device, seed: int, stream: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + stream) % 2**63)


def lm_shapes(arch: dict) -> list[tuple[str, str, int, int]]:
    """(group, name, fan-in, width) of one dense GQA layer's linears."""
    d, ff = arch["d_model"], arch["d_ff"]
    hd = arch.get("head_dim") or d // arch["n_heads"]
    q, kv = arch["n_heads"] * hd, arch["kv_heads"] * hd
    return [("attn", "q", d, q), ("attn", "k", d, kv), ("attn", "v", d, kv),
            ("attn", "o", q, d), ("mlp", "gate", d, ff), ("mlp", "up", d, ff),
            ("mlp", "down", ff, d)]


def lm_table(arch: dict, seed: int, device) -> torch.Tensor:
    """The (vocab, d_model) embedding table, N(0, 0.02^2)."""
    g = generator(device, seed, _TABLE)
    return torch.randn(arch["vocab"], arch["d_model"], generator=g,
                       device=device) * 0.02


def lm_layer(arch: dict, seed: int, i: int, device) -> dict:
    """Layer ``i``'s linears ``{name: (fan-in, width)}``, N(0, 1/fan-in)."""
    shapes = lm_shapes(arch)
    flat = torch.randn(sum(k * n for _, _, k, n in shapes),
                       generator=generator(device, seed, 1 + i),
                       device=device)
    out, at = {}, 0
    for _, name, k, n in shapes:
        out[name] = flat[at:at + k * n].view(k, n).mul_(k ** -0.5)
        at += k * n
    return out


def _norm(kind: str, d: int, device) -> dict:
    """Norm parameters at their initial values (the non-parametric
    LayerNorm has none)."""
    if kind == "nonparametric_ln":
        return {}
    if kind == "rmsnorm":
        return {"scale": torch.ones(d, device=device)}
    return {"scale": torch.ones(d, device=device),
            "bias": torch.zeros(d, device=device)}


def lm_tree(arch: dict, seed: int, device) -> dict:
    """The float32 tree of a dense GQA LM with tied embeddings."""
    if not arch.get("tie_embeddings"):
        raise ValueError("the LM trees here tie the head to the table")
    L, d = arch["n_layers"], arch["d_model"]
    blocks = {"attn_norm": _norm(arch["norm"], d, device),
              "mlp_norm": _norm(arch["norm"], d, device),
              "attn": {}, "mlp": {}}
    for group, name, k, n in lm_shapes(arch):
        blocks[group][name] = {"w": torch.empty(L, k, n, device=device)}
    for i in range(L):
        layer = lm_layer(arch, seed, i, device)
        for group, name, *_ in lm_shapes(arch):
            blocks[group][name]["w"][i] = layer[name]
        del layer
    return {"embed": {"table": lm_table(arch, seed, device)},
            "blocks": blocks, "final_norm": _norm(arch["norm"], d, device)}


def resnet_leaves(cnn: dict) -> list[tuple[tuple, str, tuple]]:
    """(path, kind, shape) of every leaf of a CIFAR ResNet of ``cnn``:
    kind "conv"/"fc" (a linear leaf of fan-in shape[0]) or "bn"; the path
    as the program's tree nests it."""
    w, cin = cnn["width"], cnn["in_channels"]
    out = [(("stem",), "conv", (9 * cin, w)), (("stem_bn",), "bn", (w,))]
    cin = w
    for si, cout in enumerate((w, 2 * w, 4 * w)):
        for bi in range(cnn["depth"]):
            p = ("stages", si, bi)
            out += [(p + ("conv1",), "conv", (9 * cin, cout)),
                    (p + ("bn1",), "bn", (cout,)),
                    (p + ("conv2",), "conv", (9 * cout, cout)),
                    (p + ("bn2",), "bn_last", (cout,))]
            if cin != cout:
                out.append((p + ("proj",), "conv", (cin, cout)))
            cin = cout
    out.append((("head", "fc"), "fc", (cin, cnn["num_classes"])))
    return out


def resnet_tree(cnn: dict, seed: int, device) -> dict:
    """The float32 tree of a CIFAR ResNet: convs N(0, 2/fan-in) (He),
    the head N(0, 1/fan-in), biases N(0, 0.01^2); batch-norm (folded, as
    deployed) scale 1 + N(0, 0.1^2) and bias N(0, 0.1^2), the scale of a
    residual branch's last norm a quarter of that, so that the residual
    stream grows slowly over the 3 x depth blocks."""
    leaves = resnet_leaves(cnn)
    g = generator(device, seed, 0)
    n_w = sum(s[0] * s[1] for _, kind, s in leaves if kind in ("conv", "fc"))
    n_v = sum(s[-1] * (2 if kind.startswith("bn") else 1)
              for _, kind, s in leaves)
    flat_w = torch.randn(n_w, generator=g, device=device)
    flat_v = torch.randn(n_v, generator=g, device=device)
    tree: dict = {"stages": [[{} for _ in range(cnn["depth"])]
                             for _ in range(3)], "head": {}}
    aw = av = 0
    for path, kind, shape in leaves:
        if kind in ("conv", "fc"):
            k, n = shape
            gain = 2.0 if kind == "conv" else 1.0
            leaf = {"w": flat_w[aw:aw + k * n].view(k, n) * (gain / k) ** 0.5,
                    "b": flat_v[av:av + n] * 0.01}
            aw, av = aw + k * n, av + n
        else:
            c = shape[0]
            base = 0.25 if kind == "bn_last" else 1.0
            leaf = {"scale": base * (1.0 + 0.1 * flat_v[av:av + c]),
                    "bias": 0.1 * flat_v[av + c:av + 2 * c]}
            av += 2 * c
        node = tree
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = leaf
    return tree
