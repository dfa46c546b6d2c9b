"""Plain reference of a CIFAR ResNet (He et al., arXiv:1512.03385 §4.2,
with a 1 x 1 projection where the shape changes) on the approximate MAC
array: im2col convolutions in (di, dj, c) column order, folded
batch-norm, ReLU, global average pool and a linear head, every conv and
the head an approximate product of :mod:`port_bench.approx_ref`.
Activation ranges are calibrated here, on a float forward of the
calibration batch, per layer input (min, max).  Float32, or, for the
control, every activation rounded to a lower type.  It imports nothing
of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from port_bench import approx_ref


def im2col(x: torch.Tensor, k: int, stride: int, pad: int) -> torch.Tensor:
    """x (B, H, W, C) -> (B, Ho, Wo, k * k * C), column (di * k + dj) * C + c."""
    _, h, w, _ = x.shape
    if pad:
        x = F.pad(x, (0, 0, pad, pad, pad, pad))
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    return torch.cat([x[:, di:di + (ho - 1) * stride + 1:stride,
                        dj:dj + (wo - 1) * stride + 1:stride, :]
                      for di in range(k) for dj in range(k)], dim=-1)


class ResNet:
    """One forward's policy: float (recording each layer input's range
    into ``ranges``) or approximate (``packs`` by layer path), with
    activations held in ``act_dtype``."""

    def __init__(self, tree: dict, cnn: dict, approx: dict | None = None,
                 ranges: dict | None = None,
                 act_dtype: torch.dtype = torch.float32):
        self.tree, self.cnn, self.approx = tree, cnn, approx
        self.ranges = ranges if ranges is not None else {}
        self.act_dtype = act_dtype
        self.packs: dict = {}
        if approx is not None:
            for path, leaf in self._linears():
                a_scale, a_zp = approx_ref.qparams(*self.ranges[path],
                                                   device=leaf["w"].device)
                self.packs[path] = (approx_ref.pack(
                    leaf["w"], leaf["b"], approx["mode"], approx["m"]),
                    a_scale, a_zp)

    def _linears(self):
        t = self.tree
        yield ("stem",), t["stem"]
        for si, stage in enumerate(t["stages"]):
            for bi, blk in enumerate(stage):
                for name in ("conv1", "conv2", "proj"):
                    if name in blk:
                        yield ("stages", si, bi, name), blk[name]
        yield ("head", "fc"), t["head"]["fc"]

    def act(self, x: torch.Tensor) -> torch.Tensor:
        if self.act_dtype == torch.float32:
            return x
        return x.to(self.act_dtype).to(torch.float32)

    def linear(self, path, leaf, x):
        if self.approx is None:
            lo, hi = float(x.min()), float(x.max())
            plo, phi = self.ranges.get(path, (lo, hi))
            self.ranges[path] = (min(plo, lo), max(phi, hi))
            return self.act(torch.matmul(x, leaf["w"]) + leaf["b"])
        wt, a_scale, a_zp = self.packs[path]
        return self.act(approx_ref.linear(
            x, wt, a_scale, a_zp, self.approx["mode"], self.approx["m"],
            self.approx["use_cv"]))

    def conv(self, path, leaf, x, k, stride, pad):
        return self.linear(path, leaf, im2col(x, k, stride, pad))

    def bn(self, p, x):
        return self.act(x * p["scale"] + p["bias"])

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        t = self.tree
        x = self.act(x.to(torch.float32))
        x = torch.relu(self.bn(t["stem_bn"],
                               self.conv(("stem",), t["stem"], x, 3, 1, 1)))
        for si, stage in enumerate(t["stages"]):
            for bi, blk in enumerate(stage):
                p = ("stages", si, bi)
                stride = 2 if (bi == 0 and si > 0) else 1
                h = self.conv(p + ("conv1",), blk["conv1"], x, 3, stride, 1)
                h = torch.relu(self.bn(blk["bn1"], h))
                h = self.bn(blk["bn2"],
                            self.conv(p + ("conv2",), blk["conv2"], h, 3, 1, 1))
                if "proj" in blk:
                    sc = self.conv(p + ("proj",), blk["proj"], x, 1, stride, 0)
                else:
                    sc = x
                x = self.act(torch.relu(h + sc))
        x = self.act(x.mean(dim=(1, 2)))
        return self.linear(("head", "fc"), t["head"]["fc"], x)


def calibrate(tree: dict, cnn: dict, calib: torch.Tensor) -> dict:
    """Each layer input's (min, max) over a float forward of ``calib``."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        net = ResNet(tree, cnn)
        net(calib)
        return net.ranges
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
