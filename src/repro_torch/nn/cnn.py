"""CNN substrate for the paper's accuracy evaluation (port of
``repro.nn.cnn``; Tables 2-4, Fig. 10).

Convolutions are im2col + :func:`~repro_torch.core.approx_linear.dense`,
because that is what the paper's systolic MAC array computes: each output
pixel is a k-term dot product of weights and activation patches.  So
``pack_params`` turns a float CNN into an approximate-multiplier + control
variate CNN with per-conv CV constants, and every conv of a ``backend:
"pallas"`` pack runs the approx-matmul kernel.

Layouts are the reference's, so trees and packs carry across byte for
byte: activations NHWC; conv leaves ``{"w": (k*k*cin, cout), "b"}`` with
the patch columns in ``(di, dj, c)`` order (``F.unfold`` would give ``(c,
di, dj)``); kernel sizes are static and supplied at the call site.  The
ShuffleNet depthwise leaf ``{"kernel": (3, 3, C)}`` is no linear leaf and
stays float.

Families, the paper's six CNNs at CPU-trainable scale: VGG-style (VGG13/16
stand-ins), ResNet-style (ResNet44/56), Inception-style (GoogLeNet) and
ShuffleNet-style.  ``observers.scope`` and ``dense(name=...)`` build the
calibration paths, equal to the parameter paths (``stages/0/0/conv``,
``blocks/2/b5_red``, ``head/fc1``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.core.approx_linear import dense, init_dense
from repro_torch.quant import observers

# ---------------------------------------------------------------------------
# conv2d as im2col + dense
# ---------------------------------------------------------------------------


def init_conv(cin: int, cout: int, ksize: int, *, generator: torch.Generator,
              device=None, dtype=torch.float32) -> dict:
    """Conv kernel stored directly in matmul layout: (k*k*cin, cout)."""
    fan_in = ksize * ksize * cin
    w = torch.empty(fan_in, cout, device=device, dtype=torch.float32)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return {"w": (w * (2.0 / fan_in) ** 0.5).to(dtype),
            "b": torch.zeros(cout, device=device, dtype=dtype)}


def _im2col(x: torch.Tensor, ksize: int, stride: int,
            padding: int) -> torch.Tensor:
    """x: (B, H, W, C) -> contiguous patches (B, Ho, Wo, k*k*C), column
    (di*k + dj)*C + c, as the reference's concatenated shifted slices."""
    _, h, w, _ = x.shape
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
    ho = (h + 2 * padding - ksize) // stride + 1
    wo = (w + 2 * padding - ksize) // stride + 1
    cols = [x[:, di:di + (ho - 1) * stride + 1:stride,
              dj:dj + (wo - 1) * stride + 1:stride, :]
            for di in range(ksize) for dj in range(ksize)]
    return torch.cat(cols, dim=-1)


def conv2d(p, x: torch.Tensor, ksize: int, stride: int = 1,
           padding: int | None = None, name: str = "conv") -> torch.Tensor:
    """p: linear leaf (float dict or packed module) in im2col layout."""
    if padding is None:
        padding = ksize // 2
    if ksize == 1 and stride == 1 and padding == 0:
        return dense(p, x, name=name)  # pointwise: no patch extraction
    return dense(p, _im2col(x, ksize, stride, padding), name=name)


def maxpool(x: torch.Tensor, k: int = 2, stride: int | None = None
            ) -> torch.Tensor:
    """VALID max pool over H and W of an NHWC tensor."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), k, stride or k)
    return y.permute(0, 2, 3, 1).contiguous()


def avgpool_global(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(x, dim=(1, 2))


def init_bn(c: int, device=None, dtype=torch.float32) -> dict:
    return {"scale": torch.ones(c, device=device, dtype=dtype),
            "bias": torch.zeros(c, device=device, dtype=dtype)}


def batchnorm_infer(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Per-channel affine (BN with folded statistics, as TFLite deploys)."""
    return x * p["scale"] + p["bias"]


# ---------------------------------------------------------------------------
# Model families
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    family: str  # vgg | resnet | inception | shufflenet
    num_classes: int = 10
    width: int = 32  # base channel count
    depth: int = 2  # blocks per stage
    img_size: int = 32
    in_channels: int = 3


def init_cnn(cfg: CNNConfig, *, generator: torch.Generator, device="cuda",
             dtype=torch.float32) -> dict:
    """Seeded float parameters on ``device`` (default the card; raises
    without one).  ``generator`` lives on the same device."""
    dev = resolve_device(device)
    init = {"vgg": _init_vgg, "resnet": _init_resnet,
            "inception": _init_inception,
            "shufflenet": _init_shuffle}[cfg.family]
    return init(cfg, _Init(generator, dev, dtype))


def cnn_apply(p: dict, x: torch.Tensor, cfg: CNNConfig) -> torch.Tensor:
    """Logits (B, num_classes) of NHWC images ``x``."""
    return {"vgg": _vgg_apply, "resnet": _resnet_apply,
            "inception": _inception_apply,
            "shufflenet": _shuffle_apply}[cfg.family](p, x, cfg)


@dataclasses.dataclass(frozen=True)
class _Init:
    """The generator, device and dtype every leaf of one init shares."""

    gen: torch.Generator
    device: torch.device
    dtype: torch.dtype

    def conv(self, cin: int, cout: int, ksize: int) -> dict:
        return init_conv(cin, cout, ksize, generator=self.gen,
                         device=self.device, dtype=self.dtype)

    def dense(self, k: int, n: int) -> dict:
        return init_dense(k, n, generator=self.gen, device=self.device,
                          dtype=self.dtype)

    def bn(self, c: int) -> dict:
        return init_bn(c, self.device, self.dtype)


# --- VGG ---


def _init_vgg(cfg: CNNConfig, ini: _Init) -> dict:
    w = cfg.width
    chans = [cfg.in_channels, w, w * 2, w * 4]
    p: dict = {"stages": []}
    for s in range(3):
        stage, cin = [], chans[s]
        for _ in range(cfg.depth):
            stage.append({"conv": ini.conv(cin, chans[s + 1], 3),
                          "bn": ini.bn(chans[s + 1])})
            cin = chans[s + 1]
        p["stages"].append(stage)
    p["head"] = {"fc1": ini.dense(chans[-1], 4 * w),
                 "fc2": ini.dense(4 * w, cfg.num_classes)}
    return p


def _vgg_apply(p, x, cfg):
    for si, stage in enumerate(p["stages"]):
        with observers.scope("stages", si):
            for bi, blk in enumerate(stage):
                with observers.scope(str(bi)):
                    x = conv2d(blk["conv"], x, 3, name="conv")
                    x = torch.relu(batchnorm_infer(blk["bn"], x))
        x = maxpool(x)
    x = avgpool_global(x)
    with observers.scope("head"):
        x = torch.relu(dense(p["head"]["fc1"], x, name="fc1"))
        return dense(p["head"]["fc2"], x, name="fc2")


# --- ResNet (CIFAR-style basic blocks) ---


def _init_resnet(cfg: CNNConfig, ini: _Init) -> dict:
    w = cfg.width
    p: dict = {"stem": ini.conv(cfg.in_channels, w, 3), "stem_bn": ini.bn(w),
               "stages": []}
    cin = w
    for cout in (w, 2 * w, 4 * w):
        stage = []
        for _ in range(cfg.depth):
            blk = {"conv1": ini.conv(cin, cout, 3), "bn1": ini.bn(cout),
                   "conv2": ini.conv(cout, cout, 3), "bn2": ini.bn(cout)}
            if cin != cout:
                blk["proj"] = ini.conv(cin, cout, 1)
            stage.append(blk)
            cin = cout
        p["stages"].append(stage)
    p["head"] = {"fc": ini.dense(cin, cfg.num_classes)}
    return p


def _resnet_apply(p, x, cfg):
    x = torch.relu(batchnorm_infer(p["stem_bn"],
                                   conv2d(p["stem"], x, 3, name="stem")))
    for si, stage in enumerate(p["stages"]):
        for bi, blk in enumerate(stage):
            with observers.scope("stages", si, bi):
                stride = 2 if (bi == 0 and si > 0) else 1
                h = conv2d(blk["conv1"], x, 3, stride=stride, name="conv1")
                h = torch.relu(batchnorm_infer(blk["bn1"], h))
                h = conv2d(blk["conv2"], h, 3, name="conv2")
                h = batchnorm_infer(blk["bn2"], h)
                if "proj" in blk:
                    sc = conv2d(blk["proj"], x, 1, stride=stride, padding=0,
                                name="proj")
                elif stride != 1:
                    sc = x[:, ::stride, ::stride, :]
                else:
                    sc = x
                x = torch.relu(h + sc)
    x = avgpool_global(x)
    with observers.scope("head"):
        return dense(p["head"]["fc"], x, name="fc")


# --- Inception (GoogLeNet stand-in) ---


def _init_inception(cfg: CNNConfig, ini: _Init) -> dict:
    w = cfg.width
    p: dict = {"stem": ini.conv(cfg.in_channels, w, 3), "blocks": []}
    cin = w
    for _ in range(cfg.depth + 1):
        b1, b3, b5, bp = w // 2, w // 2, w // 4, w // 4
        p["blocks"].append({
            "b1": ini.conv(cin, b1, 1),
            "b3_red": ini.conv(cin, b3 // 2, 1),
            "b3": ini.conv(b3 // 2, b3, 3),
            "b5_red": ini.conv(cin, b5 // 2, 1),
            "b5": ini.conv(b5 // 2, b5, 5),
            "bp": ini.conv(cin, bp, 1),
        })
        cin = b1 + b3 + b5 + bp
    p["head"] = {"fc": ini.dense(cin, cfg.num_classes)}
    return p


def _pool_branch(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 max pool over x padded by one -inf pixel each side."""
    return maxpool(F.pad(x, (0, 0, 1, 1, 1, 1), value=float("-inf")), 3, 1)


def _inception_apply(p, x, cfg):
    x = torch.relu(conv2d(p["stem"], x, 3, name="stem"))
    for bi, blk in enumerate(p["blocks"]):
        with observers.scope("blocks", bi):
            y1 = torch.relu(conv2d(blk["b1"], x, 1, padding=0, name="b1"))
            y3 = torch.relu(conv2d(blk["b3_red"], x, 1, padding=0,
                                   name="b3_red"))
            y3 = torch.relu(conv2d(blk["b3"], y3, 3, name="b3"))
            y5 = torch.relu(conv2d(blk["b5_red"], x, 1, padding=0,
                                   name="b5_red"))
            y5 = torch.relu(conv2d(blk["b5"], y5, 5, name="b5"))
            yp = torch.relu(conv2d(blk["bp"], _pool_branch(x), 1, padding=0,
                                   name="bp"))
            x = torch.cat([y1, y3, y5, yp], dim=-1)
        if bi % 2 == 1:
            x = maxpool(x)
    x = avgpool_global(x)
    with observers.scope("head"):
        return dense(p["head"]["fc"], x, name="fc")


# --- ShuffleNet-style (pointwise + channel shuffle + depthwise) ---


def _init_shuffle(cfg: CNNConfig, ini: _Init) -> dict:
    w = cfg.width
    p: dict = {"stem": ini.conv(cfg.in_channels, w, 3), "blocks": []}
    cin = w
    for _ in range(2):
        cout = cin * 2
        for b in range(cfg.depth):
            kernel = torch.randn(3, 3, cout, generator=ini.gen,
                                 device=ini.device) * 0.1
            blk = {"pw1": ini.conv(cin, cout, 1),
                   "dw": {"kernel": kernel.to(ini.dtype)},
                   "pw2": ini.conv(cout, cout, 1)}
            if b == 0:
                blk["proj"] = ini.conv(cin, cout, 1)
            p["blocks"].append(blk)
            cin = cout
    p["head"] = {"fc": ini.dense(cin, cfg.num_classes)}
    return p


def _channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    b, h, w, c = x.shape
    return (x.reshape(b, h, w, groups, c // groups).transpose(-1, -2)
            .reshape(b, h, w, c))


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding of one axis: the odd pixel goes after (a 32 -> 16
    stride-2 3x3 window pads (0, 1), not (1, 1))."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _depthwise(dw: dict, x: torch.Tensor, stride: int) -> torch.Tensor:
    """3x3 depthwise conv, SAME padding, NHWC in and out (float: the MAC
    array runs only the im2col convs)."""
    kern = dw["kernel"]  # (3, 3, C)
    k, c = kern.shape[0], kern.shape[-1]
    top, bottom = _same_pads(x.shape[1], k, stride)
    left, right = _same_pads(x.shape[2], k, stride)
    xc = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
    y = F.conv2d(xc, kern.permute(2, 0, 1).reshape(c, 1, k, k),
                 stride=stride, groups=c)
    return y.permute(0, 2, 3, 1).contiguous()


def _shuffle_apply(p, x, cfg):
    x = torch.relu(conv2d(p["stem"], x, 3, name="stem"))
    for bi, blk in enumerate(p["blocks"]):
        with observers.scope("blocks", bi):
            first_in_stage = "proj" in blk
            stride = 2 if first_in_stage else 1
            h = torch.relu(conv2d(blk["pw1"], x, 1, padding=0, name="pw1"))
            h = _channel_shuffle(h, 4)
            h = _depthwise(blk["dw"], h, stride)
            h = conv2d(blk["pw2"], h, 1, padding=0, name="pw2")
            if first_in_stage:
                sc = conv2d(blk["proj"], x, 1, stride=stride, padding=0,
                            name="proj")
            else:
                sc = x
            x = torch.relu(h + sc)
    x = avgpool_global(x)
    with observers.scope("head"):
        return dense(p["head"]["fc"], x, name="fc")
