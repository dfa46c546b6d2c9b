"""The paper's six CNNs (Tables 2-4) at CPU-trainable scale (port of
``repro.configs.cnn_suite``).

Name mapping (paper -> family stand-in): GoogLeNet -> inception,
ResNet44/ResNet56 -> resnet (two depths), ShuffleNet -> shufflenet,
VGG13/VGG16 -> vgg (two depths).  CIFAR-10/100 are emulated by the
procedural dataset in :mod:`repro_torch.data.vision` at matching image
geometry (32x32x3) and class counts.
"""

from __future__ import annotations

import dataclasses

from repro_torch.nn.cnn import CNNConfig

CNN_SUITE: dict[str, CNNConfig] = {
    "googlenet": CNNConfig(family="inception", width=32, depth=2),
    "resnet44": CNNConfig(family="resnet", width=16, depth=2),
    "resnet56": CNNConfig(family="resnet", width=16, depth=3),
    "shufflenet": CNNConfig(family="shufflenet", width=24, depth=2),
    "vgg13": CNNConfig(family="vgg", width=32, depth=2),
    "vgg16": CNNConfig(family="vgg", width=32, depth=3),
}


def get_cnn(name: str, num_classes: int = 10) -> CNNConfig:
    return dataclasses.replace(CNN_SUITE[name], num_classes=num_classes)
