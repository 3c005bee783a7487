"""A ResNet-18 with the CIFAR stem written from ``torch.nn`` alone: the
third-party model that ``models.quantize_model`` takes in ``chip_smoke.py``
and the tests.

Its definition holds nothing of the port: ``nn.Conv2d`` (3x3 with
``padding=1``, 1x1 with ``padding=0``, no bias), ``nn.BatchNorm2d``,
``nn.ReLU`` and an ``nn.Linear`` head, at ``resnet18_cifar``'s widths
(64, 128, 256, 512) and stage sizes (2, 2, 2, 2).  Its module names are those
of the JAX package's ``QuantResNet``: ``stem``, ``bn_stem``,
``stage{s}_block{b}.conv1/bn1/conv2/bn2/downsample/bn_down`` and ``head``.
A stride-2 3x3 convolution pads (1, 1) as ``padding=1`` does, where XLA's
SAME pads (0, 1), so this is not numerically ``QuantResNet``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

__all__ = ["StockBasicBlock", "StockResNet18", "stock_resnet18"]


class StockBasicBlock(nn.Module):
    def __init__(self, cin: int, width: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, width, 3, stride=stride, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.relu = nn.ReLU()
        self.downsample = self.bn_down = None
        if stride != 1 or cin != width:
            self.downsample = nn.Conv2d(cin, width, 1, stride=stride, padding=0, bias=False)
            self.bn_down = nn.BatchNorm2d(width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.bn_down(self.downsample(x))
        return self.relu(y + residual)


class StockResNet18(nn.Module):
    """NCHW images to (B, num_classes) logits; narrower with ``widths`` and
    ``stage_sizes``."""

    def __init__(self, num_classes: int = 10, *, widths: Sequence[int] = (64, 128, 256, 512),
                 stage_sizes: Sequence[int] = (2, 2, 2, 2), in_channels: int = 3):
        super().__init__()
        self.stem = nn.Conv2d(in_channels, widths[0], 3, padding=1, bias=False)
        self.bn_stem = nn.BatchNorm2d(widths[0])
        self.relu = nn.ReLU()
        self.block_names = []
        cin = widths[0]
        for s, (n, w) in enumerate(zip(stage_sizes, widths)):
            for b in range(n):
                name = f"stage{s}_block{b}"
                self.add_module(name, StockBasicBlock(cin, w, 2 if (s > 0 and b == 0) else 1))
                self.block_names.append(name)
                cin = w
        self.head = nn.Linear(cin, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.relu(self.bn_stem(self.stem(x)))
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.head(x.mean(dim=(2, 3)))


def stock_resnet18(num_classes: int = 10, *, seed: int = 0, **kw) -> StockResNet18:
    """A :class:`StockResNet18` on the CPU with torch's default initialisation
    drawn from ``seed`` (the global generator is left as it was)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return StockResNet18(num_classes, **kw)
