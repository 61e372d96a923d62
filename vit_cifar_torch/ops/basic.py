"""The generic MLP and conv stacks, as ``vit_cifar_tpu/ops/basic.py``.

Reference: ``ANN`` and ``CNN`` (layers.py:1300-1350), which the baseline
CNN (``models/cnn.py``) is built of.  NHWC throughout.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import Axis, copy_to, gather_from
from .init import Conv, Linear
from .norm import TorchBatchNorm


class ANN(nn.Module):
    """Linear+ReLU for each layer (layers.py:1300-1316), including the ReLU
    after the LAST layer: the reference appends the activation to every
    layer, the logits' too.  The JAX module's BN and dropout switches are
    never turned on by its one caller (``BaselineCNN``), so neither is an
    option here.  Under a model axis ``fc1`` (JAX's layout table cuts it
    by that name) is column-parallel, and its output is gathered."""

    TP_LAYOUT = {"fc1": "col"}
    tp_axis: Axis | None = None

    def __init__(self, layers: Sequence[int], *, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.n = len(layers) - 1
        for i, (fin, fout) in enumerate(zip(layers, layers[1:])):
            self.add_module(f"fc{i}", Linear(fin, fout, generator=generator,
                                             dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tp = self.tp_axis
        for i in range(self.n):
            if i == 1 and tp is not None:
                x = gather_from(F.relu(self.fc1(copy_to(x, tp))), tp)
            else:
                x = F.relu(getattr(self, f"fc{i}")(x))
        return x


class CNN(nn.Module):
    """Conv+BN+ReLU+2x2 max-pool for each layer (layers.py:1319-1350) on
    NHWC; torch Conv2d's defaults: stride 1, no padding ("VALID").  The
    JAX module's kernel size, BN and pooling switches are never changed by
    its one caller (``BaselineCNN``): 3x3 kernels, BN and pooling always."""

    KERNEL = 3

    def __init__(self, features: Sequence[int], *,
                 generator: torch.Generator,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.n = len(features) - 1
        k = self.KERNEL
        for i, (fin, fout) in enumerate(zip(features, features[1:])):
            self.add_module(f"conv{i}", Conv(
                fin, fout, (k, k), padding="VALID",
                generator=generator, dtype=dtype, device=device))
            self.add_module(f"bn{i}", TorchBatchNorm(fout, dtype=dtype,
                                                     device=device))

    def forward(self, x: torch.Tensor, *,
                deterministic: bool = True) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x),
                                        deterministic=deterministic)
            x = F.max_pool2d(F.relu(x).permute(0, 3, 1, 2), 2)
            x = x.permute(0, 2, 3, 1)
        return x

    def output_shape(self, height: int, width: int) -> tuple[int, int]:
        """The (H, W) this stack makes of a (height, width) image."""
        for _ in range(self.n):
            height = (height - self.KERNEL + 1) // 2
            width = (width - self.KERNEL + 1) // 2
        return height, width
