"""Parameter initializers matching the reference's (torch) defaults.

Every Linear has kernel and bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)); cls
token and position embedding are N(0, 1).  Draws come from the caller's
``torch.Generator`` on the CPU, so the same seed gives the same weights on
every device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def uniform_range(shape, lo: float, hi: float,
                  generator: torch.Generator) -> torch.Tensor:
    return torch.empty(shape).uniform_(lo, hi, generator=generator)


def normal(shape, generator: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator)


class Linear(nn.Module):
    """``TorchLinear``: f32 parameters, computed in ``dtype``.

    As in the JAX package, x, weight and bias are all cast to the compute
    dtype at call time; the weight is (out, in), the transpose of flax's
    (in, out) ``kernel``.
    """

    def __init__(self, in_features: int, out_features: int, *,
                 generator: torch.Generator, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        bound = 1.0 / in_features**0.5
        self.dtype = dtype
        self.weight = nn.Parameter(uniform_range(
            (out_features, in_features), -bound, bound, generator).to(device))
        self.bias = nn.Parameter(uniform_range(
            (out_features,), -bound, bound, generator).to(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))
