"""Parameter initializers matching the reference's (torch) defaults, and
the Linear and the NHWC convolution that use them.

Every Linear has kernel and bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)), every
convolution the same with fan_in = in*kh*kw; cls token and position
embedding are N(0, 1); the burger's convolutions are He-normal.  Draws
come from the caller's ``torch.Generator`` on the CPU, so the same seed
gives the same weights on every device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import Axis, reduce_from


def uniform_range(shape, lo: float, hi: float,
                  generator: torch.Generator) -> torch.Tensor:
    return torch.empty(shape).uniform_(lo, hi, generator=generator)


def normal(shape, generator: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator)


class Linear(nn.Module):
    """``TorchLinear``: f32 parameters, computed in ``dtype``.

    As in the JAX package, x, weight and bias are all cast to the compute
    dtype at call time; the weight is (out, in), the transpose of flax's
    (in, out) ``kernel``.  A row-parallel Linear (its input features cut
    over an axis) is called with ``reduce_over``: the partial products are
    summed over the axis, then the bias, whole on every rank, is added.
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

    def forward(self, x: torch.Tensor,
                reduce_over: Axis | None = None) -> torch.Tensor:
        if reduce_over is None:
            return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                            self.bias.to(self.dtype))
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        return reduce_from(y, reduce_over) + self.bias.to(self.dtype)


def he_conv_init(shape, generator: torch.Generator) -> torch.Tensor:
    """The burger's He-normal init (burger.py:44-47): N(0, 2/n) with
    n = kh*kw*out_channels, for a (out, in, kh, kw) weight."""
    out, _, kh, kw = shape
    return normal(shape, generator) * (2.0 / (kh * kw * out)) ** 0.5


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """flax/XLA "SAME": out = ceil(size/stride); (k-1)//2 before for
    stride 1, the rest after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class NHWCConv(nn.Module):
    """flax ``nn.Conv`` on NHWC inputs and outputs, from given initial
    values: ``weight`` (out, in, kh, kw) is flax's (kh, kw, in, out)
    ``kernel`` transposed, ``bias`` optional; both f32 parameters, cast to
    ``dtype`` at call time.  Padding "SAME" or "VALID", as flax pads."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor | None,
                 strides=(1, 1), padding: str = "SAME", *,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding {padding!r}")
        self.strides, self.padding, self.dtype = tuple(strides), padding, dtype
        self.weight = nn.Parameter(weight)
        self.bias = None if bias is None else nn.Parameter(bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        x = x.to(self.dtype)
        kh, kw = w.shape[2:]
        x = x.permute(0, 3, 1, 2)
        if self.padding == "SAME":
            top, bottom = _same_pads(x.shape[2], kh, self.strides[0])
            left, right = _same_pads(x.shape[3], kw, self.strides[1])
            x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, w, b, self.strides).permute(0, 2, 3, 1)


class Conv(nn.Module):
    """``TorchConv``: torch Conv2d's default init, weight and bias ~
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) with fan_in = in*kh*kw, on NHWC.
    The flax module's inner ``nn.Conv`` is the child ``Conv_0``, as its
    automatic name is, so carrying weights across stays a rename."""

    def __init__(self, in_features: int, features: int, kernel_size=(1, 1),
                 strides=(1, 1), padding: str = "SAME", *,
                 generator: torch.Generator,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kh, kw = kernel_size
        bound = 1.0 / (in_features * kh * kw) ** 0.5
        weight = uniform_range((features, in_features, kh, kw), -bound,
                               bound, generator).to(device)
        bias = uniform_range((features,), -bound, bound, generator).to(
            device)
        self.Conv_0 = NHWCConv(weight, bias, strides, padding, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_0(x)
