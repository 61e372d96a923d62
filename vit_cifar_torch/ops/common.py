"""Shared building blocks: LayerNorm, the encoder MLP and the pre-LN encoder
block, whose MLP an ``mlp_factory`` may replace (the MoE MLP).

As in ``vit_cifar_tpu/ops/common.py``: the MLP is Linear -> GELU -> Dropout
-> Linear -> GELU -> Dropout, a GELU after the *second* linear too
(reference layers.py:32-39), and blocks are pre-LN with residuals.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import Axis, Shards, copy_to, local_draw
from .init import Linear


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: torch.Generator | None = None,
            shards: Shards = ()) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 - rate and
    scale the kept ones by 1/(1 - rate), in x's dtype.  Draws come from
    ``generator`` (on x's device).  Rate 0, or ``deterministic``, is the
    identity.  ``shards`` ((dim, axis) pairs) say how x is cut over the
    mesh: the mask is drawn at the one-device shape and cut alike."""
    if deterministic or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    keep = 1.0 - rate
    mask = local_draw(lambda shape: torch.rand(
        shape, generator=generator, device=x.device), x.shape, shards) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class LayerNorm(nn.Module):
    """flax ``LayerNorm(epsilon, dtype)`` with f32 parameters: statistics and
    the affine map in f32, the result cast to ``dtype`` (flax's
    ``force_float32_reductions``).  Written with explicit casts; autocast
    would leave the result in f32."""

    def __init__(self, features: int, eps: float = 1e-5, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.to(torch.float32), self.weight.shape, self.weight,
                         self.bias, self.eps)
        return y.to(self.dtype)


class EncoderMLP(nn.Module):
    """Reference layers.py:32-39 — note the trailing GELU.  Under a model
    axis fc1 is column-parallel and fc2 row-parallel; under a seq axis it
    runs on this rank's tokens and its dropout draws at the stream's global
    shape."""

    TP_LAYOUT = {"fc1": "col", "fc2": "row"}
    data_axis: Axis | None = None
    tp_axis: Axis | None = None
    seq_axis: Axis | None = None

    def __init__(self, mlp_hidden: int, features: int, dropout: float = 0.0, *,
                 generator: torch.Generator, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.rate = dropout
        lin = dict(generator=generator, dtype=dtype, device=device)
        self.fc1 = Linear(features, mlp_hidden, **lin)
        self.fc2 = Linear(mlp_hidden, features, **lin)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: torch.Generator | None = None):
        tp, rows = self.tp_axis, ((0, self.data_axis), (1, self.seq_axis))
        h = F.gelu(self.fc1(x if tp is None else copy_to(x, tp)))
        h = dropout(h, self.rate, deterministic, generator,
                    rows + ((-1, tp),))
        return dropout(F.gelu(self.fc2(h, reduce_over=tp)), self.rate,
                       deterministic, generator, rows)


class EncoderBlock(nn.Module):
    """Pre-LN encoder block around a token mixer made by ``mixer()``; the
    MLP, ``mlp``, is made by ``mlp_factory()`` where one is given (the MoE
    MLP), else it is the reference's ``EncoderMLP``."""

    def __init__(self, features: int, mlp_hidden: int,
                 mixer: Callable[[], nn.Module], use_mlp: bool = True,
                 dropout: float = 0.0, *, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32, device=None,
                 mlp_factory: Callable[[], nn.Module] | None = None):
        super().__init__()
        self.la1 = LayerNorm(features, dtype=dtype, device=device)
        self.mixer = mixer()
        self.use_mlp = use_mlp
        if use_mlp:
            self.la2 = LayerNorm(features, dtype=dtype, device=device)
            self.mlp = mlp_factory() if mlp_factory else EncoderMLP(
                mlp_hidden, features, dropout, generator=generator,
                dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: torch.Generator | None = None):
        kw = dict(deterministic=deterministic, generator=generator)
        x = x + self.mixer(self.la1(x), **kw)
        if self.use_mlp:
            x = x + self.mlp(self.la2(x), **kw)
        return x
