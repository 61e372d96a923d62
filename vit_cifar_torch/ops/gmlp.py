"""gMLP-family token mixers, as ``vit_cifar_tpu/ops/gmlp.py``: GatedMLP,
WeightGatedMLP and LinearAttention.

Reference: layers.py:491-514 (GatedMLP), layers.py:533-553
(WeightGatedMLP), layers.py:1260-1281 (LinearAttention).  Shared shape:
lift to ``ffn_features`` with U + GELU, chunk into (z1, z2), LayerNorm z2
(``norm``), make a token-mixing transform from z2, gate ``z1 * mix`` (or
multiply by it), project back with V.

  * GatedMLP: a static learned TxT mixing ``weight``, init U(-0.01, 0.01),
    plus a per-token ``bias`` of ones (layers.py:502-505).
  * WeightGatedMLP: a data-dependent (B,T,T) mix, Linear(ffn/2 -> T) on z2
    (layers.py:540-552).
  * LinearAttention: relu(Linear(ffn/2 -> T)) then Linear(T -> T)
    (layers.py:1271-1281).

None applies dropout inside the mixer (parity).

Under a model axis U is column-parallel and V row-parallel.  U's output is
chunked into (z1, z2), so each rank holds the matching slices of both
halves (its z1 columns and its z2 columns; checkpoints keep the one-device
layout).  z1 stays cut; z2 is gathered, since its LayerNorm and the mixing
read every feature, and each rank gates its z1 columns.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import Axis, copy_to, gather_from, scatter_to
from .common import LayerNorm
from .init import Linear, uniform_range


class _GatedBase(nn.Module):
    """U + GELU, the chunk, and ``norm`` on z2 (whole on every rank)."""

    TP_LAYOUT = {"U": "col_halves", "V": "row"}
    tp_axis: Axis | None = None

    def __init__(self, features: int, ffn_features: int, *,
                 generator: torch.Generator, dtype: torch.dtype, device):
        super().__init__()
        if ffn_features % 2:
            raise ValueError(f"ffn_features={ffn_features} is odd")
        self.dtype = dtype
        self.U = Linear(features, ffn_features, generator=generator,
                        dtype=dtype, device=device)
        self.norm = LayerNorm(ffn_features // 2, dtype=dtype, device=device)

    def _split(self, x: torch.Tensor):
        tp = self.tp_axis
        if tp is None:
            z1, z2 = F.gelu(self.U(x)).chunk(2, dim=-1)
            return z1, self.norm(z2)
        z1, z2 = F.gelu(self.U(copy_to(x, tp))).chunk(2, dim=-1)
        return z1, self.norm(gather_from(z2, tp))

    def _mix(self, mix: torch.Tensor) -> torch.Tensor:
        """A (B, T, T) token mix made whole on every rank, to be applied to
        this rank's z1 columns."""
        return mix if self.tp_axis is None else copy_to(mix, self.tp_axis)


class GatedMLP(_GatedBase):
    def __init__(self, features: int, ffn_features: int, seq_len: int, *,
                 generator: torch.Generator,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(features, ffn_features, generator=generator,
                         dtype=dtype, device=device)
        lin = dict(generator=generator, dtype=dtype, device=device)
        self.weight = nn.Parameter(uniform_range(
            (seq_len, seq_len), -0.01, 0.01, generator).to(device))
        self.bias = nn.Parameter(torch.ones(1, seq_len, 1, device=device))
        self.V = Linear(ffn_features // 2, features, **lin)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: torch.Generator | None = None):
        z1, z2 = self._split(x)
        z2 = torch.einsum("ij,bjd->bid", self.weight.to(self.dtype), z2) \
            + self.bias.to(self.dtype)
        if self.tp_axis is not None:
            z2 = scatter_to(z2, self.tp_axis)
        return self.V(z1 * z2, reduce_over=self.tp_axis)


class WeightGatedMLP(_GatedBase):
    def __init__(self, features: int, ffn_features: int, seq_len: int, *,
                 generator: torch.Generator,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(features, ffn_features, generator=generator,
                         dtype=dtype, device=device)
        lin = dict(generator=generator, dtype=dtype, device=device)
        self.to_weight = Linear(ffn_features // 2, seq_len, **lin)
        self.V = Linear(ffn_features // 2, features, **lin)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: torch.Generator | None = None):
        z1, z2 = self._split(x)
        out = torch.einsum("bij,bjf->bif", self._mix(self.to_weight(z2)), z1)
        return self.V(out, reduce_over=self.tp_axis)


class LinearAttention(_GatedBase):
    def __init__(self, features: int, ffn_features: int, seq_len: int, *,
                 generator: torch.Generator,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(features, ffn_features, generator=generator,
                         dtype=dtype, device=device)
        lin = dict(generator=generator, dtype=dtype, device=device)
        self.to_weight1 = Linear(ffn_features // 2, seq_len, **lin)
        self.to_weight2 = Linear(seq_len, seq_len, **lin)
        self.V = Linear(ffn_features // 2, features, **lin)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: torch.Generator | None = None):
        z1, z2 = self._split(x)
        mix = self._mix(self.to_weight2(F.relu(self.to_weight1(z2))))
        return self.V(torch.einsum("bij,bjf->bif", mix, z1),
                      reduce_over=self.tp_axis)
