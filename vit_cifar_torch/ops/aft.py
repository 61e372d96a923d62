"""Attention-Free Transformer mixers (AFT-Full, AFT-Simple), as
``vit_cifar_tpu/ops/aft.py`` (reference layers.py:106-203).

  * AFT-Full: a learned TxT position bias ``w`` (or ``u @ v`` of rank
    ``factorization_dimension``), xavier-uniform,
    ``Y = (exp(w) @ (exp(K) * V)) / (exp(w) @ exp(K))``, an optional
    sigmoid query gate, the output projection and dropout.  The exp and
    ratio arithmetic runs in f32 whatever the compute dtype.
  * The stabilization quirk is kept: the reference subtracts
    ``max(K, dim=0)`` -- dim 0 is the BATCH axis (layers.py:158) -- which
    does not cancel out of the ratio and couples the examples of a batch.
  * AFT-Simple: ``Y = sum_T softmax(K, dim=tokens) * V``, a (B,1,F) summary
    broadcast by the query gate, which the model factory always turns on
    (the encoder never forwards ``query`` to it, layers.py:233).
  * head > 1 is unimplemented in the reference (layers.py:128) and here.

Under a data axis the batch-axis max is taken over the global batch; under
a model axis Wk/Wv/Wq are column-parallel and out_project row-parallel,
and each rank mixes its own feature columns with the whole position bias.
"""

from __future__ import annotations

import torch
from torch import nn

from ..parallel.collectives import Axis, copy_to, global_amax
from .common import dropout
from .init import Linear, uniform_range


def xavier_uniform(shape, generator: torch.Generator) -> torch.Tensor:
    """U(-b, b) with b = sqrt(6 / (fan_in + fan_out)) for a 2-D shape."""
    bound = (6.0 / (shape[0] + shape[1])) ** 0.5
    return uniform_range(shape, -bound, bound, generator)


class AFT(nn.Module):
    TP_LAYOUT = {"Wq": "col", "Wk": "col", "Wv": "col", "out_project": "row"}
    data_axis: Axis | None = None
    tp_axis: Axis | None = None

    def __init__(self, features: int, seq_len: int, mode: str = "full",
                 factorize: bool = False, factorization_dimension: int = 128,
                 head: int = 1, dropout: float = 0.0, query: bool = True, *,
                 generator: torch.Generator,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if head > 1:
            raise NotImplementedError(
                "AFT head > 1 (parity: layers.py:128-129)")
        if mode not in ("full", "simple"):
            # parity: 'local'/'conv' raise in the reference (layers.py:236-238)
            raise NotImplementedError(f"AFT mode {mode!r}")
        self.mode, self.factorize, self.query = mode, factorize, query
        self.rate, self.dtype = dropout, dtype
        lin = dict(generator=generator, dtype=dtype, device=device)
        self.Wk = Linear(features, features, **lin)
        self.Wv = Linear(features, features, **lin)
        if mode == "full":
            if factorize:
                fd = factorization_dimension
                self.u = nn.Parameter(
                    xavier_uniform((seq_len, fd), generator).to(device))
                self.v = nn.Parameter(
                    xavier_uniform((fd, seq_len), generator).to(device))
            else:
                self.w = nn.Parameter(
                    xavier_uniform((seq_len, seq_len), generator).to(device))
        if query:
            self.Wq = Linear(features, features, **lin)
        self.out_project = Linear(features, features, **lin)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: torch.Generator | None = None):
        tp, data = self.tp_axis, self.data_axis
        xin = x if tp is None else copy_to(x, tp)
        k, v = self.Wk(xin), self.Wv(xin)
        if self.mode == "full":
            # w is rounded to the compute dtype, as in the JAX module
            w = (self.u @ self.v) if self.factorize else self.w
            w32 = w.to(self.dtype).to(torch.float32)
            k32, v32 = k.to(torch.float32), v.to(torch.float32)
            exp_w = torch.exp(w32 - w32.amax(dim=-1, keepdim=True))  # (T,T)
            if tp is not None:  # each rank's columns read all of it
                exp_w = copy_to(exp_w, tp)
            # the batch-axis max quirk (layers.py:158)
            k_max = (k32.amax(dim=0, keepdim=True) if data is None
                     else global_amax(k32, 0, data))
            exp_k = torch.exp(k32 - k_max)
            num = torch.einsum("ij,bjf->bif", exp_w, exp_k * v32)
            den = torch.einsum("ij,bjf->bif", exp_w, exp_k)
            y = (num / den).to(self.dtype)
        else:
            attn = torch.softmax(k.to(torch.float32), dim=1).to(self.dtype)
            y = torch.sum(attn * v, dim=1, keepdim=True)  # (B,1,F)
        if self.query:
            y = torch.sigmoid(self.Wq(xin)) * y
        out = self.out_project(y, reduce_over=tp)
        return dropout(out, self.rate, deterministic, generator,
                       ((0, data),))
