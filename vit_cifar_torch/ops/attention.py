"""Multi-head self-attention with the reference's exact semantics.

As in ``vit_cifar_tpu/ops/attention.py``:
  * the softmax scale is ``1/sqrt(features)`` over the FULL model dim, not
    ``1/sqrt(head_dim)`` (reference layers.py:79,97);
  * separate Wq/Wk/Wv projections with bias;
  * dropout only after the output projection.

Every forward, in training as in inference, goes through an attention
kernel (the CUDA kernels on the card, forward and backward, their plain
versions on the CPU) chosen by :func:`route`, except where the JAX module,
too, takes its einsum path: ``save_attn_map`` (the map is kept on
``self.attn_map``, the reference's attribute), ``valid_len`` key masking,
and ``pallas_kernel="einsum"``, which forces the plain path.

Under a model axis Wq/Wk/Wv are column-parallel and out_project
row-parallel: each rank runs its ``head / n_model`` heads of the same
head_dim through the same kernels, with the scale still over the full model
dim.  Where the heads do not divide over the axis, each rank gathers q, k
and v, runs every head, and keeps its own columns for out_project.

Under a seq axis (``parallel/sequence.py``) the input is this rank's block
of the token stream: its queries meet the keys and values gathered over
the axis (``gather_summed``: the backward sums their cotangents over the
axis and keeps this rank's block), on the einsum path, since Tq != Tk there
as on JAX's masked path; ``valid_len`` is then held against the global key
index.  The output dropout draws at the stream's global shape.
"""

from __future__ import annotations

import torch
from torch import nn

from ..parallel.collectives import (Axis, copy_to, gather_from,
                                    gather_summed, scatter_to)
from .common import dropout
from .cuda.attention import fused_attention
from .cuda.common import whole_head_holds
from .cuda.flash_attention import flash_attention
from .init import Linear


def route(T: int, D: int, pallas_kernel: str | None, *,
          dtype: torch.dtype = torch.float32) -> str:
    """The attention path at sequence length T and head_dim D in ``dtype``
    (the module's compute dtype): "einsum" (plain PyTorch), "fused" (the
    whole-head forward, ``fused_attention``, whose backward is the tiled
    pair) or "flash" (the tiled kernels, ``flash_attention``).

    ``"einsum"``, ``"fused"`` and ``"flash"`` are taken as asked, at any
    (T, D).  The default (``""`` or None) takes the whole-head forward
    where one of its whole-head instances in ``dtype`` holds the head as its
    one key tile (``whole_head_holds``: round_up(T, 8) keys up to 128 at
    head_dim 32, 96 at 64 and 64 at 128 in bf16; up to 72 at 32, 64 at 64
    and 32 at 128 in f32), and the tiled kernels everywhere else.  Past
    those heads ``"fused"`` runs the same kernel's tiled work items, as
    JAX's ``fused_attention`` runs at any (T, D)."""
    if pallas_kernel in ("einsum", "fused", "flash"):
        return pallas_kernel
    return "fused" if whole_head_holds(T, D, dtype) else "flash"


class MultiHeadSelfAttention(nn.Module):
    TP_LAYOUT = {"Wq": "col", "Wk": "col", "Wv": "col", "out_project": "row"}
    data_axis: Axis | None = None
    tp_axis: Axis | None = None
    seq_axis: Axis | None = None

    def __init__(self, features: int, head: int = 8, dropout: float = 0.0, *,
                 generator: torch.Generator, dtype: torch.dtype = torch.float32,
                 save_attn_map: bool = False, pallas_kernel: str | None = None,
                 valid_len: int | None = None, device=None):
        super().__init__()
        if pallas_kernel not in (None, "", "einsum", "fused", "flash"):
            raise ValueError(f"pallas_kernel={pallas_kernel!r}: expected "
                             "'einsum', 'fused', or 'flash'")
        if features % head:
            raise ValueError(f"features={features} is not a multiple of "
                             f"head={head}")
        self.features, self.head, self.rate = features, head, dropout
        self.dtype = dtype
        self.save_attn_map = save_attn_map
        self.pallas_kernel = pallas_kernel
        self.valid_len = valid_len
        self.attn_map: torch.Tensor | None = None
        lin = dict(generator=generator, dtype=dtype, device=device)
        self.Wq = Linear(features, features, **lin)
        self.Wk = Linear(features, features, **lin)
        self.Wv = Linear(features, features, **lin)
        self.out_project = Linear(features, features, **lin)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: torch.Generator | None = None):
        B, T, F = x.shape
        hd = F // self.head
        tp = self.tp_axis
        ragged = tp is not None and self.head % tp.size != 0
        xin = x if tp is None else copy_to(x, tp)
        q, k, v = (lin(xin) for lin in (self.Wq, self.Wk, self.Wv))
        if ragged:
            q, k, v = (gather_from(t, tp) for t in (q, k, v))
        H = q.shape[-1] // hd  # this rank's heads
        sp = self.seq_axis
        if sp is not None:  # every rank's keys and values
            k, v = gather_summed(torch.cat([k, v], -1), sp, 1).chunk(2, -1)
        Tk = k.shape[1]
        q = q.reshape(B, T, H, hd).transpose(1, 2)
        k, v = (t.reshape(B, Tk, H, hd).transpose(1, 2) for t in (k, v))

        masked = self.valid_len is not None and self.valid_len < Tk
        path = "einsum" if self.save_attn_map or masked or Tk != T else \
            route(T, hd, self.pallas_kernel, dtype=q.dtype)
        if path == "einsum":
            # (B,H,T,Tk) logits in the compute dtype, divided by sqrt(F) as
            # the JAX einsum path does
            sqrt_d = torch.tensor(F**0.5, dtype=self.dtype, device=x.device)
            logits = torch.einsum("bhif,bhjf->bhij", q, k) / sqrt_d
            if masked:
                key_ok = torch.arange(Tk, device=x.device) < self.valid_len
                fill = torch.tensor(torch.finfo(torch.float32).min,
                                    device=x.device).to(logits.dtype)
                logits = torch.where(key_ok, logits, fill)
            attn = torch.softmax(logits.to(torch.float32), -1).to(self.dtype)
            if self.save_attn_map:
                self.attn_map = attn
            out = torch.einsum("bhij,bhjf->bihf", attn, v)
        else:
            kernel = fused_attention if path == "fused" else flash_attention
            out = kernel(q, k, v, 1.0 / float(F**0.5))

        out = out.reshape(B, T, H * hd)
        if ragged:
            out = scatter_to(out, tp)
        out = self.out_project(out, reduce_over=tp)
        return dropout(out, self.rate, deterministic, generator,
                       ((0, self.data_axis), (1, sp)))
