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
"""

from __future__ import annotations

import torch
from torch import nn

from .common import dropout
from .cuda.attention import fused_attention, whole_head_fits
from .cuda.common import COL_CHUNK
from .cuda.flash_attention import flash_attention
from .init import Linear


def route(T: int, D: int, pallas_kernel: str | None) -> str:
    """The attention path at sequence length T and head_dim D: "einsum"
    (plain PyTorch), "fused" (the whole-head forward, ``fused_attention``,
    whose backward is the tiled pair) or "flash" (the tiled kernels,
    ``flash_attention``).

    ``"einsum"``, ``"fused"`` and ``"flash"`` are taken as asked, at any
    (T, D).  The default (``""`` or None) takes the whole-head forward where
    its shared memory holds an un-split head (head_dim up to ``COL_CHUNK``:
    T <= 792 at head_dim 32, 215 at 128), and the tiled kernels everywhere
    else.  ``"fused"`` runs the whole-head forward at any (T, D), as JAX's
    ``fused_attention`` does: where the head does not fit (past the limit
    above, or T > 279 at head_dim 192, 213 at 256, 142 at 384) its block
    walks K and V in key tiles."""
    if pallas_kernel in ("einsum", "fused", "flash"):
        return pallas_kernel
    return "fused" if whole_head_fits(T, D) and D <= COL_CHUNK else "flash"


class MultiHeadSelfAttention(nn.Module):
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
        q, k, v = (lin(x).reshape(B, T, self.head, hd).transpose(1, 2)
                   for lin in (self.Wq, self.Wk, self.Wv))

        masked = self.valid_len is not None and self.valid_len < T
        path = "einsum" if self.save_attn_map or masked else route(
            T, hd, self.pallas_kernel)
        if path == "einsum":
            # (B,H,T,T) logits in the compute dtype, divided by sqrt(F) as
            # the JAX einsum path does
            sqrt_d = torch.tensor(F**0.5, dtype=self.dtype, device=x.device)
            logits = torch.einsum("bhif,bhjf->bhij", q, k) / sqrt_d
            if masked:
                key_ok = torch.arange(T, device=x.device) < self.valid_len
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

        out = self.out_project(out.reshape(B, T, F))
        return dropout(out, self.rate, deterministic, generator)
