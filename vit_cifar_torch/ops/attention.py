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
``pallas_kernel="einsum"``, which forces the plain path, and the default
config at a shape no kernel takes (head_dim past the tiled kernels' 128 and
a head the whole-head kernels cannot hold), which is the JAX module's
default path at every shape.
"""

from __future__ import annotations

import torch
from torch import nn

from .common import dropout
from .cuda.attention import fused_attention, whole_head_fits
from .cuda.flash_attention import MAX_HEAD_DIM, flash_attention
from .init import Linear


def route(T: int, D: int, pallas_kernel: str | None, training: bool) -> str:
    """The attention path at sequence length T and head_dim D: "einsum"
    (plain PyTorch), "fused" (the whole-head kernels, ``fused_attention``)
    or "flash" (the tiled kernels, ``flash_attention``).

    ``"einsum"`` and ``"flash"`` are taken as asked, at any T (``"flash"``
    raises on the card past head_dim ``MAX_HEAD_DIM``).  The default (``""``
    or None) takes the whole-head kernels while their shared memory holds a
    head at (T, D) -- the forward alone, or with ``training`` the forward
    and both backward kernels -- and beyond that the tiled kernels up to
    head_dim ``MAX_HEAD_DIM``, and the einsum path past it, as the JAX
    module's default takes at every shape.  ``"fused"`` beyond the
    whole-head kernels' shared memory raises."""
    if pallas_kernel in ("einsum", "flash"):
        return pallas_kernel
    if whole_head_fits(T, D, training):
        return "fused"
    if pallas_kernel == "fused":
        raise ValueError(
            f"pallas_kernel='fused': the whole-head kernels cannot hold "
            f"T={T}, head_dim={D}{' for training' if training else ''} in "
            "a block's shared memory; use 'flash' or the default")
    return "flash" if D <= MAX_HEAD_DIM else "einsum"


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
            T, hd, self.pallas_kernel, torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)))
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
