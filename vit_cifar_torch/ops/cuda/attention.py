"""Fused multi-head self-attention, forward and backward: the whole-head
CUDA kernel, its plain PyTorch version and the autograd Function.

``fused_attention`` is the port of ``vit_cifar_tpu/ops/pallas/attention.py::
fused_attention``: (B, H, T, D) q, k, v -> (B, T, H, D) context, softmax and
products in f32, output in q's dtype.  Where a gradient is needed it runs
:class:`FusedAttentionFunction`, the counterpart of the JAX custom VJP
(``fused_attention.defvjp(_fwd, _bwd)``): its forward runs the whole-head
kernel that also writes the row logsumexp and saves only (q, k, v, out,
lse), never a (B, H, T, T) tensor; its backward runs the tiled dq pass, then
the tiled dk/dv pass (``flash_attention.py``), as the JAX ``_bwd`` runs
``_flash_bwd_impl`` on the same residuals.  Without a gradient it runs the
inference kernel.

Each wrapper calls its operator (``registry.py``): for a CPU tensor the
operator runs the kernel's plain version, for a CUDA tensor it launches the
hand-written kernel (``csrc/``, built at first use) or raises; there is no
fallback between the two.  Each wrapper counts its kernel's launches in
``<wrapper>.launches``.

The forward kernel dispatches by dtype.  bf16 runs the warp-specialised
wgmma kernel (``csrc/wgmma_attention.cuh``): TMA reads q, k and v in place
from the caller's (B, H, T, D) views -- on the model's path transposed
views of its (B, T, H, D) projections -- through tensor maps, the whole
head as one key tile where a warpgroup's registers hold it (T <= 128 at
head_dim 32) and the tiled forward's main loop beyond, p split into bf16
hi + lo so that p.v keeps f32 accuracy; heads past 256 columns, up to
512, on the same kernel in chunks of o of 192 or 256 columns, a work item
each, s summed over the whole head; past 512 columns its streamed
instance, which sums s over 64-column chunks of q and K that come through
the ring, at any width.  A view TMA cannot read (``tma_plan``) is
copied into a padded buffer first.  f32 runs on the CUDA cores in full
f32 (one TF32 product would miss the f32 limit of 1e-5, and the forward
has not taken the backward pair's split products): the whole head
in shared memory where it fits
(``whole_head_fits``), else K and V walked in tiles of 64 keys, at any
(T, D), as ``_mhsa_kernel`` runs.

=======================  ===================  ===============================
wrapper                  kernel               plain version
=======================  ===================  ===============================
``fused_attention``      ``mhsa_fwd.cu``      ``fused_attention_reference``
``fused_attention_lse``  ``mhsa_fwd.cu`` +lse ``fused_attention_lse_reference``
=======================  ===================  ===============================
"""

from __future__ import annotations

import torch

from . import registry
from .common import (COL_CHUNK, MAX_SMEM_BYTES, check_device, launch_forward,
                     plain_impl)
from .flash_attention import AttentionFunction

# bytes of one block's shared memory in the f32 tile that walks K and V of a
# head wider than COL_CHUNK (``fwd_f32_chunk_smem_bytes``): the query rows',
# the keys' and the values' column chunks and a row of p for each of 8 warps
F32_CHUNK_SMEM_BYTES = 4 * (64 * COL_CHUNK + 64 * (COL_CHUNK + 1)
                             + 64 * COL_CHUNK + 8 * 64)


def _stride_elems(width: int) -> int:
    """A staged bf16 row of ``width`` columns: an odd number of 16-byte
    chunks (``stride_elems`` in ``csrc/attention_common.cuh``)."""
    return 8 * (((width + 7) // 8) | 1)


def whole_head_smem_bytes(T: int, D: int) -> int:
    """The router's threshold at (T, D) in bytes: the formula of
    ``mhsa_fwd_smem_bytes``, which the card tests hold equal to the
    library's.  Up to COL_CHUNK columns the f32 whole-head layout of K and
    V (8 warps); past it the larger of an earlier bf16 design's layout,
    K and V of T rows by column chunk, and the f32 tile's, kept so that
    the same shapes take the same kernel.  It takes no dtype."""
    if D <= COL_CHUNK:
        return 4 * (T * (D + 1) + T * D + 8 * D + 8 * T)
    chunks = -(-D // COL_CHUNK)
    row = ((chunks - 1) * _stride_elems(COL_CHUNK)
           + _stride_elems(D - (chunks - 1) * COL_CHUNK))
    return max(2 * (8 + 2 * T * row), F32_CHUNK_SMEM_BYTES)


def whole_head_fits(T: int, D: int) -> bool:
    """Whether the whole-head forward can hold a head of (T, D) in a
    block's shared memory; the backward is the tiled pair's, which runs at
    any (T, D)."""
    return whole_head_smem_bytes(T, D) <= MAX_SMEM_BYTES


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def fused_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain version: einsums with an f32 softmax, cast to q's dtype."""
    qf, kf, vf = (a.to(torch.float32) for a in (q, k, v))
    p = torch.softmax(torch.einsum("bhid,bhjd->bhij", qf, kf) * scale, dim=-1)
    return torch.einsum("bhij,bhjd->bihd", p, vf).to(q.dtype)


def fused_attention_lse_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, scale: float):
    """Plain version of the training forward: (out (B, T, H, D) in q's
    dtype, lse (B, H, T) f32), lse = rowmax + log(rowsum) of the scaled
    logits, as ``_mhsa_kernel`` writes it."""
    qf, kf, vf = (a.to(torch.float32) for a in (q, k, v))
    s = torch.einsum("bhid,bhjd->bhij", qf, kf) * scale
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhij,bhjd->bihd", e / l, vf).to(q.dtype)
    return out, (m + torch.log(l)).squeeze(-1)


# --------------------------------------------------------------------------
# kernels, as operators
# --------------------------------------------------------------------------

def _mhsa_fwd_cuda(q, k, v, scale):
    out, _ = launch_forward("mhsa_fwd", q, k, v, scale, with_lse=False)
    fused_attention.launches += 1
    return out


def _mhsa_fwd_lse_cuda(q, k, v, scale):
    out, lse = launch_forward("mhsa_fwd", q, k, v, scale, with_lse=True)
    fused_attention_lse.launches += 1
    return out, lse


registry.register("mhsa_fwd", cpu=plain_impl(fused_attention_reference),
                  cuda=_mhsa_fwd_cuda, fake=registry.fwd_fake)
registry.register("mhsa_fwd_lse", cpu=plain_impl(fused_attention_lse_reference),
                  cuda=_mhsa_fwd_lse_cuda, fake=registry.fwd_lse_fake)


def fused_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float):
    """Training forward: (B, H, T, D)^3 -> (out (B, T, H, D), lse (B, H, T)
    f32), the operator ``vit_cifar_torch::mhsa_fwd_lse``.  Launches counted
    in ``fused_attention_lse.launches``.  bf16 runs on the tensor cores, f32
    on the CUDA cores (a dispatch by dtype; see above)."""
    check_device(q)
    return registry.OPS.mhsa_fwd_lse(q, k, v, scale)


class FusedAttentionFunction(AttentionFunction):
    """The custom VJP of ``fused_attention``: :class:`AttentionFunction`
    on the whole-head forward with lse (``fused_attention_lse``), whose
    backward is the tiled pair's, as the JAX ``_bwd`` runs
    ``_flash_bwd_impl``: ``apply(q, k, v, scale)``."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        return AttentionFunction.forward(ctx, q, k, v, scale,
                                         fused_attention_lse)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """(B, H, T, D)^3 -> (B, T, H, D) attention context.

    Where a gradient is needed: :class:`FusedAttentionFunction`.  Otherwise
    the operator ``vit_cifar_torch::mhsa_fwd``: the plain version for CPU
    tensors, the inference kernel for CUDA tensors, its launches counted in
    ``fused_attention.launches`` (bf16 on the tensor cores, f32 on the CUDA
    cores, a dispatch by dtype).
    """
    check_device(q)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FusedAttentionFunction.apply(q, k, v, scale)
    return registry.OPS.mhsa_fwd(q, k, v, scale)


for _wrapper in (fused_attention, fused_attention_lse):
    _wrapper.launches = 0
del _wrapper
