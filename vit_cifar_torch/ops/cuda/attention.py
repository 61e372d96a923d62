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
the ring, at any width.  f32 up to 128 columns runs the same grids on
TF32 wgmma (``csrc/wgmma_forward_tf32.cuh``): q and each key tile split
into TF32 big + small, s = q.k^T as three TF32 products, p.V on V's three
bf16 terms (six bf16 products with the transpose bit) or its TF32
transpose, each key tile's part of o added into it in f32, so that it keeps
the f32 limit of 1e-5; the whole head as one key tile up to T=72 at
head_dim 32 (64 at 64, 32 at 128), the tiled items beyond; past 128
columns the tiled forward's streamed instance (``flash_attention.py``
says how), so no forward runs on the CUDA cores.  A view TMA cannot read
(``tma_plan``) is copied into a padded buffer first.

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
from .common import check_device, launch_forward, plain_impl
from .flash_attention import AttentionFunction

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
    in ``fused_attention_lse.launches``.  Both dtypes run on the tensor
    cores, f32 on TF32 with split products (see above)."""
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
    ``fused_attention.launches`` (on the tensor cores, f32 on TF32 wgmma).
    """
    check_device(q)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FusedAttentionFunction.apply(q, k, v, scale)
    return registry.OPS.mhsa_fwd(q, k, v, scale)


for _wrapper in (fused_attention, fused_attention_lse):
    _wrapper.launches = 0
del _wrapper
