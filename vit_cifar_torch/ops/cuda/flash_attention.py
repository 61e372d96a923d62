"""Tiled ("flash") multi-head self-attention, forward and backward, at any
sequence length: the CUDA kernels and their plain PyTorch versions.

``flash_attention`` is the port of ``vit_cifar_tpu/ops/pallas/attention.py::
flash_attention``: (B, H, T, D) q, k, v -> (B, T, H, D) context, softmax and
products in f32, output in q's dtype.  Where a gradient is needed it runs
:class:`FlashAttentionFunction`, the counterpart of the JAX custom VJP
(``flash_attention.defvjp(_flash_fwd, _flash_bwd)``): its forward runs the
kernel that also writes the row logsumexp and saves only (q, k, v, out,
lse), never a (B, H, T, T) tensor; its backward runs the tiled dq kernel,
then the tiled dk/dv kernel (``_flash_bwd_impl``'s two passes).  Without a
gradient it runs the inference kernel.  :class:`AttentionFunction` is that
custom VJP for either forward (the whole-head one of ``attention.py`` too):
the forward it runs is an argument, the backward one.

These tile both the queries and the keys, so they run at any T and any
D.  The bf16 forward is the warp-specialised wgmma kernel
(``csrc/wgmma_attention.cuh``): 128 query rows a work item against key
tiles of 32 to 128 keys brought by TMA straight from the caller's (B, H,
T, D) views, heads up to 256 columns in one pass and up to
``WIDEST_FORWARD`` (512) in chunks of o of 192 or 256 columns, a work
item each; past 512 the same chunks of o with s summed over 64-column
chunks of q and K brought through the ring (the streamed instance), so
any width runs.  The bf16 backward pair is two warp-specialised
wgmma kernels (``csrc/wgmma_backward.cuh``, tiles by width in
``csrc/backward_tiles.cuh``): dq with 128 query rows a work item against
key tiles, dk/dv with 128 keys against query tiles, both reading q, k,
v, o and do in place and writing the gradients in q's, k's and v's
strides; past ``COL_CHUNK`` columns on the same kernels a work item is 64
rows and two column chunks (s and dp summed over all the columns), and
past ``WIDEST_BACKWARD`` (512) columns their streamed instances sum s and
dp over 64-column chunks of both operands brought through the ring, at
any width.  The plain versions take every query row at once and tile the
keys by ``BLOCK_KV``.
The JAX signature's ``block_q`` and ``block_kv`` are not taken: they change
the result only through the order of f32 sums.  lse is (B, H, T) f32, not
the TPU's lane-broadcast (B, H, Tq, 128).

Each wrapper calls its operator (``registry.py``): for a CPU tensor the
operator runs the kernel's plain version, for a CUDA tensor it launches the
hand-written kernel (``csrc/flash_*.cu``, built at first use) or raises;
there is no fallback between the two.  Each wrapper counts its kernel's
launches in ``<wrapper>.launches``.

Every kernel dispatches by dtype: bf16 runs on the tensor cores (wgmma
up to the widths above; p, and in the backward ds, split into bf16 hi +
lo so that the product that follows keeps f32 accuracy).  In f32 the
forwards and the backward pair at every width run the same kernels' design
on TF32 wgmma (``csrc/wgmma_forward_tf32.cuh``, ``csrc/wgmma_tf32.cuh``):
one TF32 product would miss the f32 limit of 1e-5, so the sums over D (s,
dp) take operands split into TF32 big + small, three TF32 products each
(big.big + big.small + small.big), and the sums over keys or queries (p.V
and the gradient products) three bf16 terms of each operand, six bf16
products, or the tile's TF32 transpose, by the table's row; past
``COL_CHUNK`` (128) columns their streamed instances sum s (and dp) over
32-column chunks brought through the ring, each chunk's part added in
f32, the forward's two consumers sharing s's sum and reading q, K and V
from a split pass that splits them once a call.  Every kernel reads its
inputs through their
strides (``common.launch_forward``, ``common.launch_backward``: only a
layout a tensor map cannot read, D % 8 != 0 in bf16, D % 4 != 0 in f32,
takes one padded copy), and
the backward writes dq, dk and dv through theirs (``torch.empty_like`` of
q, k and v), so on the model's path nothing is copied around the pair and
the module's transposes take their gradients as views.

=========================  ====================  =================================
wrapper                    kernel                plain version
=========================  ====================  =================================
``flash_attention``        ``flash_fwd.cu``      ``flash_attention_reference``
``flash_attention_lse``    ``flash_fwd.cu`` +lse ``flash_attention_lse_reference``
``flash_tiled_bwd_dq``     ``flash_bwd_dq.cu``   ``flash_tiled_bwd_dq_reference``
``flash_tiled_bwd_dkv``    ``flash_bwd_dkv.cu``  ``flash_tiled_bwd_dkv_reference``
=========================  ====================  =================================
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import registry
from .common import (bwd_terms, check_bwd, check_device, launch_backward,
                     launch_forward, plain_impl)

# the plain versions' key tile, the JAX kernels' default ``block_kv``;
# (B, H, T, BLOCK_KV) is the largest tensor they form
BLOCK_KV = 512


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def flash_attention_lse_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, scale: float):
    """Plain version of the training forward: the online softmax of
    ``_flash_fwd_body`` over key tiles of ``BLOCK_KV``, every query row at
    once.  Returns (out (B, T, H, D) in q's dtype, lse (B, H, T) f32).

    The running max m, normaliser l and unnormalised context acc are kept
    as the TPU kernel keeps them; the last tile is padded and its missing
    keys masked to -inf, and a fully masked tile leaves m at -inf without
    a NaN (``safe_m`` and ``corr``)."""
    B, H, T, D = q.shape
    bk = min(BLOCK_KV, T)
    qf, kf, vf = (a.to(torch.float32) for a in (q, k, v))
    m = torch.full((B, H, T, 1), -torch.inf, device=q.device)
    l = torch.zeros((B, H, T, 1), device=q.device)
    acc = torch.zeros((B, H, T, D), device=q.device)
    for k0 in range(0, T, bk):
        pad = (0, 0, 0, k0 + bk - min(T, k0 + bk))
        kt, vt = (F.pad(a[:, :, k0:k0 + bk], pad) for a in (kf, vf))
        s = torch.einsum("bhid,bhjd->bhij", qf, kt) * scale
        col = torch.arange(k0, k0 + bk, device=q.device)
        s = torch.where(col < T, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - safe_m)
        corr = torch.exp(torch.where(torch.isfinite(m), m - safe_m,
                                     -torch.inf))
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhij,bhjd->bhid", p, vt)
        m = m_new
    out = (acc / l).transpose(1, 2).to(q.dtype)
    return out, (m + torch.log(l)).squeeze(-1)


def flash_attention_reference(q, k, v, scale: float) -> torch.Tensor:
    """Plain version of the inference forward: (B, T, H, D) in q's dtype."""
    return flash_attention_lse_reference(q, k, v, scale)[0]


def _kv_tiles(T: int):
    return [slice(k0, k0 + BLOCK_KV) for k0 in range(0, T, BLOCK_KV)]


def flash_tiled_bwd_dq_reference(q, k, v, o, do, lse,
                                 scale: float) -> torch.Tensor:
    """Plain version of the tiled dq pass: dq = sum over key tiles of
    ds.k, (B, H, T, D) in q's dtype; nothing larger than (B, H, T,
    BLOCK_KV) is formed.  ``o`` and ``do`` are (B, T, H, D); ``lse`` is
    (B, H, T) f32."""
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for t in _kv_tiles(q.shape[2]):
        _, kf, _, _, ds = bwd_terms(q, k[:, :, t], v[:, :, t], o, do, lse,
                                     scale)
        dq += torch.einsum("bhij,bhjd->bhid", ds, kf)
    return dq.to(q.dtype)


def flash_tiled_bwd_dkv_reference(q, k, v, o, do, lse, scale: float):
    """Plain version of the tiled dk/dv pass, key tile by key tile: dk =
    ds^T.q, dv = p^T.do, both (B, H, T, D) in k's and v's dtype."""
    dk, dv = [], []
    for t in _kv_tiles(q.shape[2]):
        qf, _, dof, p, ds = bwd_terms(q, k[:, :, t], v[:, :, t], o, do, lse,
                                       scale)
        dk.append(torch.einsum("bhij,bhid->bhjd", ds, qf))
        dv.append(torch.einsum("bhij,bhid->bhjd", p, dof))
    return torch.cat(dk, dim=2).to(k.dtype), torch.cat(dv, dim=2).to(v.dtype)


# --------------------------------------------------------------------------
# kernels, as operators
# --------------------------------------------------------------------------

def _flash_fwd_cuda(q, k, v, scale):
    out, _ = launch_forward("flash_fwd", q, k, v, scale, with_lse=False)
    flash_attention.launches += 1
    return out


def _flash_fwd_lse_cuda(q, k, v, scale):
    out, lse = launch_forward("flash_fwd", q, k, v, scale, with_lse=True)
    flash_attention_lse.launches += 1
    return out, lse


def _bwd_dq_cuda(q, k, v, o, do, lse, scale):
    dq = torch.empty_like(q)
    launch_backward("flash_bwd_dq", q, k, v, o, do, lse, (dq,), scale)
    flash_tiled_bwd_dq.launches += 1
    return dq


def _bwd_dkv_cuda(q, k, v, o, do, lse, scale):
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    launch_backward("flash_bwd_dkv", q, k, v, o, do, lse, (dk, dv), scale)
    flash_tiled_bwd_dkv.launches += 1
    return dk, dv


registry.register("flash_fwd", cpu=plain_impl(flash_attention_reference),
                  cuda=_flash_fwd_cuda, fake=registry.fwd_fake)
registry.register("flash_fwd_lse",
                  cpu=plain_impl(flash_attention_lse_reference),
                  cuda=_flash_fwd_lse_cuda, fake=registry.fwd_lse_fake)
# the gradients in q's, k's and v's layouts, as the kernels write them
registry.register("flash_bwd_dq",
                  cpu=plain_impl(flash_tiled_bwd_dq_reference, check_bwd,
                                 like=lambda q, k, v, *_: (q,)),
                  cuda=_bwd_dq_cuda,
                  fake=lambda q, k, v, o, do, lse, scale: torch.empty_like(q))
registry.register("flash_bwd_dkv",
                  cpu=plain_impl(flash_tiled_bwd_dkv_reference, check_bwd,
                                 like=lambda q, k, v, *_: (k, v)),
                  cuda=_bwd_dkv_cuda,
                  fake=lambda q, k, v, o, do, lse, scale: (
                      torch.empty_like(k), torch.empty_like(v)))


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float):
    """Training forward: (B, H, T, D)^3 -> (out (B, T, H, D), lse (B, H, T)
    f32), the operator ``vit_cifar_torch::flash_fwd_lse``.  Launches
    counted in ``flash_attention_lse.launches``.  bf16 runs on the tensor
    cores, f32 on TF32 wgmma, past 128 columns its streamed instance (a
    dispatch by dtype and width; see above)."""
    check_device(q)
    return registry.OPS.flash_fwd_lse(q, k, v, scale)


def flash_tiled_bwd_dq(q, k, v, o, do, lse, scale: float) -> torch.Tensor:
    """dq of the flash attention, (B, H, T, D) in q's dtype and layout
    (``torch.empty_like(q)``), the operator ``vit_cifar_torch::flash_bwd_dq``.
    q, k, v are (B, H, T, D) views, o and do (B, T, H, D), read in place.
    Launches counted in ``flash_tiled_bwd_dq.launches``.  bf16 runs on the
    tensor cores, f32 on TF32 wgmma, past 128 columns its streamed instance
    (a dispatch by dtype and width; see above)."""
    check_device(q)
    return registry.OPS.flash_bwd_dq(q, k, v, o, do, lse, scale)


def flash_tiled_bwd_dkv(q, k, v, o, do, lse, scale: float):
    """(dk, dv) of the flash attention, each (B, H, T, D) in the input
    dtype and in k's and v's layouts, the operator
    ``vit_cifar_torch::flash_bwd_dkv``; its arguments as
    ``flash_tiled_bwd_dq``'s.  Launches counted in
    ``flash_tiled_bwd_dkv.launches``.  bf16 runs on the tensor cores, f32 on
    TF32 wgmma, past 128 columns its streamed instance (a dispatch by dtype
    and width)."""
    check_device(q)
    return registry.OPS.flash_bwd_dkv(q, k, v, o, do, lse, scale)


class AttentionFunction(torch.autograd.Function):
    """The custom VJP of both attentions (JAX's ``flash_attention`` and
    ``fused_attention`` ``defvjp``): ``apply(q, k, v, scale, lse_forward)``
    runs ``lse_forward(q, k, v, scale)`` -> (out, lse) and saves exactly
    (q, k, v, out, lse), the caller's views and no copy of them; the
    backward runs the tiled dq pass, then the tiled dk/dv pass, on those
    views as they are (JAX's ``_flash_bwd_impl``), and returns the
    gradients in q's, k's and v's layouts.  ``scale`` and ``lse_forward``
    get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, lse_forward):
        out, lse = lse_forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq = flash_tiled_bwd_dq(q, k, v, out, g, lse, ctx.scale)
        dk, dv = flash_tiled_bwd_dkv(q, k, v, out, g, lse, ctx.scale)
        return dq, dk, dv, None, None


class FlashAttentionFunction(AttentionFunction):
    """:class:`AttentionFunction` on the tiled forward with lse
    (``flash_attention_lse``): ``apply(q, k, v, scale)``."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        return AttentionFunction.forward(ctx, q, k, v, scale,
                                         flash_attention_lse)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """(B, H, T, D)^3 -> (B, T, H, D) attention context, at any T.

    Where a gradient is needed: :class:`FlashAttentionFunction`.  Otherwise
    the operator ``vit_cifar_torch::flash_fwd``: the plain version for CPU
    tensors, the inference kernel for CUDA tensors, its launches counted in
    ``flash_attention.launches`` (on the tensor cores, f32 on TF32 wgmma).
    """
    check_device(q)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, scale)
    return registry.OPS.flash_fwd(q, k, v, scale)


for _wrapper in (flash_attention, flash_attention_lse, flash_tiled_bwd_dq,
                 flash_tiled_bwd_dkv):
    _wrapper.launches = 0
del _wrapper
