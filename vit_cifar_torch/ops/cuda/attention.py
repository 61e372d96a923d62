"""Fused multi-head self-attention, forward and backward: the CUDA kernels
and their plain PyTorch versions.

``fused_attention`` is the port of ``vit_cifar_tpu/ops/pallas/attention.py::
fused_attention``: (B, H, T, D) q, k, v -> (B, T, H, D) context, softmax and
products in f32, output in q's dtype.  Where a gradient is needed it runs
:class:`FusedAttentionFunction`, the counterpart of the JAX custom VJP
(``fused_attention.defvjp(_fwd, _bwd)``): its forward runs the kernel that
also writes the row logsumexp and saves only (q, k, v, out, lse), never a
(B, H, T, T) tensor; its backward runs the dq kernel, then the dk/dv kernel.
Without a gradient it runs the inference kernel.

Each wrapper takes its kernel's plain version for a CPU tensor, and for a
CUDA tensor launches the hand-written kernel (``csrc/``, built at first use)
or raises; there is no fallback between the two.  Each wrapper counts its
launches in ``<wrapper>.launches``.

The forward kernel dispatches by dtype: bf16 runs on the tensor cores
(``mma.sync``, with p split into bf16 hi + lo so that p.v keeps f32
accuracy), f32 on the CUDA cores in full f32, since the tensor cores would
take f32 only as TF32 and miss the f32 limit of 1e-5.  Head dims past 128
take the CUDA-core design in bf16 too.  The backward kernels run on the
CUDA cores in f32 for both dtypes.

=======================  ===================  ===============================
wrapper                  kernel               plain version
=======================  ===================  ===============================
``fused_attention``      ``mhsa_fwd.cu``      ``fused_attention_reference``
``fused_attention_lse``  ``mhsa_fwd.cu`` +lse ``fused_attention_lse_reference``
``flash_bwd_dq``         ``mhsa_bwd_dq.cu``   ``flash_bwd_dq_reference``
``flash_bwd_dkv``        ``mhsa_bwd_dkv.cu``  ``flash_bwd_dkv_reference``
=======================  ===================  ===============================
"""

from __future__ import annotations

import ctypes
import functools

import torch

# Hopper's opt-in maximum of dynamic shared memory for one block.
MAX_SMEM_BYTES = 232_448
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The whole-head kernels' dynamic shared memory in bytes at (T, D): the
# formulas of ``smem_bytes`` in each source (8 warps, f32), which hold a
# whole head and so grow with T.  The card tests hold them equal to the
# libraries' ``<name>_smem_bytes``.
WHOLE_HEAD_SMEM_BYTES = {
    "mhsa_fwd": lambda T, D: 4 * (T * (D + 1) + T * D + 8 * D + 8 * T),
    "mhsa_bwd_dq": lambda T, D: 4 * (2 * T * (D + 1) + 16 * D + 8 * T),
    "mhsa_bwd_dkv": lambda T, D: 4 * (2 * T * (D + 1) + 2 * T + 16 * D
                                      + 16 * T),
}


def whole_head_fits(T: int, D: int, training: bool) -> bool:
    """Whether the whole-head kernels can run attention at (T, D): the
    inference forward alone, or with ``training`` the forward and both
    backward kernels, within a block's shared memory."""
    names = WHOLE_HEAD_SMEM_BYTES if training else ("mhsa_fwd",)
    return all(WHOLE_HEAD_SMEM_BYTES[n](T, D) <= MAX_SMEM_BYTES
               for n in names)


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


def _bwd_terms(q, k, v, o, do, lse, scale):
    """p and ds of the flash backward, in f32, from the formulas of
    ``_flash_bwd_dq_kernel``: p = exp(s - lse), dp = do.v^T,
    delta = rowsum(do * o), ds = p * (dp - delta) * scale."""
    qf, kf, vf = (a.to(torch.float32) for a in (q, k, v))
    of, dof = (a.to(torch.float32).transpose(1, 2) for a in (o, do))
    s = torch.einsum("bhid,bhjd->bhij", qf, kf) * scale
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bhid,bhjd->bhij", dof, vf)
    delta = (dof * of).sum(dim=-1, keepdim=True)
    return qf, kf, dof, p, p * (dp - delta) * scale


def flash_bwd_dq_reference(q, k, v, o, do, lse, scale: float) -> torch.Tensor:
    """Plain version of the dq pass: dq = ds.k, (B, H, T, D) in q's dtype.
    ``o`` and ``do`` are (B, T, H, D); ``lse`` is (B, H, T) f32."""
    _, kf, _, _, ds = _bwd_terms(q, k, v, o, do, lse, scale)
    return torch.einsum("bhij,bhjd->bhid", ds, kf).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, o, do, lse, scale: float):
    """Plain version of the dk/dv pass: dk = ds^T.q, dv = p^T.do, both
    (B, H, T, D) in k's and v's dtype."""
    qf, _, dof, p, ds = _bwd_terms(q, k, v, o, do, lse, scale)
    dk = torch.einsum("bhij,bhid->bhjd", ds, qf).to(k.dtype)
    dv = torch.einsum("bhij,bhid->bhjd", p, dof).to(v.dtype)
    return dk, dv


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------

@functools.cache
def _library(name: str) -> ctypes.CDLL:
    from .build import load_library

    lib = load_library(name)
    getattr(lib, name).restype = ctypes.c_int
    smem = getattr(lib, f"{name}_smem_bytes")
    smem.argtypes = [ctypes.c_int, ctypes.c_int]
    smem.restype = ctypes.c_longlong
    return lib


def _launch(name: str, pointers, q: torch.Tensor, scale: float) -> None:
    """Launch kernel ``name`` on q's device and current stream; raises if
    the shape needs too much shared memory or the launch fails."""
    B, H, T, D = q.shape
    lib = _library(name)
    smem = getattr(lib, f"{name}_smem_bytes")(T, D)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"{name} at T={T}, D={D} needs {smem} bytes of shared memory, "
            f"over the {MAX_SMEM_BYTES} a block may use")
    # every entry point takes its tensors' pointers (null for an absent
    # output), then B, H, T, D, scale, the dtype code and the stream
    with torch.cuda.device(q.device):
        err = getattr(lib, name)(
            *(ctypes.c_void_p(None if t is None else t.data_ptr())
              for t in pointers),
            *(ctypes.c_int(n) for n in (B, H, T, D)), ctypes.c_float(scale),
            ctypes.c_int(_DTYPE_CODES[q.dtype]),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("fused_attention takes q, k, v of one (B, H, T, D) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise ValueError("fused_attention takes float32 or bfloat16 q, k, v "
                         f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v lie on different devices: "
                         f"{q.device}, {k.device}, {v.device}")
    if min(q.shape) < 1:
        raise ValueError(f"empty shape {tuple(q.shape)}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused_attention for device {q.device}")


def _check_bwd(q, k, v, o, do, lse) -> None:
    _check(q, k, v)
    B, H, T, D = q.shape
    for name, t in (("o", o), ("do", do)):
        if t.shape != (B, T, H, D) or t.dtype != q.dtype \
                or t.device != q.device:
            raise ValueError(
                f"{name} must be {(B, T, H, D)} {q.dtype} on {q.device}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if lse.shape != (B, H, T) or lse.dtype != torch.float32 \
            or lse.device != q.device:
        raise ValueError(f"lse must be {(B, H, T)} float32 on {q.device}, "
                         f"got {tuple(lse.shape)} {lse.dtype} on {lse.device}")


def fused_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float):
    """Training forward: (B, H, T, D)^3 -> (out (B, T, H, D), lse (B, H, T)
    f32).  Launches counted in ``fused_attention_lse.launches``.  bf16 runs on
    the tensor cores, f32 on the CUDA cores (a dispatch by dtype; see
    above)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return fused_attention_lse_reference(q, k, v, scale)
    q, k, v = (a.contiguous() for a in (q, k, v))
    B, H, T, D = q.shape
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    _launch("mhsa_fwd", (q, k, v, out, lse), q, scale)
    fused_attention_lse.launches += 1
    return out, lse


def flash_bwd_dq(q, k, v, o, do, lse, scale: float) -> torch.Tensor:
    """dq of the fused attention, (B, H, T, D) in q's dtype.  Launches
    counted in ``flash_bwd_dq.launches``."""
    _check_bwd(q, k, v, o, do, lse)
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, o, do, lse, scale)
    q, k, v, o, do, lse = (a.contiguous() for a in (q, k, v, o, do, lse))
    dq = torch.empty_like(q)
    _launch("mhsa_bwd_dq", (q, k, v, o, do, lse, dq), q, scale)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, o, do, lse, scale: float):
    """(dk, dv) of the fused attention, each (B, H, T, D) in the input
    dtype.  Launches counted in ``flash_bwd_dkv.launches``."""
    _check_bwd(q, k, v, o, do, lse)
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, o, do, lse, scale)
    q, k, v, o, do, lse = (a.contiguous() for a in (q, k, v, o, do, lse))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("mhsa_bwd_dkv", (q, k, v, o, do, lse, dk, dv), q, scale)
    flash_bwd_dkv.launches += 1
    return dk, dv


class FusedAttentionFunction(torch.autograd.Function):
    """The custom VJP of ``fused_attention``: the forward saves exactly
    (q, k, v, out, lse); the backward runs the dq pass, then the dk/dv
    pass.  ``scale`` gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        q, k, v = (a.contiguous() for a in (q, k, v))
        out, lse = fused_attention_lse(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq = flash_bwd_dq(q, k, v, out, g, lse, ctx.scale)
        dk, dv = flash_bwd_dkv(q, k, v, out, g, lse, ctx.scale)
        return dq, dk, dv, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """(B, H, T, D)^3 -> (B, T, H, D) attention context.

    Where a gradient is needed: :class:`FusedAttentionFunction`.  Otherwise
    CPU tensors go to the plain version and CUDA tensors to the inference
    kernel, whose launches are counted in ``fused_attention.launches``: bf16 on
    the tensor cores, f32 on the CUDA cores (a dispatch by dtype).
    """
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FusedAttentionFunction.apply(q, k, v, scale)
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, scale)
    q, k, v = (a.contiguous() for a in (q, k, v))
    B, H, T, D = q.shape
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    _launch("mhsa_fwd", (q, k, v, out, None), q, scale)
    fused_attention.launches += 1
    return out


for _wrapper in (fused_attention, fused_attention_lse, flash_bwd_dq,
                 flash_bwd_dkv):
    _wrapper.launches = 0
del _wrapper
