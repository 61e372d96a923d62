"""Fused multi-head self-attention forward: the CUDA kernel and its plain
PyTorch version.

``fused_attention`` is the port of ``vit_cifar_tpu/ops/pallas/attention.py::
fused_attention`` for inference: (B, H, T, D) q, k, v -> (B, T, H, D)
context, softmax and products in f32, output in q's dtype.  On a CUDA tensor
it launches the hand-written kernel ``csrc/mhsa_fwd.cu`` (built at first
use) or raises; on a CPU tensor it runs :func:`fused_attention_reference`.
There is no fallback between the two.  The backward kernels come with
training, so the kernel refuses inputs that would need a gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch

# Hopper's opt-in maximum of dynamic shared memory for one block.
MAX_SMEM_BYTES = 232_448
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def fused_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain version: einsums with an f32 softmax, cast to q's dtype."""
    qf, kf, vf = (a.to(torch.float32) for a in (q, k, v))
    p = torch.softmax(torch.einsum("bhid,bhjd->bhij", qf, kf) * scale, dim=-1)
    return torch.einsum("bhij,bhjd->bihd", p, vf).to(q.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    from .build import load_library

    lib = load_library("mhsa_fwd")
    lib.mhsa_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.mhsa_fwd.restype = ctypes.c_int
    lib.mhsa_fwd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.mhsa_fwd_smem_bytes.restype = ctypes.c_longlong
    return lib


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


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """(B, H, T, D)^3 -> (B, T, H, D) attention context.

    CPU tensors go to the plain version; CUDA tensors to the kernel, whose
    launches are counted in ``fused_attention.launches``.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no fused_attention for device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "fused_attention has no backward on CUDA yet: backward kernels "
            "are ported with training; run inference under torch.no_grad()")
    q, k, v = (a.contiguous() for a in (q, k, v))
    B, H, T, D = q.shape
    lib = _library()
    smem = lib.mhsa_fwd_smem_bytes(T, D)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"fused_attention at T={T}, D={D} needs {smem} bytes of shared "
            f"memory, over the {MAX_SMEM_BYTES} a block may use")
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.mhsa_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), B, H, T, D, float(scale),
                           _DTYPE_CODES[q.dtype],
                           torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mhsa_fwd launch failed: cudaError {err}")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
