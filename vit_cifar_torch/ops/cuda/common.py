"""What the whole-head (``attention.py``) and tiled (``flash_attention.py``)
attention wrappers share: the ctypes binding and launch of a kernel
library, the checks of their arguments, and the terms of the plain
backward passes."""

from __future__ import annotations

import ctypes
import functools

import torch

# Hopper's opt-in maximum of dynamic shared memory for one block.
MAX_SMEM_BYTES = 232_448
# Heads wider than this many columns are cut into column chunks of it by
# every kernel (``kColChunk`` in ``csrc/attention_common.cuh``).
COL_CHUNK = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, built at first use."""
    from .build import load_library

    lib = load_library(name)
    getattr(lib, name).restype = ctypes.c_int
    for suffix in ("smem_bytes", "key_tiled_smem_bytes"):
        smem = getattr(lib, f"{name}_{suffix}", None)
        if smem is not None:
            smem.argtypes = [ctypes.c_int, ctypes.c_int]
            smem.restype = ctypes.c_longlong
    return lib


def launch(name: str, pointers, q: torch.Tensor, scale: float) -> None:
    """Launch kernel ``name`` on q's device and current stream; raises if
    the shape needs too much shared memory or the launch fails.  A kernel
    with a ``<name>_key_tiled_smem_bytes`` entry walks K and V in key tiles
    where its first layout does not fit, and needs that many bytes then."""
    B, H, T, D = q.shape
    lib = library(name)
    smem = getattr(lib, f"{name}_smem_bytes")(T, D)
    tiled = getattr(lib, f"{name}_key_tiled_smem_bytes", None)
    if smem > MAX_SMEM_BYTES and tiled is not None:
        smem = tiled(T, D)
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


def launch_forward(name: str, q, k, v, scale: float, with_lse: bool):
    """Launch forward kernel ``name`` (``mhsa_fwd`` or ``flash_fwd``) after
    its checks: (out (B, T, H, D), lse (B, H, T) f32 or None)."""
    check(q, k, v)
    q, k, v = (a.contiguous() for a in (q, k, v))
    B, H, T, D = q.shape
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, T), dtype=torch.float32, device=q.device)
           if with_lse else None)
    launch(name, (q, k, v, out, lse), q, scale)
    return out, lse


def plain_impl(fn, checks=None):
    """An operator's CPU implementation: the plain version ``fn`` after the
    kernel's checks (``checks``, default ``check``, of every argument but
    the scale), its outputs contiguous as the kernel writes them."""
    checks = checks or check

    def run(*args):
        checks(*args[:-1])
        out = fn(*args)
        if isinstance(out, tuple):
            return tuple(t.contiguous() for t in out)
        return out.contiguous()
    return run


def check_device(q: torch.Tensor) -> None:
    """A wrapper's refusal of a device that neither the plain version (the
    CPU) nor the kernel (CUDA) runs on, before the operator's dispatch,
    which would answer a meta tensor from the fake implementation."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no attention kernel for device {q.device}")


def check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("attention takes q, k, v of one (B, H, T, D) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise ValueError("attention takes float32 or bfloat16 q, k, v "
                         f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v lie on different devices: "
                         f"{q.device}, {k.device}, {v.device}")
    if min(q.shape) < 1:
        raise ValueError(f"empty shape {tuple(q.shape)}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no attention kernel for device {q.device}")


def check_bwd(q, k, v, o, do, lse) -> None:
    check(q, k, v)
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


def bwd_terms(q, k, v, o, do, lse, scale):
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
