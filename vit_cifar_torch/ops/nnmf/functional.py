"""The NNMF iterate with the reference's hand-derived backward, as
``vit_cifar_tpu/ops/nnmf/functional.py``.

Reference: nnmf/NNMFLayerSbSBP.py:312-520 (NNMFFunctionalBP),
nnmf/AutoNNMFLayer.py:334-506 and nnmf/NNMFLinear.py:249-418, one math core
over (B, C, P) inputs (P spatial positions, 1 for the linear case) and
(C, M) weights, column-stochastic over C.

Forward, ``iterations`` times from h = 1/M:
    R = W @ h;  h <- normalize(h + eps0 * h * (W^T @ (input / (R + eps))))
with eps 1e-20 (1e-5 for the Auto layer).  It runs without autograd and
keeps only (input, W, h) for the backward.

The backward is NOT the gradient of the forward: it is the reference's
reconstruction-ratio rule (NNMFLayerSbSBP.py:432-479), in JAX's order of
operations:
  1. with ``scale_grad``, g /= max(|g|) (the reference's carried scale is
     dead state, see the JAX module);
  2. the saved input is L1-normalized again over C;
  3. grad_input = s / (R + 1e-20), with R = W h and s = W (h * g);
  4. grad_W by the local-learning rule  -2 sum (input - R) h,  or the
     backprop rule  sum input (R g - s) h / (R^2 + 1e-20),  or zeros when
     the weight is not trainable;
  5. a trainable grad_W is divided by the contribution count B*P (the
     reference's ``update_pre_care``);
  6. with ``clamp_grad``, both gradients are clamped to +-5.

Under a data axis (``op(input, weights, data)``) the backward applies the
rule to the global batch, as JAX's custom VJP does under GSPMD: a rank's
cotangent is n times the global one (its loss is the mean over its own
rows), so it is divided by n; the max of step 1 and the sums of grad_W are
taken over every rank and the count of step 5 is the global one; grad_W
comes back as the global value on every rank (the train step's mean over
ranks keeps it) and grad_input in the rank's units, times n.

The JAX backward starts with an ``optimization_barrier``, a guard against
an XLA fusion; eager PyTorch fuses nothing, and the renormalization runs
inside the backward as written.  The JAX module's environment-variable
diagnostics (``NNMF_DEBUG``, ``NNMF_SANITIZE_*``, ``NNMF_DUMP``) served that
fault and are not ported.

``unfold`` is torch's ``F.unfold`` with dilation 1 (the reference passes
dilation 0, which torch rejects at run time; 1 is the intended semantics,
as in the JAX package), written as a strided view of the padded input:
on CUDA ``F.unfold`` launches one im2col kernel per image, and for a
kernel as large as the image (``sbsed``'s) each has one thread.  In the
zoo's framings (a whole-image or a column kernel at stride 1) the view
needs no copy.  ``fold`` is ``F.fold``, its adjoint.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def make_nnmf_op(iterations: int, eps0: float = 1.0, eps: float = 1e-20,
                 local_learning: bool = False, output_layer: bool = False,
                 w_trainable: bool = False, scale_grad: bool = False,
                 clamp_grad: bool = False,
                 divide_grad_by_contributions: bool = True):
    """``op(input, weights, data=None) -> h`` for a static flag
    configuration: input (B, C, P) L1-normalized over C, weights (C, M);
    h (B, M, P); ``data`` the mesh's data axis, where the batch is cut."""

    def forward_math(inp, w):
        B, C, P = inp.shape
        M = w.shape[1]
        h = torch.full((B, M, P), 1.0 / M, dtype=inp.dtype,
                       device=inp.device)
        for _ in range(iterations):
            r = torch.einsum("cm,bmp->bcp", w, h)
            t = inp / (r + eps)
            h_new = h * torch.einsum("cm,bcp->bmp", w, t)
            h = h + eps0 * h_new if eps0 > 0 else h_new
            h = h / (h.sum(dim=1, keepdim=True) + eps)
        return h

    class NNMFFunction(torch.autograd.Function):
        @staticmethod
        def forward(ctx, inp, w, data=None):
            h = forward_math(inp, w)
            ctx.save_for_backward(inp, w, h)
            ctx.data = data
            return h

        @staticmethod
        def backward(ctx, g):
            inp, w, h = ctx.saved_tensors
            data = ctx.data
            B, C, P = inp.shape
            n = 1 if data is None else data.size
            if data is not None:
                g = g / n
            if scale_grad:
                g_max = g.abs().max()
                if data is not None:
                    data.all_reduce_(g_max, dist.ReduceOp.MAX)
                g = g / torch.clamp(g_max, min=1e-20)
            inp = inp / (inp.sum(dim=1, keepdim=True) + 1e-20)
            bigr = torch.einsum("cm,bmp->bcp", w, h)
            s = torch.einsum("cm,bmp->bcp", w, h * g)
            grad_input = s / (bigr + 1e-20)
            grad_w = None
            if ctx.needs_input_grad[1]:
                if not w_trainable:
                    grad_w = torch.zeros_like(w)
                elif local_learning and not output_layer:
                    grad_w = -2.0 * torch.einsum("bcp,bmp->cm", inp - bigr, h)
                else:
                    denom = bigr ** 2 + 1e-20
                    grad_w = (torch.einsum("bcp,bmp->cm", inp * bigr / denom,
                                           h * g)
                              - torch.einsum("bcp,bmp->cm", inp * s / denom,
                                             h))
                if data is not None and w_trainable:
                    data.all_reduce_(grad_w)
                if divide_grad_by_contributions and w_trainable:
                    grad_w = grad_w / (B * n * P)
                if clamp_grad:
                    grad_w = torch.clamp(grad_w, -5.0, 5.0)
            if clamp_grad:
                grad_input = torch.clamp(grad_input, -5.0, 5.0)
            if data is not None:
                grad_input = grad_input * n
            return grad_input, grad_w, None

    return NNMFFunction.apply


def unfold(x: torch.Tensor, kernel_size, strides=(1, 1),
           padding=(0, 0)) -> torch.Tensor:
    """(B, C, H, W) -> (B, C*kh*kw, H', W'), channel-major patches (c,
    then the kernel row, then the kernel column), as torch orders them."""
    B, C = x.shape[:2]
    (kh, kw), (sh, sw), (ph, pw) = kernel_size, strides, padding
    if ph or pw:
        x = F.pad(x, (pw, pw, ph, ph))
    patches = x.unfold(2, kh, sh).unfold(3, kw, sw)  # (B, C, H', W', kh, kw)
    Hp, Wp = patches.shape[2:4]
    return patches.permute(0, 1, 4, 5, 2, 3).reshape(B, C * kh * kw, Hp, Wp)


def fold(patches: torch.Tensor, output_size, kernel_size, strides=(1, 1),
         padding=(0, 0)) -> torch.Tensor:
    """(B, C*kh*kw, H', W') -> (B, C, H, W), summing overlapping patches:
    the adjoint of :func:`unfold`."""
    B = patches.shape[0]
    return F.fold(patches.reshape(B, patches.shape[1], -1),
                  tuple(output_size), tuple(kernel_size), dilation=1,
                  padding=tuple(padding), stride=tuple(strides))


def conv_output_size(size, kernel, stride=(1, 1), padding=(0, 0)):
    return ((size[0] + 2 * padding[0] - (kernel[0] - 1) - 1) // stride[0] + 1,
            (size[1] + 2 * padding[1] - (kernel[1] - 1) - 1) // stride[1] + 1)
