"""BatchNorm with torch's running statistics, as ``vit_cifar_tpu/ops/norm.py``.

The reference's BatchNorm sites (torch ``nn.BatchNorm1d/2d`` and the
hamburger bread's SynchronizedBatchNorm) normalize with the *biased* batch
variance in training but store the *unbiased* one in ``running_var``;
flax's own BatchNorm stores the biased one.  ``TorchBatchNorm`` keeps the
torch rule with flax's conventions: ``momentum`` is the running average's
decay (``ra = momentum * ra + (1 - momentum) * stat``: flax 0.9 is torch's
0.1), the features are the LAST axis, and the statistics are the buffers
``mean`` and ``var`` (flax's ``batch_stats`` names).  The affine
parameters are ``weight`` and ``bias`` (flax's ``scale`` and ``bias``).

Calling one module twice in a forward updates the statistics twice, in
call order, as the reference's BN shared between x and the cls token does.
The running statistics are chosen by ``deterministic`` (flax's
``use_running_average``), never by ``nn.Module.training``.

Under a data axis the batch statistics are the global batch's, as GSPMD
takes them over the sharded axis in JAX and the reference's SyncBN did
(hamburger/sync_bn.py): both passes sum over the rank's rows and then over
the axis (differentiably), ``n`` is the global count, and the running
buffers stay equal on every rank.  The one-process path takes the same
sums over n, so the two agree bit for bit at one rank.
"""

from __future__ import annotations

import torch
from torch import nn

from ..parallel.collectives import Axis, summed


class TorchBatchNorm(nn.Module):
    """Normalizes over every axis but the last, in f32; the result is cast
    to ``dtype``.  In training (``deterministic=False``) it uses the
    two-pass biased batch variance and folds the unbiased one into ``var``,
    in place and without gradients; otherwise it uses the buffers."""

    EPS = 1e-5  # every BatchNorm of the reference keeps torch's default
    data_axis: Axis | None = None

    def __init__(self, features: int, momentum: float = 0.9, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.momentum, self.dtype = momentum, dtype
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, *,
                deterministic: bool = True) -> torch.Tensor:
        xf = x.to(torch.float32)
        if deterministic:
            mean, var = self.mean, self.var
        else:
            dims = tuple(range(x.dim() - 1))
            data = self.data_axis
            n = x.numel() // x.shape[-1]
            if data is not None:
                n *= data.size

            if n <= 1:
                # torch raises "Expected more than 1 value per channel when
                # training"; a zero-variance update would train quietly
                raise ValueError(
                    "TorchBatchNorm: expected more than 1 value per channel "
                    f"when training, got input size {tuple(x.shape)}")

            def total(t):
                t = t.sum(dims)
                return t if data is None else summed(t, data)

            mean = total(xf) / n
            var = total((xf - mean).square()) / n
            m = self.momentum
            with torch.no_grad():
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                unbiased = var * (n / (n - 1))
                self.var.copy_(m * self.var + (1.0 - m) * unbiased)
        y = (xf - mean) * torch.rsqrt(var + self.EPS)
        return (y * self.weight + self.bias).to(self.dtype)
