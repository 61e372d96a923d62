"""The local-global CNNs (lgcnn, wlgcnn) and the baseline CNN, as
``vit_cifar_tpu/models/cnn.py``.

Reference: cnn.py (``LocalGlobalCNN``, cnn.py:32-109; the broken
``BaselineCNN``, cnn.py:6-29) and layers.py:572-810.  NHWC throughout, as
in the JAX package: every flatten is in NHWC order, so the transplanted
``global_transform`` and ``ann.fc0`` weights mean what they mean there.

  * the patch embedding is a conv with kernel = stride = img/patch, so the
    grid is ``patch`` x ``patch``;
  * the cls "token" is a (k, k, C) image, carried beside x through the
    encoders, which apply ONE set of modules (norms, convolutions, the
    global transform, the MLP) to x and then to cls: a BatchNorm there
    updates its statistics twice a forward, x first;
  * the head is LayerNorm + Linear on the flattened cls;
  * no cls token raises (cnn.py:52-54).

``BaselineCNN`` is the working equivalent of the reference's crashing
cnn_baseline: CNN([3, 32]) then ANN([flat, 1024, 10]).  The ANN's ReLU on
the logits is the reference's (layers.py:1308-1310): training collapses to
loss ln(10) once all ten logits die.

There is no ``--remat`` here: the JAX package has none for these models.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.basic import ANN, CNN
from ..parallel.collectives import Axis
from ..ops.common import LayerNorm, dropout
from ..ops.init import Conv, Linear, normal
from ..ops.norm import TorchBatchNorm


class _ChannelNorm(nn.Module):
    """The norm over channels (layers.py:599-610): LayerNorm or BatchNorm
    over the last axis, as the child ``LayerNorm_0`` or
    ``TorchBatchNorm_0`` (flax's automatic names)."""

    def __init__(self, normalization: str, features: int, *,
                 dtype: torch.dtype, device=None):
        super().__init__()
        if normalization == "layer_norm":
            self.LayerNorm_0 = LayerNorm(features, dtype=dtype, device=device)
        elif normalization == "batch_norm":
            self.TorchBatchNorm_0 = TorchBatchNorm(features, dtype=dtype,
                                                   device=device)
        else:
            raise ValueError(f"normalization {normalization} not supported")
        self.batch_norm = normalization == "batch_norm"

    def forward(self, x: torch.Tensor, *,
                deterministic: bool = True) -> torch.Tensor:
        if self.batch_norm:
            return self.TorchBatchNorm_0(x, deterministic=deterministic)
        return self.LayerNorm_0(x)


def _convs(features, hidden_features, k, kw):
    """The shared conv-in and conv-out of the local-global convolutions."""
    return (Conv(features, hidden_features, (k, k), **kw),
            Conv(hidden_features // 2, features, (k, k), **kw))


class LocalGlobalConvolution(nn.Module):
    """layers.py:572-640 on x (B, p, p, C) and cls (B, k, k, C): conv-in +
    GELU, a channel split, the norm of z2, one Linear over the flattened
    patches with the cls patches appended, the gate z1 * z2, conv-out."""

    def __init__(self, features: int, hidden_features: int, grid: int,
                 kernel_size: int = 1, normalization: str = "layer_norm", *,
                 generator: torch.Generator,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.k, self.C2 = kernel_size, hidden_features // 2
        self.local_conv_in, self.local_conv_out = _convs(
            features, hidden_features, kernel_size, kw)
        self.norm = _ChannelNorm(normalization, self.C2, dtype=dtype,
                                 device=device)
        n = grid * grid + kernel_size ** 2
        self.global_transform = Linear(n, n, **kw)

    def forward(self, x: torch.Tensor, cls: torch.Tensor, *,
                deterministic: bool = True):
        B, p, k, C2 = x.shape[0], x.shape[1], self.k, self.C2
        z1, z2 = F.gelu(self.local_conv_in(x)).chunk(2, dim=-1)
        z2 = self.norm(z2, deterministic=deterministic)
        cls1, cls2 = F.gelu(self.local_conv_in(cls)).chunk(2, dim=-1)
        cls2 = self.norm(cls2, deterministic=deterministic)
        # NCHW's flatten(-2), (B, C, N), is NHWC's (B, N, C) transposed
        z2f = z2.reshape(B, p * p, C2).transpose(1, 2)
        cls2f = cls2.reshape(B, k * k, C2).transpose(1, 2)
        z = self.global_transform(torch.cat([z2f, cls2f], dim=-1))
        z2 = z[..., :p * p].transpose(1, 2).reshape(B, p, p, C2)
        cls2 = z[..., p * p:].transpose(1, 2).reshape(B, k, k, C2)
        return self.local_conv_out(z1 * z2), self.local_conv_out(cls1 * cls2)


class WeightLocalGlobalConvolution(nn.Module):
    """layers.py:644-719: the global transform makes a per-sample
    (C/2, C/2) channel-mixing matrix, which needs
    ``features == hidden_features / 2`` (the reference's defaults, 384 and
    768).  With batch_norm the reference crashes as shipped (BatchNorm2d on
    a 3-D tensor); the norm over channels here is the working
    equivalent."""

    def __init__(self, features: int, hidden_features: int, grid: int,
                 kernel_size: int = 1, normalization: str = "layer_norm", *,
                 generator: torch.Generator,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if 2 * features != hidden_features:
            raise ValueError(
                f"wlgcnn mixes channels with a (C/2, features) matrix: it "
                f"needs n_channels ({features}) == hidden_features / 2 "
                f"({hidden_features} / 2)")
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.k, self.C = kernel_size, hidden_features
        self.local_conv_in, self.local_conv_out = _convs(
            features, hidden_features, kernel_size, kw)
        self.norm = _ChannelNorm(normalization, hidden_features // 2,
                                 dtype=dtype, device=device)
        self.global_transform = Linear(grid * grid + kernel_size ** 2,
                                       features, **kw)

    def forward(self, x: torch.Tensor, cls: torch.Tensor, *,
                deterministic: bool = True):
        B, p, k, C = x.shape[0], x.shape[1], self.k, self.C
        x = F.gelu(self.local_conv_in(x))
        cls = F.gelu(self.local_conv_in(cls))
        xf = x.reshape(B, p * p, C).transpose(1, 2)
        clsf = cls.reshape(B, k * k, C).transpose(1, 2)
        z1, z2 = torch.cat([xf, clsf], dim=-1).chunk(2, dim=1)
        z2 = self.norm(z2.transpose(1, 2),
                       deterministic=deterministic).transpose(1, 2)
        mix = self.global_transform(z2)  # (B, C/2, features)
        x_cls = torch.einsum("bij,bjf->bif", mix, z1)
        x = x_cls[..., :p * p].transpose(1, 2).reshape(B, p, p, C // 2)
        cls = x_cls[..., p * p:].transpose(1, 2).reshape(B, k, k, C // 2)
        return self.local_conv_out(x), self.local_conv_out(cls)


class _ConvMLP(nn.Module):
    """The encoder's conv MLP (layers.py:778-795), with the trailing
    GELU."""

    data_axis: Axis | None = None

    def __init__(self, mlp_hidden: int, features: int, kernel_size: int,
                 dropout: float = 0.0, *, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(generator=generator, dtype=dtype, device=device)
        k = (kernel_size, kernel_size)
        self.rate = dropout
        self.c1 = Conv(features, mlp_hidden, k, **kw)
        self.c2 = Conv(mlp_hidden, features, k, **kw)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        rows = ((0, self.data_axis),)
        x = dropout(F.gelu(self.c1(x)), self.rate, deterministic, generator,
                    rows)
        return dropout(F.gelu(self.c2(x)), self.rate, deterministic,
                       generator, rows)


class LocalGlobalConvolutionEncoder(nn.Module):
    """layers.py:723-810: norm -> local-global convolution -> residual,
    then norm -> conv MLP -> residual, each module shared by x and cls."""

    def __init__(self, features: int, hidden_features: int, grid: int,
                 kernel_size: int, mlp_hidden: int,
                 weight_gated: bool = False, dropout: float = 0.0,
                 normalization: str = "layer_norm", use_mlp: bool = True, *,
                 generator: torch.Generator,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(generator=generator, dtype=dtype, device=device)
        norm = dict(dtype=dtype, device=device)
        self.la1 = _ChannelNorm(normalization, features, **norm)
        mixer = (WeightLocalGlobalConvolution if weight_gated
                 else LocalGlobalConvolution)
        self.attention = mixer(features, hidden_features, grid, kernel_size,
                               normalization, **kw)
        self.use_mlp = use_mlp
        if use_mlp:
            self.la2 = _ChannelNorm(normalization, features, **norm)
            self.mlp = _ConvMLP(mlp_hidden, features, kernel_size, dropout,
                                **kw)

    def forward(self, x: torch.Tensor, cls: torch.Tensor, *,
                deterministic: bool = True,
                generator: torch.Generator | None = None):
        det = dict(deterministic=deterministic)
        hx, hcls = self.attention(self.la1(x, **det), self.la1(cls, **det),
                                  **det)
        x, cls = x + hx, cls + hcls
        if self.use_mlp:
            kw = dict(deterministic=deterministic, generator=generator)
            x = self.mlp(self.la2(x, **det), **kw) + x
            cls = self.mlp(self.la2(cls, **det), **kw) + cls
        return x, cls


class LocalGlobalCNN(nn.Module):
    """cnn.py:32-109; ``forward(x, *, deterministic, generator)`` as
    ``ViT``'s."""

    def __init__(self, weight_gated: bool = False, num_layers: int = 1,
                 num_classes: int = 10, n_channels: int = 384,
                 hidden_features: int = 768, img_size: int = 32,
                 patch: int = 8, kernel_size: int = 1,
                 use_cls_token: bool = True, mlp_hidden: int = 384,
                 dropout: float = 0.0, normalization: str = "layer_norm",
                 use_mlp: bool = True, in_c: int = 3, *,
                 generator: torch.Generator,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if not use_cls_token:
            raise NotImplementedError(
                "LocalGlobalCNN does not support not using cls token")
        if hidden_features % 2:
            raise ValueError(f"hidden_features={hidden_features} is odd")
        ps = img_size // patch
        if ps * patch != img_size:
            raise ValueError(f"img_size {img_size} is not a multiple of "
                             f"patch {patch}")
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.dtype, self.num_layers = dtype, num_layers
        self.emb = Conv(in_c, n_channels, (ps, ps), strides=(ps, ps),
                        padding="VALID", **kw)
        k = kernel_size
        self.cls_token = nn.Parameter(normal((k, k, n_channels),
                                             generator).to(device))
        for i in range(num_layers):
            self.add_module(f"enc{i}", LocalGlobalConvolutionEncoder(
                n_channels, hidden_features, patch, k, mlp_hidden,
                weight_gated, dropout, normalization, use_mlp, **kw))
        self.fc_norm = LayerNorm(k * k * n_channels, dtype=dtype,
                                 device=device)
        self.fc = Linear(k * k * n_channels, num_classes, **kw)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = self.emb(x.to(self.dtype))  # (B, patch, patch, C)
        cls = self.cls_token.to(self.dtype).expand(x.shape[0], -1, -1, -1)
        for i in range(self.num_layers):
            x, cls = getattr(self, f"enc{i}")(
                x, cls, deterministic=deterministic, generator=generator)
        return self.fc(self.fc_norm(cls.reshape(cls.shape[0], -1)))


class BaselineCNN(nn.Module):
    """The working equivalent of cnn.py:6-29 with the factory's layers
    (utils.py:323-328): CNN([in_c, 32]) then ANN([flat, 1024,
    num_classes]), the flattened size computed from the image size."""

    FEATURES, HIDDEN = 32, 1024

    def __init__(self, num_classes: int = 10, img_size: int = 32,
                 in_c: int = 3, *, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.dtype = dtype
        self.conv = CNN((in_c, self.FEATURES), **kw)
        h, w = self.conv.output_shape(img_size, img_size)
        self.ann = ANN((h * w * self.FEATURES, self.HIDDEN, num_classes),
                       **kw)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = self.conv(x.to(self.dtype), deterministic=deterministic)
        return self.ann(x.reshape(x.shape[0], -1))
