"""The autoencoders of the AE-attention family, as
``vit_cifar_tpu/ops/autoencoders.py`` (reference autoencoders.py).

Each returns ``(reconstruction, hidden)``.  Every building block is a
``DenseBlock``: Linear (``fc``) -> ReLU, or with ``--use-nnmf-layers`` an
``NNMFLinear`` (``nnmf``) and no ReLU.  The reference follows it with a
Dropout whose rate the model zoo always leaves at 0, so the port has none.
The AEs are built in f32 whatever the model's compute dtype, as the JAX
package builds them, so their Linears never cast the weights to bf16.

  * ``Autoencoder``   -- feature-dim MLP AE (autoencoders.py:40-60)
  * ``AutoencoderT``  -- over the sequence dim via a transpose (:63-79)
  * ``AutoencoderH``  -- head-aware, over the (n*h) dim, 3-D and 4-D (:82-125)
  * ``Autoencoder2D`` -- seq and feature enc/dec, orders fsfs/sffs/sfsf
    (:128-194)
  * ``AutoNNMF``      -- ``AutoNNMFLayer`` as a drop-in AE for 3-D and 4-D
    inputs (:197-232)
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .init import Linear
from .nnmf.layers import AutoNNMFLayer, NNMFLinear


class NNMFParams(NamedTuple):
    """The reference's ``_nnmf_params`` dict (network.py:19-33)."""

    number_of_iterations: int = 7
    w_trainable: bool = False
    local_learning: bool = False
    disable_scale_grade: bool = True


def _swap(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


class DenseBlock(nn.Module):
    """``autoencoders.linear()``: Linear -> ReLU, or an ``NNMFLinear`` over
    the last dim with ``nnmf``; in f32."""

    def __init__(self, in_features: int, features: int, nnmf: bool = False,
                 nnmf_params: NNMFParams = NNMFParams(), *,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.features = features
        if nnmf:
            self.nnmf = NNMFLinear(in_features, features,
                                   generator=generator, device=device,
                                   **nnmf_params._asdict())
        else:
            self.fc = Linear(in_features, features, generator=generator,
                             device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "nnmf"):
            out = self.nnmf(x.reshape(-1, x.shape[-1]))
            return out.reshape(*x.shape[:-1], self.features)
        return F.relu(self.fc(x))


class Autoencoder(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, nnmf: bool = False,
                 nnmf_params: NNMFParams = NNMFParams(), *,
                 generator: torch.Generator, device=None):
        super().__init__()
        kw = dict(nnmf=nnmf, nnmf_params=nnmf_params, generator=generator,
                  device=device)
        self.encoder = DenseBlock(input_size, hidden_size, **kw)
        self.decoder = DenseBlock(hidden_size, input_size, **kw)

    def forward(self, x: torch.Tensor):
        h = self.encoder(x)
        return self.decoder(h), h


class AutoencoderT(nn.Module):
    """The AE over the second-to-last (sequence) dim."""

    def __init__(self, seq_len: int, hidden_size: int, nnmf: bool = False,
                 nnmf_params: NNMFParams = NNMFParams(), *,
                 generator: torch.Generator, device=None):
        super().__init__()
        kw = dict(nnmf=nnmf, nnmf_params=nnmf_params, generator=generator,
                  device=device)
        self.encoder = DenseBlock(seq_len, hidden_size, **kw)
        self.decoder = DenseBlock(hidden_size, seq_len, **kw)

    def forward(self, x: torch.Tensor):
        h = self.encoder(_swap(x))
        return _swap(self.decoder(h)), h


class AutoencoderH(nn.Module):
    """The head-aware AE over the (n*h) dim, for 3-D and 4-D inputs."""

    def __init__(self, input_size: int, hidden_size: int, heads: int,
                 nnmf: bool = False, nnmf_params: NNMFParams = NNMFParams(),
                 *, generator: torch.Generator, device=None):
        super().__init__()
        self.heads = heads
        kw = dict(nnmf=nnmf, nnmf_params=nnmf_params, generator=generator,
                  device=device)
        self.encoder = DenseBlock(input_size, hidden_size, **kw)
        self.decoder = DenseBlock(hidden_size, input_size, **kw)

    def forward(self, x: torch.Tensor):
        if x.dim() not in (3, 4):
            raise NotImplementedError(f"AutoencoderH of a {x.dim()}-D input")
        *lead, n, f = x.shape
        # (..., n, f) -> (..., n*h, f/h) -> (..., f/h, n*h)
        y = _swap(x.reshape(*lead, n * self.heads, f // self.heads))
        h = self.encoder(y)
        y = _swap(self.decoder(h))
        return y.reshape(*lead, n, f), h


class Autoencoder2D(nn.Module):
    """Sequence- and feature-dim encoders and decoders, applied in the
    order ``fsfs``, ``sffs`` or ``sfsf``."""

    def __init__(self, order: str, seq: int, features: int, seq_hidden: int,
                 features_hidden: int, nnmf: bool = False,
                 nnmf_params: NNMFParams = NNMFParams(), *,
                 generator: torch.Generator, device=None):
        super().__init__()
        if order not in ("fsfs", "sffs", "sfsf"):
            raise NotImplementedError(order)
        self.order = order
        kw = dict(nnmf=nnmf, nnmf_params=nnmf_params, generator=generator,
                  device=device)
        self.enc_features = DenseBlock(features, features_hidden, **kw)
        self.enc_seq = DenseBlock(seq, seq_hidden, **kw)
        self.dec_features = DenseBlock(features_hidden, features, **kw)
        self.dec_seq = DenseBlock(seq_hidden, seq, **kw)

    def forward(self, x: torch.Tensor):
        enc_f, dec_f = self.enc_features, self.dec_features
        enc_s = lambda a: _swap(self.enc_seq(_swap(a)))  # noqa: E731
        dec_s = lambda a: _swap(self.dec_seq(_swap(a)))  # noqa: E731
        if self.order == "fsfs":
            h = self.enc_seq(_swap(enc_f(x)))
            return dec_s(dec_f(_swap(h))), h
        if self.order == "sffs":
            h = enc_f(enc_s(x))
            return dec_s(dec_f(h)), h
        h = enc_f(enc_s(x))  # sfsf
        return dec_f(dec_s(h)), h


class AutoNNMF(nn.Module):
    """``AutoNNMFLayer`` as a drop-in AE (autoencoders.py:197-232): one
    input channel and an (H, 1) column kernel over the (H, W) input, always
    trainable; 3-D inputs are one image each, 4-D ones (B, T1, T2, F) one
    image per (B, T1).  Returns ``(reconstruction, None)``."""

    def __init__(self, input_size, hidden_size: int,
                 number_of_iterations: int, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.autoencoder = AutoNNMFLayer(
            1, hidden_size, tuple(input_size), (input_size[0], 1),
            number_of_iterations, w_trainable=True, generator=generator,
            device=device)

    def forward(self, x: torch.Tensor):
        if x.dim() == 3:
            return self.autoencoder(x[:, None])[:, 0], None
        if x.dim() == 4:
            B, T1, T2, F_ = x.shape
            out = self.autoencoder(x.reshape(B * T1, 1, T2, F_))
            return out[:, 0].reshape(B, T1, T2, F_), None
        raise NotImplementedError(f"AutoNNMF of a {x.dim()}-D input")
