"""The GatedNNMF mixer, as ``vit_cifar_tpu/ops/gated_nnmf.py``: a
gMLP-shaped gate whose token mixing is NNMF.

Reference: layers.py:349-458.  Lift with U + GELU, chunk into (z1, z2),
``z2 = relu(LayerNorm(z2))`` (NNMF inputs must be non-negative), denoise
z2 with one of three backends, gate ``z1 * z2``, project back with V:

  * ``ham``: ``MatrixDecomposition2D`` (NMF) with ``--md-iter`` steps in
    training and eval and ``rand_init = not --train-md-bases``
    (layers.py:371-380), over (B, ffn/2, 1, T): tokens are the channels;
  * ``sbs``: ``NNMFConv2d`` with one input channel, T neurons and a (T, 1)
    kernel over the (T, ffn/2) image, with the max-normalized gradient
    (layers.py:383-400);
  * ``sbsed``: ``AutoNNMFLayer`` with a (T, ffn/2) kernel and 128 neurons
    (layers.py:424-441).

Depthwise ``sbs`` and ``sbsed`` raise, as the reference does
(layers.py:387-388, 427-428).

Under a model axis U is column-parallel with the matching slices of both
halves on each rank, and V row-parallel, as in ``ops/gmlp.py``; z2 is
gathered for the norm and the NNMF, which run whole on every rank, and
each rank gates its own columns.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import Axis, copy_to, gather_from, scatter_to
from .common import LayerNorm
from .hamburger import MatrixDecomposition2D
from .init import Linear
from .nnmf.layers import AutoNNMFLayer, NNMFConv2d


class GatedNNMF(nn.Module):
    TP_LAYOUT = {"U": "col_halves", "V": "row"}
    tp_axis: Axis | None = None

    def __init__(self, features: int, ffn_features: int, seq_len: int,
                 nnmf_type: str = "ham", md_iter: int = 7,
                 depthwise: bool = False, train_bases: bool = False,
                 local_learning: bool = False, *,
                 generator: torch.Generator,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if ffn_features % 2:
            raise ValueError(f"ffn_features={ffn_features} is odd")
        if nnmf_type in ("sbs", "sbsed") and depthwise:
            raise NotImplementedError(
                f"depthwise is not implemented for the {nnmf_type} NNMF "
                f"backend")
        self.nnmf_type, self.dtype = nnmf_type, dtype
        half = ffn_features // 2
        lin = dict(generator=generator, dtype=dtype, device=device)
        self.U = Linear(features, ffn_features, **lin)
        self.norm = LayerNorm(half, dtype=dtype, device=device)
        layer = dict(number_of_input_neurons=1, input_size=(seq_len, half),
                     number_of_iterations=md_iter, w_trainable=train_bases,
                     local_learning=local_learning, disable_scale_grade=False,
                     **lin)
        if nnmf_type == "ham":
            # the (B, ffn/2, 1, T) input gives D = T, or ffn/2 depthwise
            self.NNMF = MatrixDecomposition2D(
                half if depthwise else seq_len, "NMF", spatial=not depthwise,
                train_steps=md_iter, eval_steps=md_iter,
                rand_init=not train_bases, generator=generator,
                device=device)
        elif nnmf_type == "sbs":
            self.NNMF = NNMFConv2d(number_of_neurons=seq_len,
                                   forward_kernel_size=(seq_len, 1), **layer)
        elif nnmf_type == "sbsed":
            self.NNMF = AutoNNMFLayer(number_of_neurons=128,
                                      forward_kernel_size=(seq_len, half),
                                      **layer)
        else:
            raise NotImplementedError(
                f"NNMF type {nnmf_type} not implemented")
        self.V = Linear(half, features, **lin)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        tp = self.tp_axis
        z1, z2 = F.gelu(self.U(x if tp is None else copy_to(x, tp))).chunk(
            2, dim=-1)
        if tp is not None:
            z2 = gather_from(z2, tp)
        z2 = F.relu(self.norm(z2))
        kw = dict(deterministic=deterministic, generator=generator)
        if self.nnmf_type == "ham":
            out = self.NNMF(z2.transpose(1, 2)[:, :, None, :], **kw)
            z2 = out[:, :, 0, :].transpose(1, 2)
        elif self.nnmf_type == "sbs":
            z2 = self.NNMF(z2[:, None], **kw).squeeze(-2)
        else:
            z2 = self.NNMF(z2[:, None], **kw).squeeze(1)
        if tp is not None:
            z2 = scatter_to(z2, tp)
        return self.V(z1 * z2, reduce_over=tp)
