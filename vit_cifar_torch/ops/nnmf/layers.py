"""NNMF layers, as ``vit_cifar_tpu/ops/nnmf/layers.py``.

Reference: nnmf/NNMFLayerSbSBP.py:8-309 (NNMFConv2d),
nnmf/AutoNNMFLayer.py:5-331 (AutoNNMFLayer), nnmf/NNMFLinear.py
(NNMFLinear), nnmf/NNMFLayerSbSBP.py:523-551 (NNMFEncoderDecoder).

  * Every NNMF weight is a parameter named ``nnmf_weights``, stored (C, M)
    and column-stochastic over C (the torch NNMFLinear stores the (M, C)
    transpose; the math is the same).  The name is the routing key of
    Madam's parameter group and of the after-care.
  * The input is L1-normalized over the patch axis before the iterate.
  * The NNMF math runs in f32 whatever the compute dtype (the iterate's
    ratios are precision-sensitive): the input is cast to f32 at the
    layer's entry and the output to the compute dtype at its exit.
  * The reference's stateful counters are gone: the contribution count is
    folded into the backward (``functional.py``), and ``_last_grad_scale``
    is dead state in the reference, so its ``keep_last_grad_scale`` switch
    has no counterpart here.

``nnmf_after_care`` is the post-step weight care (network.py:380-386):
column-normalize, clamp at ``threshold / divisor``, normalize again, on
each trainable ``nnmf_weights`` view of a flat parameter vector, in place.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ...parallel.collectives import Axis
from ..init import uniform_range
from .functional import conv_output_size, fold, make_nnmf_op, unfold


def column_stochastic_uniform(shape, lo: float, hi: float,
                              generator: torch.Generator) -> torch.Tensor:
    """uniform(lo, hi), then each column normalized to sum 1
    (NNMFLayerSbSBP.py:139-155)."""
    w = uniform_range(shape, lo, hi, generator)
    return w / w.sum(dim=0, keepdim=True)


class NNMFConv2d(nn.Module):
    """The column-stochastic NNMF conv layer: (B, C_in, H, W) NCHW ->
    (B, M, H', W'), with h clamped to +-10 (NNMFLayerSbSBP.py:361)."""

    data_axis: Axis | None = None

    def __init__(self, number_of_input_neurons: int, number_of_neurons: int,
                 input_size, forward_kernel_size, number_of_iterations: int,
                 epsilon_0: float = 1.0, weight_noise_range=(0.0, 1.0),
                 strides=(1, 1), padding=(0, 0), w_trainable: bool = False,
                 local_learning: bool = False, output_layer: bool = False,
                 disable_scale_grade: bool = True, *,
                 generator: torch.Generator,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.number_of_input_neurons = number_of_input_neurons
        self.number_of_neurons = number_of_neurons
        self.input_size = tuple(input_size)
        self.forward_kernel_size = tuple(forward_kernel_size)
        self.strides, self.padding = tuple(strides), tuple(padding)
        self.dtype = dtype
        kh, kw = self.forward_kernel_size
        self.nnmf_weights = nn.Parameter(column_stochastic_uniform(
            (kh * kw * number_of_input_neurons, number_of_neurons),
            *weight_noise_range, generator).to(device))
        self._op_kw = dict(
            iterations=number_of_iterations, eps0=epsilon_0,
            local_learning=local_learning, output_layer=output_layer,
            w_trainable=w_trainable, scale_grad=not disable_scale_grade)
        self.hidden_activity: torch.Tensor | None = None

    def _iterate(self, x: torch.Tensor, *, eps: float, clamp_grad: bool):
        """unfold -> normalize -> the NNMF Function; returns (h, (H', W'))."""
        if x.shape[1] != self.number_of_input_neurons or \
                tuple(x.shape[2:]) != self.input_size:
            raise ValueError(f"NNMF layer built for (B, "
                             f"{self.number_of_input_neurons}, "
                             f"{self.input_size}) got {tuple(x.shape)}")
        B = x.shape[0]
        patches = unfold(x.to(torch.float32), self.forward_kernel_size,
                         self.strides, self.padding)
        _, C, Hp, Wp = patches.shape
        inp = patches.reshape(B, C, Hp * Wp)
        inp = inp / (inp.sum(dim=1, keepdim=True) + 1e-20)
        op = make_nnmf_op(eps=eps, clamp_grad=clamp_grad, **self._op_kw)
        return op(inp, self.nnmf_weights, self.data_axis), (Hp, Wp)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        h, (Hp, Wp) = self._iterate(x, eps=1e-20, clamp_grad=True)
        h = torch.clamp(h, -10.0, 10.0)
        return h.reshape(x.shape[0], self.number_of_neurons, Hp,
                         Wp).to(self.dtype)


class AutoNNMFLayer(NNMFConv2d):
    """The NNMF autoencoder layer (AutoNNMFLayer.py:5-331): encode with the
    NNMF Function (eps 1e-5, no clamps), keep the code as
    ``hidden_activity`` (detached, (B, M, H', W')), decode with the
    detached weights and fold back to the input size."""

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        h, hw = self._iterate(x, eps=1e-5, clamp_grad=False)
        B = x.shape[0]
        self.hidden_activity = h.detach().reshape(
            B, self.number_of_neurons, *hw)
        decoded = torch.einsum("cm,bmp->bcp", self.nnmf_weights.detach(), h)
        return self._decode_fold(decoded, B, hw).to(self.dtype)

    def _decode_fold(self, decoded: torch.Tensor, B: int, hw) -> torch.Tensor:
        """``F.fold`` of the decoded patches (AutoNNMFLayer.py:315-329).
        A kernel the size of the input (one patch) and an (H, 1) column
        kernel over one channel at stride 1 are reshapes; the general,
        overlapping case folds."""
        kh, kw = self.forward_kernel_size
        H, W = self.input_size
        if (kh, kw) == (H, W):
            return decoded.reshape(B, self.number_of_input_neurons, H, W)
        if (kh, kw) == (H, 1) and self.number_of_input_neurons == 1 and \
                self.strides == (1, 1):
            return decoded.reshape(B, 1, H, W)
        return fold(decoded.reshape(B, -1, *hw), self.input_size,
                    self.forward_kernel_size, self.strides, self.padding)


class NNMFEncoderDecoder(NNMFConv2d):
    """NNMFLayerSbSBP.py:523-551: the encoder with the SbS clamps and a
    decoder on the detached weights."""

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        h, hw = self._iterate(x, eps=1e-20, clamp_grad=True)
        h = torch.clamp(h, -10.0, 10.0)
        B = x.shape[0]
        wd = self.nnmf_weights.detach()
        if self.forward_kernel_size == self.input_size:
            decoded = torch.einsum("bmp,cm->bcp", h, wd)
            out = decoded.reshape(B, self.number_of_input_neurons,
                                  *self.input_size)
        else:
            decoded = torch.einsum("cm,bmp->bcp", wd, h)
            out = fold(decoded.reshape(B, -1, *hw), self.input_size,
                       self.forward_kernel_size, self.strides, self.padding)
        return out.to(self.dtype)


class NNMFLinear(nn.Module):
    """The NNMF layer over 2-D inputs (nnmf/NNMFLinear.py): (B, C) ->
    (B, M), with no clamps."""

    data_axis: Axis | None = None

    def __init__(self, number_of_input_neurons: int, number_of_neurons: int,
                 number_of_iterations: int, epsilon_0: float = 1.0,
                 weight_noise_range=(0.0, 1.0), w_trainable: bool = False,
                 local_learning: bool = False, output_layer: bool = False,
                 disable_scale_grade: bool = True, *,
                 generator: torch.Generator,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.number_of_input_neurons = number_of_input_neurons
        self.dtype = dtype
        self.nnmf_weights = nn.Parameter(column_stochastic_uniform(
            (number_of_input_neurons, number_of_neurons),
            *weight_noise_range, generator).to(device))
        self._op = make_nnmf_op(
            iterations=number_of_iterations, eps0=epsilon_0, eps=1e-20,
            local_learning=local_learning, output_layer=output_layer,
            w_trainable=w_trainable, scale_grad=not disable_scale_grade,
            clamp_grad=False)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if x.dim() != 2 or x.shape[1] != self.number_of_input_neurons:
            raise ValueError(f"NNMFLinear built for (B, "
                             f"{self.number_of_input_neurons}) got "
                             f"{tuple(x.shape)}")
        x = x.to(torch.float32)
        inp = x / (x.sum(dim=1, keepdim=True) + 1e-20)
        return self._op(inp[:, :, None], self.nnmf_weights,
                        self.data_axis)[:, :, 0].to(
            self.dtype)


def nnmf_weight_trainable(names: list[str], train_md_bases: bool) -> bool:
    """The effective ``w_trainable`` of the ``nnmf_weights`` at ``names``
    (a parameter's name split at the dots).  The heads AE's layer, whose
    weight sits right under ``AE``, is built trainable whatever the flags
    (reference layers.py:941); every other NNMF layer follows
    ``--train-md-bases`` (network.py:23)."""
    if "AE" in names and names[names.index("AE") + 1:] == ["nnmf_weights"]:
        return True
    return train_md_bases


def _after_care_divisor(names: list[str], shape) -> int:
    """The reference clamps at ``threshold / number_of_input_neurons``
    (network.py:381-386): 1 for every conv-style layer of the zoo, and the
    input width (the weight's first axis) for an NNMFLinear, which only the
    AE's DenseBlocks build, under the module name ``nnmf``."""
    if len(names) >= 2 and names[-2] == "nnmf":
        return shape[0]
    return 1


def nnmf_slices(model: nn.Module,
                select: Callable[[str], bool] = lambda name: True,
                trainable: Callable[[list[str]], bool] | None = None
                ) -> list[tuple[int, tuple, int]]:
    """(offset, shape, divisor) of each ``nnmf_weights`` in the flat vector
    of the parameters that ``select`` takes (``flatten_params`` order,
    packed), those that ``trainable(names)`` accepts where it is given."""
    out, offset = [], 0
    for name, p in model.named_parameters():
        if not select(name):
            continue
        names = name.split(".")
        if names[-1] == "nnmf_weights" and (trainable is None
                                            or trainable(names)):
            out.append((offset, tuple(p.shape),
                        _after_care_divisor(names, p.shape)))
        offset += p.numel()
    return out


@torch.no_grad()
def nnmf_after_care(flat: torch.Tensor, slices, threshold: float) -> None:
    """Norm -> clamp at ``threshold / divisor`` -> norm, over each column
    of the ``nnmf_weights`` at ``slices`` (``nnmf_slices``) of ``flat``,
    in place (network.py:380-386, NNMFLayerSbSBP.py:181-213)."""
    for offset, shape, divisor in slices:
        n = shape[0] * shape[1]
        view = flat[offset:offset + n].view(shape)
        p = view / view.sum(dim=0, keepdim=True)
        p = torch.clamp(p, min=threshold / divisor)
        view.copy_(p / p.sum(dim=0, keepdim=True))
