"""Training state, as ``vit_cifar_tpu/train/state.py``.

The JAX package's state is an immutable pytree that the jitted step
replaces; here the train step updates it in place (the flat parameter
vector, which the model's parameters view, is written with ``copy_``) and
returns it, so that memory holds one copy of the weights.  The model's
buffers (the persistent bases of ``--train-md-bases``) are the counterpart
of JAX's ``model_state``: they live in ``model``, which the forward updates
in place, and travel in the checkpoint's ``model_state``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn


@dataclass
class TrainState:
    step: int  # global step, counted on the host
    model: nn.Module  # its parameters are views of ``params``
    params: torch.Tensor  # flat f32 master weights (optim.flatten_params)
    opt_state: dict[str, torch.Tensor]  # the optimizer's, count included
    generator: torch.Generator  # every random draw of the step, on device
    # the AE-internal optimizer's (train/unsupervised.py), or None
    ae_opt_state: dict[str, torch.Tensor] | None = None
    # running per-epoch metric sums, accumulated on the device inside the
    # step; None when the caller does not want accumulation
    metrics_acc: dict[str, torch.Tensor] | None = None
