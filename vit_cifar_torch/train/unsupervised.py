"""The AE-internal optimizer loop (the unsupervised updates), as
``vit_cifar_tpu/train/unsupervised.py``.

Reference: each AEAttention owns a private ``AE_optimizer`` (Adam,
lr=1e-3) made at construction (layers.py:844, 963-975);
``--unsupervised-steps N`` runs N of its steps per training batch on
``MSE(AE(AE_input), AE_input)`` with the input the forward stored
(network.py:172-178, vit.py:473-486, layers.py:893-907).

Here, as in the JAX package, one Adam runs over the union of the layers'
AE parameters (per-layer Adams over disjoint groups are one Adam over the
union with the losses summed).  Its state is the train state's
``ae_opt_state``: the count and both moments over the AE entries of the
flat parameter vector, in its order.  The loop reads the inputs the AE
mixers kept in the forward (detached, f32) and writes the updated AE
entries into the flat vector in place, before the main update.

Parity details kept:
  * the heads variant SKIPS an update whose loss is nan/inf
    (layers.py:1071-1072): the AE entries, the count and the moments keep
    their values and the step adds 0 to the reported loss;
  * gradients reach only the AE parameters (the inputs are detached);
  * the heads AE built of NNMF layers (``--use-nnmf-layers``) takes Madam
    at lr 1e-3 with no decay (layers.py:963-975), and each inner step ends
    with the after-care at threshold 1e-3 on its ``nnmf_weights``
    (layers.py:1077-1085), before the nan/inf skip.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import Config
from ..ops.nnmf.layers import nnmf_after_care, nnmf_slices
from ..ops.nnmf.optimizer import madam
from ..parallel.collectives import Axis
from .optim import adam, flat_mask
from .state import TrainState

AE_LR = 1e-3


def uses_unsupervised(cfg: Config) -> bool:
    # only the AEViT can learn unsupervised (utils.py:279)
    return cfg.model_name == "ae" and cfg.unsupervised_steps > 0


def is_ae_param(name: str) -> bool:
    """A parameter of a layer's AE subtree (``...mixer.AE...``)."""
    parts = name.split(".")
    return any(a == "mixer" and b == "AE" for a, b in zip(parts, parts[1:]))


def ae_mixers(model: nn.Module) -> list[nn.Module]:
    """The mixers that keep AE tensors, in layer order."""
    return [m for m in model.modules() if hasattr(m, "ae_input")]


def _reconstruction(ae: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """An AE's reconstruction: the first of its outputs, or its only one
    (``AutoNNMFLayer``)."""
    out = ae(x)
    return out[0] if isinstance(out, tuple) else out


def collect_ae_terms(model: nn.Module) -> list[tuple]:
    """The (hidden, input, output) triples of the last forward, one per AE
    mixer, for the ``aece`` criterion."""
    return [(m.ae_hidden, m.ae_input, m.ae_output) for m in ae_mixers(model)]


def make_unsupervised_update(cfg: Config, model: nn.Module,
                             data: Axis | None = None):
    """``(init, run)`` for ``model``, whose parameters view the flat
    vector: ``init(params) -> ae_opt_state``; ``run(state) -> loss`` takes
    ``cfg.unsupervised_steps`` AE steps on the inputs of the model's last
    forward, writes the AE entries of ``state.params`` and
    ``state.ae_opt_state`` in place, and returns the summed loss (a tensor
    on the device; nothing is read back).  Under a ``data`` axis each
    step's gradient and loss are the means over it."""
    heads = cfg.ae_type == "heads" and not cfg.legacy_heads
    heads_nnmf = heads and cfg.use_nnmf_layers
    tx = (madam if heads_nnmf else adam)(lambda count: AE_LR, 0.9, 0.999,
                                         1e-8, 0.0)
    after_care = (nnmf_slices(model, is_ae_param) if heads_nnmf else [])
    ae_params = [p for n, p in model.named_parameters() if is_ae_param(n)]
    if not ae_params:
        raise ValueError("unsupervised AE steps need a model with AEs")
    index = flat_mask(model, is_ae_param).nonzero().squeeze(1)
    mixers = ae_mixers(model)
    aes = [m.AE for m in mixers]

    def init(params: torch.Tensor) -> dict:
        return tx.init(params.index_select(0, index))

    def run(state: TrainState) -> torch.Tensor:
        inputs = [m.ae_input.detach().to(torch.float32) for m in mixers]
        total = torch.zeros((), dtype=torch.float32,
                            device=state.params.device)
        for _ in range(cfg.unsupervised_steps):
            with torch.enable_grad():
                loss = sum(torch.mean((_reconstruction(ae, x) - x) ** 2)
                           for ae, x in zip(aes, inputs))
                grads = torch.autograd.grad(loss, ae_params)
            with torch.no_grad():
                flat = torch.cat([g.reshape(-1) for g in grads]
                                 + [loss.detach()[None]])
                if data is not None:
                    data.all_reduce_(flat).div_(data.size)
                loss = flat[-1]
                old = state.params.index_select(0, index)
                updates, opt_state = tx.update(
                    flat[:-1], state.ae_opt_state, old)
                new = old + updates
                nnmf_after_care(new, after_care, AE_LR)
                if heads:
                    ok = torch.isfinite(loss)
                    new = torch.where(ok, new, old)
                    opt_state = {k: torch.where(ok, v, state.ae_opt_state[k])
                                 for k, v in opt_state.items()}
                    loss = torch.where(ok, loss, torch.zeros_like(loss))
                state.params.index_copy_(0, index, new)
                state.ae_opt_state = opt_state
                total = total + loss
        return total

    return init, run
