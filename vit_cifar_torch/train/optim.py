"""Optimizers and the learning-rate schedule, as
``vit_cifar_tpu/train/optim.py``.

Schedule: the reference's per-epoch warmup -> cosine, evaluated from the
count of applied updates, with its three quirks kept (see the JAX module's
docstring): warmup is linear from 0 and reaches the base lr at epoch
``warmup_epoch``; epochs ``warmup_epoch`` and ``warmup_epoch + 1`` both run
at the base lr; the cosine's T_max is ``max_epochs``, so the lr never quite
reaches ``min_lr``.  With ``warmup_epoch=0`` it runs pure cosine from epoch 0.
Computed in f32 on the count's device, as the JAX schedule is.

Optimizers run on ONE flat f32 vector of all parameters, the counterpart of
the JAX package's ``flatten_transform``: :func:`flatten_params` makes every
parameter of a model a view of that vector, so an update is a handful of
elementwise kernels over 6.3M values instead of a few per parameter tensor.
``make_optimizer`` returns optax's shape, ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``, pure functions of
tensors, so that the train step's non-finite guard can keep the old state
with a ``torch.where`` and no host read:

* ``adam``: ``add_decayed_weights`` -> ``scale_by_adam(eps=1e-8)`` -> lr,
  i.e. torch's ``Adam(weight_decay=...)``: L2 added to the gradient before
  the moments, not AdamW.
* ``sgd``: ``add_decayed_weights`` -> ``trace(decay=beta1)`` -> lr.
* ``madam``: the entries of parameters whose name, in lower case, holds
  ``nnmf`` or ``_weights`` (the reference's NNMF group, network.py:90-96)
  take Madam (``ops/nnmf/optimizer.py``) under the ``lr_nnmf`` schedule;
  the others take the Adam chain under ``lr``.  One count serves both, as
  JAX's guard rolls its two counts back together, and one pair of moment
  vectors holds each entry's own.

The schedule's count lives in the optimizer state, as in optax, so a step
that the guard skips rolls it back with the moments: the lr follows the
count of applied updates, not the step counter.

``frozen_mask`` is the JAX package's ``main_optimizer_frozen_fn`` on the
flat vector: torch's optimizers skip a parameter whose ``.grad`` is None.
Under ``ae`` + ``ce`` the AE and (except heads without ``--chunk``)
``norm1`` have no gradient path, and an ``nnmf_weights`` whose layer is not
trainable gets ``grad_weights = None`` from the reference's backward
(NNMFLinear.py:377-381), under every criterion.  Their gradients are zeros
here; the train step also zeroes their entries of the parameters it hands
the optimizer (the decay term, and Madam's multiplicative factor), so that
their update is exactly zero and their moments stay zero.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
from torch import nn

from ..config import Config
from ..ops.nnmf.layers import nnmf_weight_trainable
from ..ops.nnmf.optimizer import madam


def warmup_cosine_epoch_schedule(base_lr: float, min_lr: float,
                                 warmup_epoch: int, max_epochs: int,
                                 steps_per_epoch: int):
    """Per-epoch warmup -> cosine: ``schedule(count) -> lr``, with
    ``count`` an integer tensor; the lr is an f32 tensor on its device."""

    def schedule(count: torch.Tensor) -> torch.Tensor:
        epoch = torch.div(count, steps_per_epoch, rounding_mode="floor")
        warm = base_lr * epoch.to(torch.float32) / max(warmup_epoch, 1)
        # the reference holds base lr for epochs W and W+1 before stepping
        # the cosine; with W=0 it runs pure cosine from 0
        delay = 1 if warmup_epoch > 0 else 0
        cos_epoch = torch.clamp(epoch - warmup_epoch - delay, min=0)
        cos = min_lr + (base_lr - min_lr) * 0.5 * (
            1.0 + torch.cos(math.pi * cos_epoch.to(torch.float32) / max_epochs))
        return torch.where(epoch < warmup_epoch, warm, cos)

    return schedule


class FlatOptimizer(NamedTuple):
    """optax's ``GradientTransformation`` over one flat vector."""

    init: Callable[[torch.Tensor], dict]
    update: Callable[..., tuple]


def flatten_params(model: nn.Module) -> torch.Tensor:
    """Copy ``model``'s parameters into one flat f32 vector, in
    ``parameters()`` order, and make each parameter a view of it.  Writing
    the vector in place then writes the model's weights."""
    params = list(model.parameters())
    if any(p.dtype != torch.float32 for p in params):
        raise ValueError("flatten_params takes f32 parameters")
    flat = torch.cat([p.detach().reshape(-1) for p in params])
    offset = 0
    for p in params:
        n = p.numel()
        p.data = flat[offset:offset + n].view_as(p)
        offset += n
    return flat


def frozen_mask(cfg: Config, model: nn.Module) -> torch.Tensor | None:
    """A bool vector over the flat parameters, True where the main
    optimizer must leave an entry alone (see the module docstring); None
    where it leaves none alone."""
    frozen = ()
    if cfg.model_name == "ae" and cfg.criterion != "aece":
        norm1_has_path = (cfg.ae_type == "heads" and not cfg.legacy_heads
                          and not cfg.chunk)
        frozen = ("AE",) if norm1_has_path else ("AE", "norm1")

    def is_frozen(name: str) -> bool:
        parts = name.split(".")
        if parts[-1] == "nnmf_weights" and not nnmf_weight_trainable(
                parts, cfg.train_md_bases):
            return True
        return any(a == "mixer" and b in frozen
                   for a, b in zip(parts, parts[1:]))

    mask = flat_mask(model, is_frozen)
    return mask if bool(mask.any()) else None


def flat_mask(model: nn.Module, select: Callable[[str], bool]) -> torch.Tensor:
    """A bool vector over ``model``'s flat parameters (``flatten_params``
    order), True at the entries of the parameters whose name ``select``
    takes."""
    return torch.cat([
        torch.full((p.numel(),), select(n), dtype=torch.bool,
                   device=p.device) for n, p in model.named_parameters()])


def adam(schedule, b1: float, b2: float, eps: float, weight_decay: float):
    def init(params):
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=params.device),
                "mu": torch.zeros_like(params), "nu": torch.zeros_like(params)}

    def update(grads, state, params):
        g = grads + weight_decay * params
        mu = (1.0 - b1) * g + b1 * state["mu"]
        nu = (1.0 - b2) * (g * g) + b2 * state["nu"]
        count = state["count"] + 1
        t = count.to(torch.float32)
        mu_hat = mu / (1.0 - b1 ** t)
        nu_hat = nu / (1.0 - b2 ** t)
        step = -schedule(state["count"])
        updates = mu_hat / (torch.sqrt(nu_hat) + eps) * step
        return updates, {"count": count, "mu": mu, "nu": nu}

    return FlatOptimizer(init, update)


def _sgd(schedule, momentum: float, weight_decay: float):
    def init(params):
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=params.device),
                "trace": torch.zeros_like(params)}

    def update(grads, state, params):
        trace = grads + weight_decay * params + momentum * state["trace"]
        step = -schedule(state["count"])
        return trace * step, {"count": state["count"] + 1, "trace": trace}

    return FlatOptimizer(init, update)


def is_nnmf_group(name: str) -> bool:
    """The reference's NNMF parameter group (network.py:90-96): a name
    holding ``nnmf`` or ``_weights`` in lower case."""
    name = name.lower()
    return "nnmf" in name or "_weights" in name


def _routed(mask: torch.Tensor, first: FlatOptimizer,
            second: FlatOptimizer) -> FlatOptimizer:
    """``second`` on the entries where ``mask`` is True, ``first`` on the
    rest; their states share one count and one vector of each moment."""

    def update(grads, state, params):
        u1, s1 = first.update(grads, state, params)
        u2, s2 = second.update(grads, state, params)
        return torch.where(mask, u2, u1), {
            k: s1[k] if k == "count" else torch.where(mask, s2[k], s1[k])
            for k in s1}

    return FlatOptimizer(first.init, update)


def make_optimizer(cfg: Config, steps_per_epoch: int,
                   model: nn.Module | None = None) -> FlatOptimizer:
    """The optimizer of ``cfg``; ``madam`` routes by parameter name, so it
    needs the ``model`` whose flat parameters it updates."""
    schedule = warmup_cosine_epoch_schedule(
        cfg.lr, cfg.min_lr, cfg.warmup_epoch, cfg.max_epochs, steps_per_epoch)
    if cfg.optimizer == "adam":
        return adam(schedule, cfg.beta1, cfg.beta2, 1e-8, cfg.weight_decay)
    if cfg.optimizer == "sgd":
        return _sgd(schedule, cfg.beta1, cfg.weight_decay)
    if cfg.optimizer == "madam":
        if model is None:
            raise ValueError("madam routes by parameter name: pass the model")
        nnmf_schedule = warmup_cosine_epoch_schedule(
            cfg.lr_nnmf, cfg.min_lr, cfg.warmup_epoch, cfg.max_epochs,
            steps_per_epoch)
        return _routed(
            flat_mask(model, is_nnmf_group),
            adam(schedule, cfg.beta1, cfg.beta2, 1e-8, cfg.weight_decay),
            madam(nnmf_schedule, cfg.beta1, cfg.beta2, 1e-8,
                  cfg.weight_decay))
    raise NotImplementedError(f"Unknown optimizer: {cfg.optimizer}")
