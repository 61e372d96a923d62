"""Madam, the NNMF multiplicative optimizer, on one flat vector, as
``vit_cifar_tpu/ops/nnmf/optimizer.py``.

Reference: nnmf/optimizer.py:11-244, the ``madam`` path of param groups
flagged ``nnmf``:

    g <- g + weight_decay * p                      (torch's L2)
    m <- lerp(m, g, 1 - b1);  v <- b2 v + (1 - b2) g^2
    denom = sqrt(v) / sqrt(1 - b2^t) + eps
    p <- p * (0.5 * tanh(-(lr / (1 - b1^t)) * m / denom) + 1)

The factor lies in (0.5, 1.5), so positive weights stay positive.  As in
optax, the update is returned as ``p * (factor - 1)`` for the caller to
add, and the lr is read at the count before the increment (JAX :65).
"""

from __future__ import annotations

import torch


def madam(schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0):
    """A ``FlatOptimizer`` (``train/optim.py``); ``schedule(count) -> lr``."""
    from ...train.optim import FlatOptimizer

    def init(params):
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=params.device),
                "mu": torch.zeros_like(params), "nu": torch.zeros_like(params)}

    def update(grads, state, params):
        count = state["count"] + 1
        g = grads + weight_decay * params if weight_decay else grads
        mu = state["mu"] + (1.0 - b1) * (g - state["mu"])
        nu = b2 * state["nu"] + (1.0 - b2) * g * g
        t = count.to(torch.float32)
        bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        step_size = schedule(state["count"]) / bc1
        denom = torch.sqrt(nu) / torch.sqrt(bc2) + eps
        factor = 0.5 * torch.tanh(-step_size * (mu / denom)) + 1.0
        return params * (factor - 1.0), {"count": count, "mu": mu, "nu": nu}

    return FlatOptimizer(init, update)
