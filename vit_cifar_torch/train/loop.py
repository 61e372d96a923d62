"""Pieces of the training harness, as ``vit_cifar_tpu/train/loop.py``:
``init_state`` and the eval padding.  The epoch loop, logging, best/last
checkpoints and resume come with the AutoAugment slice (ROADMAP queue 1,
items 4-5).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from .optim import FlatOptimizer, flatten_params
from .state import TrainState


def init_state(cfg: Config, model: torch.nn.Module,
               tx: FlatOptimizer) -> TrainState:
    """The state of a fresh run: ``model``'s parameters become views of one
    flat f32 vector on their device, the optimizer state starts at zero,
    and every random draw of the steps comes from a generator on that
    device seeded with ``cfg.seed``."""
    params = flatten_params(model)
    gen = torch.Generator(device=params.device).manual_seed(cfg.seed)
    return TrainState(step=0, model=model, params=params,
                      opt_state=tx.init(params), generator=gen)


def _pad_eval(x: np.ndarray, y: np.ndarray, batch: int):
    """Pad eval data to a whole number of batches; returns (x, y, mask,
    steps)."""
    n = len(x)
    steps = -(-n // batch)
    pad = steps * batch - n
    mask = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    if pad:
        x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
        y = np.concatenate([y, np.zeros((pad,), y.dtype)])
    return x, y, mask, steps
