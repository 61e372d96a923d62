"""Checkpoint save/restore, the port's own layout.

A checkpoint directory holds ``config.json`` (``Config.to_json``, readable by
both packages) and ``state.pt``, a ``torch.save`` of the payload dict (at
least ``{"params": state_dict}``), read back with ``weights_only=True``.  A
directory kept by a best/last checkpointer holds ``best/state.pt`` and
``last/state.pt`` instead, picked by ``prefer`` as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from ..config import Config

_STATE = "state.pt"


def _abspath(p: str) -> str:
    return os.path.abspath(os.path.expanduser(p))


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def save_checkpoint(path: str, payload: dict[str, Any], cfg: Config) -> None:
    path = _abspath(path)
    os.makedirs(path, exist_ok=True)
    torch.save(_to_cpu(payload), os.path.join(path, _STATE))
    with open(os.path.join(path, "config.json"), "w") as f:
        f.write(cfg.to_json())


def load_checkpoint(path: str, prefer: str = "best",
                    map_location="cpu") -> tuple[dict[str, Any], Config]:
    """Restore ``(payload, cfg)``; ``prefer`` picks ``best`` or ``last``
    where the directory holds both."""
    path = _abspath(path)
    with open(os.path.join(path, "config.json")) as f:
        cfg = Config.from_json(f.read())
    state = os.path.join(path, _STATE)
    if not os.path.exists(state):
        order = ("best", "last") if prefer == "best" else ("last", "best")
        for name in order:
            cand = os.path.join(path, name, _STATE)
            if os.path.exists(cand):
                state = cand
                break
    payload = torch.load(state, map_location=map_location, weights_only=True)
    return payload, cfg
