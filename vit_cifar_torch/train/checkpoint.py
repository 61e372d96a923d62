"""Checkpoint save/restore, the port's own layout.

A checkpoint directory holds ``config.json`` (``Config.to_json``, readable by
both packages) and ``state.pt``, a ``torch.save`` of the payload dict (at
least ``{"params": state_dict}``), read back with ``weights_only=True``.  A
directory kept by :class:`BestCheckpointer` (the training loop's) holds
``best/state.pt`` and ``last/state.pt`` instead, picked by ``prefer`` as in
the JAX package, and ``best.json`` with the best val_loss.  The loop's
payload is the full training state (``train/loop.py::_full_payload``), so a
run resumes where it stopped.
"""

from __future__ import annotations

import json
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


class BestCheckpointer:
    """The best checkpoint by val_loss (Lightning's ``save_top_k=1``,
    ``monitor="val_loss"``, ``mode="min"``) and a last one, under
    ``{ckpt_dir}/{experiment}``.  With ``write=False`` (the ranks other
    than 0 of a multi-process run) it follows the best val_loss and writes
    nothing."""

    def __init__(self, ckpt_dir: str, experiment: str, cfg: Config,
                 write: bool = True):
        self.root = _abspath(os.path.join(ckpt_dir, experiment))
        self.write = write
        self.best_val_loss = float("inf")
        if write:
            os.makedirs(self.root, exist_ok=True)
            with open(os.path.join(self.root, "config.json"), "w") as f:
                f.write(cfg.to_json())

    def _save(self, name: str, payload: dict[str, Any]) -> None:
        if not self.write:
            return
        path = os.path.join(self.root, name)
        os.makedirs(path, exist_ok=True)
        torch.save(_to_cpu(payload), os.path.join(path, _STATE))

    def seed_best_from(self, resume_dir: str) -> None:
        """Take the best val_loss so far from a run's ``best.json``, as
        Lightning restores ``best_model_score`` on resume, so that the first
        epoch after it cannot replace ``best`` with a worse model."""
        for root in (_abspath(resume_dir), self.root):
            best_json = os.path.join(root, "best.json")
            if os.path.exists(best_json):
                with open(best_json) as f:
                    self.best_val_loss = float(json.load(f)["val_loss"])
                return

    def maybe_save_best(self, val_loss: float, epoch: int,
                        payload: dict[str, Any]) -> bool:
        if val_loss < self.best_val_loss:
            self.best_val_loss = float(val_loss)
            self._save("best", payload)
            if self.write:
                with open(os.path.join(self.root, "best.json"), "w") as f:
                    json.dump({"val_loss": self.best_val_loss,
                               "epoch": epoch}, f)
            return True
        return False

    def save_last(self, payload: dict[str, Any]) -> None:
        self._save("last", payload)


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
