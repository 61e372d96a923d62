"""Load a trained checkpoint and run one attention-capturing forward pass,
as ``vit_cifar_tpu/analysis/run_model.py``.

Reference: run_model.py -- ``torch.load`` the checkpoint, rebuild the model
from its hyper-parameters, flip ``save_attn_map`` on every module, one
no-grad forward on a test batch (run_model.py:6-62).  A checkpoint
directory of this package is self-describing (``config.json`` + state), so
the model is rebuilt from its config with ``save_attn_map=True``, its
weights and buffers loaded, and a test batch run by the eval path.

Where JAX collects the maps that the modules sow into ``intermediates``,
the port's modules keep them on their ``attn_map`` attribute (the
reference's own); ``intermediates`` here gathers those attributes into
the same nested dict, ``{"enc0": {"mixer": {"attn_map": ...}}, ...}``.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from ..config import torch_dtype
from ..data.augment import normalize
from ..data.datasets import load_dataset
from ..models import get_model
from ..train.checkpoint import load_checkpoint


def intermediates(model: nn.Module) -> dict:
    """The ``attn_map`` that each module kept in its last forward, as a
    nested dict by module path (flax's ``intermediates`` layout)."""
    out: dict = {}
    for name, mod in model.named_modules():
        amap = getattr(mod, "attn_map", None)
        if name and isinstance(amap, torch.Tensor):
            node = out
            for part in name.split("."):
                node = node.setdefault(part, {})
            node["attn_map"] = amap
    return out


def _forward(cfg, payload, imgs_u8: np.ndarray, device):
    """The model of ``cfg`` with ``save_attn_map=True`` and the payload's
    weights, and its eval-path logits on ``imgs_u8``."""
    cfg = cfg.replace(save_attn_map=True)
    model, _ = get_model(cfg, device=device)
    model.load_state_dict({**payload["params"],
                           **(payload.get("model_state") or {})})
    x = normalize(torch.from_numpy(np.array(imgs_u8, np.uint8)).to(device),
                  cfg.mean, cfg.std).to(torch_dtype(cfg))
    with torch.no_grad():
        logits = model(x, deterministic=True)
    return cfg, model, logits.to(torch.float32).cpu().numpy()


def load_run_model(model_path: str, batch_size: int | None = None,
                   which: str = "best", device="cuda"):
    """-> (model, cfg, imgs_u8, logits, intermediates).

    ``model_path`` is a checkpoint directory produced by training
    (``models/{experiment}/`` with config.json + best/last); the forward
    runs on ``device`` (default the card) over the first
    ``eval_batch_size`` (or ``batch_size``) test images."""
    payload, cfg = load_checkpoint(model_path, prefer=which)
    if batch_size is not None:
        cfg = cfg.replace(eval_batch_size=batch_size)
    raw = load_dataset(cfg.dataset, cfg.data_dir, cfg.synthetic_data)
    imgs = raw.x_test[: cfg.eval_batch_size]
    cfg, model, out = _forward(cfg, payload, imgs, device)
    return model, cfg, np.asarray(imgs), out, intermediates(model)


def run_on_images(model_path: str, imgs_u8, which: str = "best",
                  device="cuda"):
    """Attention-capturing forward on user-supplied uint8 images (the live
    dashboard server's uploads), by the same path as
    :func:`load_run_model`.  ``imgs_u8``: (B, img_size, img_size, in_c)
    uint8.  -> (cfg, logits, intermediates)."""
    payload, cfg = load_checkpoint(model_path, prefer=which)
    imgs = np.asarray(imgs_u8, np.uint8)
    want = (cfg.img_size, cfg.img_size, cfg.in_c)
    if imgs.ndim != 4 or imgs.shape[1:] != want:
        raise ValueError(f"expected (B,{want[0]},{want[1]},{want[2]}) uint8, "
                         f"got {imgs.shape}")
    cfg, model, out = _forward(cfg, payload, imgs, device)
    return cfg, out, intermediates(model)


def find_checkpoints(ckpt_dir: str = "models") -> list[str]:
    """Checkpoint directories under ``ckpt_dir``, oldest first (dashboard
    model picker -- its ``[-max_models:]`` slice then keeps the newest)."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        p = os.path.join(ckpt_dir, name)
        if os.path.isdir(p) and os.path.exists(os.path.join(p, "config.json")):
            out.append(p)
    return sorted(out, key=lambda p: (os.path.getmtime(p), p))
