"""Model factory: ``get_model(cfg) -> (model, can_learn_unsupervised)``, as
``vit_cifar_tpu/models/__init__.py``.

Only ``vit`` is ported so far.  Every other model of the zoo raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import functools

import torch

from ..config import MODEL_NAMES, Config, torch_dtype
from ..ops.attention import MultiHeadSelfAttention
from .vit import ViT

_ZOO_ITEM = "ROADMAP queue 1, item 7 (zoo mixers)"


def get_model(cfg: Config, *, device="cuda",
              generator: torch.Generator | None = None):
    """Build the model of ``cfg`` on ``device`` (default the CUDA card;
    pass ``device="cpu"`` for the CPU).  Without a card the default raises.

    Weights are drawn from ``generator`` (default: a CPU generator seeded
    with ``cfg.seed``), always on the CPU, so a seed gives one set of weights
    on every device.
    """
    name = cfg.model_name
    if name not in MODEL_NAMES:
        raise NotImplementedError(f"{name} is not implemented yet...")
    if name != "vit":
        raise NotImplementedError(
            f"model {name!r} is not ported to torch yet: {_ZOO_ITEM}")
    if cfg.moe_experts > 0:
        raise NotImplementedError(
            f"--moe-experts is not ported to torch yet: {_ZOO_ITEM}")
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    dtype = torch_dtype(cfg)
    mixer = functools.partial(
        MultiHeadSelfAttention, cfg.hidden, cfg.head, cfg.dropout,
        generator=generator, dtype=dtype, save_attn_map=cfg.save_attn_map,
        pallas_kernel=cfg.pallas_kernel or None, device=device)
    model = ViT(
        mixer, num_classes=cfg.num_classes, img_size=cfg.img_size,
        patch=cfg.patch, num_layers=cfg.num_layers, hidden=cfg.hidden,
        mlp_hidden=cfg.mlp_hidden, dropout=cfg.dropout,
        use_encoder_mlp=cfg.use_encoder_mlp, is_cls_token=cfg.is_cls_token,
        in_c=cfg.in_c, generator=generator, dtype=dtype, device=device,
        remat=cfg.remat)
    return model, False
