"""Attention-map collection and attention rollout, as
``vit_cifar_tpu/analysis/attention_maps.py``.  numpy only; matplotlib is
imported inside ``draw_divided_image_with_index``.

Reference: attention/utils.py (shipped broken: ``attention/`` has no
``__init__.py``, so ``from attention import ...`` ImportErrors).

  * ``collect_attention_maps`` — gathers the per-layer maps of
    ``run_model.intermediates`` (the modules' ``attn_map`` attributes, as
    the reference scans modules for ``get_attention_map()``,
    attention/utils.py:62-68).
  * ``get_joint_attentions`` — attention rollout: add identity for the
    residual path, renormalize, cumulative matmul across layers
    (attention/utils.py:70-105).
  * ``draw_divided_image_with_index`` — patch-grid overlay with a highlighted
    patch (attention/utils.py:6-59), matplotlib instead of PIL drawing.
"""

from __future__ import annotations

import numpy as np


def collect_attention_maps(intermediates, num_layers: int | None = None) -> np.ndarray:
    """-> (L, B, H, T, T).  Maps without a head axis get H=1."""
    maps = []
    layers = sorted(
        (k for k in intermediates.keys() if k.startswith("enc")),
        key=lambda k: int(k[3:]),
    )
    if num_layers is not None:
        layers = layers[:num_layers]
    for k in layers:
        node = intermediates[k]
        # descend to the sown attn_map
        while isinstance(node, dict) and "attn_map" not in node:
            for v in node.values():
                if isinstance(v, dict):
                    node = v
                    break
            else:
                node = None
                break
        if node is None or "attn_map" not in node:
            continue
        m = node["attn_map"]
        m = m[0] if isinstance(m, (tuple, list)) else m
        if hasattr(m, "detach"):  # a torch tensor, on any device
            m = m.detach().float().cpu().numpy()
        m = np.asarray(m, np.float32)
        if m.ndim == 3:  # (B,T,T) -> (B,1,T,T)
            m = m[:, None]
        maps.append(m)
    if not maps:
        raise ValueError(
            "No attention maps found — build the model with save_attn_map=True "
            "(cfg.replace(save_attn_map=True)) and gather them with "
            "run_model.intermediates after a forward."
        )
    return np.stack(maps)


def get_joint_attentions(attn_mat, token: int | None = None) -> np.ndarray:
    """Attention rollout (attention/utils.py:70-105).

    attn_mat: (L, B, H, T, T).  Returns (L, B, H, T, T), or (L, B, H, T) when
    ``token`` is given.
    """
    attn_mat = np.asarray(attn_mat, np.float32)
    T = attn_mat.shape[-1]
    aug = attn_mat + np.eye(T, dtype=np.float32)
    aug = aug / aug.sum(axis=-1, keepdims=True)

    joint = np.zeros_like(aug)
    joint[0] = aug[0]
    for n in range(1, aug.shape[0]):
        joint[n] = np.matmul(aug[n], joint[n - 1])

    if token is None:
        return joint
    return joint[:, :, :, token, :]


def draw_divided_image_with_index(
    img: np.ndarray, patch: int, index: int | None = None, ax=None
):
    """Patch-grid overlay with an optional highlighted patch
    (attention/utils.py:6-59).  img: (H, W, C) in [0,1] or [0,255]."""
    import matplotlib.pyplot as plt
    from matplotlib import patches as mpatches

    if ax is None:
        _, ax = plt.subplots()
    img = np.asarray(img)
    if img.max() > 1.5:
        img = img / 255.0
    H, W = img.shape[:2]
    ps_h, ps_w = H // patch, W // patch
    ax.imshow(img)
    for i in range(1, patch):
        ax.axhline(i * ps_h - 0.5, color="white", linewidth=0.5)
        ax.axvline(i * ps_w - 0.5, color="white", linewidth=0.5)
    if index is not None:
        row, col = divmod(index, patch)
        ax.add_patch(
            mpatches.Rectangle(
                (col * ps_w - 0.5, row * ps_h - 0.5), ps_w, ps_h,
                fill=False, edgecolor="red", linewidth=2,
            )
        )
    ax.set_xticks([])
    ax.set_yticks([])
    return ax
