"""Attention-visualization dashboard, as
``vit_cifar_tpu/analysis/dashboard.py``.

Reference: dashboard.py — a Streamlit app with a model picker, token/head
selectors, attention vs joint-attention (rollout) heatmaps, and input overlays
(dashboard.py:77-393).  Streamlit is not in this image, so the same capability
ships as a matplotlib report generator with a CLI:

    python -m vit_cifar_torch.analysis.dashboard --ckpt models/<experiment> \
        --image 0 --token 0 --out report/ [--device cuda]

which writes, per layer: raw attention heatmaps per head, the rollout, and
the token-attention overlay on the input image, plus an index.html stitching
them together.  The forward runs on ``--device`` (default the card);
matplotlib is imported inside the functions that draw.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .attention_maps import (
    collect_attention_maps,
    draw_divided_image_with_index,
    get_joint_attentions,
)
from .run_model import find_checkpoints, load_run_model


def _save_heatmap_grid(maps, title, path, token=None):
    """maps: (H, T, T) one layer's heads."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n_heads = maps.shape[0]
    cols = min(n_heads, 6)
    rows = -(-n_heads // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows), squeeze=False)
    for h in range(rows * cols):
        ax = axes[h // cols][h % cols]
        if h < n_heads:
            data = maps[h] if token is None else maps[h][token][None]
            ax.imshow(data, cmap="viridis", aspect="auto")
            ax.set_title(f"head {h}", fontsize=8)
        ax.set_xticks([])
        ax.set_yticks([])
    fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def _save_overlay(img, attn_row, patch, path, title):
    """Overlay one token's attention over the input image.

    attn_row: (T,) attention from the selected token (cls stripped outside).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    H, W = img.shape[:2]
    grid = attn_row.reshape(patch, patch)
    up = np.kron(grid, np.ones((H // patch, W // patch)))
    fig, ax = plt.subplots(figsize=(4, 4))
    ax.imshow(img / 255.0 if img.max() > 1.5 else img)
    ax.imshow(up, cmap="jet", alpha=0.45)
    ax.set_title(title)
    ax.set_xticks([])
    ax.set_yticks([])
    fig.savefig(path, dpi=110)
    plt.close(fig)


def generate_report(
    ckpt: str,
    out_dir: str = "report",
    image_index: int = 0,
    token: int = 0,
    batch_size: int = 8,
    device="cuda",
) -> str:
    os.makedirs(out_dir, exist_ok=True)
    _, cfg, imgs, logits, inter = load_run_model(ckpt, batch_size=batch_size,
                                                 device=device)
    attn = collect_attention_maps(inter)  # (L,B,H,T,T)
    joint = get_joint_attentions(attn)  # (L,B,H,T,T)
    img = imgs[image_index]
    pred = int(np.argmax(logits[image_index]))

    files = []
    L = attn.shape[0]
    for layer in range(L):
        p1 = os.path.join(out_dir, f"attn_l{layer}.png")
        _save_heatmap_grid(
            attn[layer, image_index], f"layer {layer} attention", p1
        )
        files.append(os.path.basename(p1))
        p2 = os.path.join(out_dir, f"rollout_l{layer}.png")
        _save_heatmap_grid(
            joint[layer, image_index], f"layer {layer} rollout", p2
        )
        files.append(os.path.basename(p2))

        # overlay: attention row for the chosen token, averaged over heads,
        # cls column stripped when present
        row = attn[layer, image_index].mean(axis=0)[token]
        if cfg.is_cls_token:
            row = row[1:]
        p3 = os.path.join(out_dir, f"overlay_l{layer}.png")
        _save_overlay(
            img, row, cfg.patch, p3,
            f"layer {layer} token {token} (pred={pred})",
        )
        files.append(os.path.basename(p3))

    # patch-grid reference image
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(4, 4))
    tok_no_cls = max(token - 1, 0) if cfg.is_cls_token else token
    draw_divided_image_with_index(img, cfg.patch, tok_no_cls, ax=ax)
    grid_path = os.path.join(out_dir, "input_grid.png")
    fig.savefig(grid_path, dpi=110)
    plt.close(fig)
    files.insert(0, os.path.basename(grid_path))

    html = ["<html><body><h1>Attention report</h1>",
            f"<p>checkpoint: {ckpt} | image {image_index} | token {token} | "
            f"prediction: class {pred}</p>"]
    for f in files:
        html.append(f'<div><h3>{f}</h3><img src="{f}"/></div>')
    html.append("</body></html>")
    index = os.path.join(out_dir, "index.html")
    with open(index, "w") as f:
        f.write("\n".join(html))
    return index


def main(argv=None):
    p = argparse.ArgumentParser(description="Attention visualization dashboard")
    p.add_argument("--ckpt", default=None, help="checkpoint dir (models/<experiment>)")
    p.add_argument("--ckpt-dir", default="models", help="where to look for checkpoints")
    p.add_argument("--out", default="report")
    p.add_argument("--image", default=0, type=int, help="(--static only)")
    p.add_argument("--token", default=0, type=int, help="(--static only)")
    p.add_argument("--batch-size", default=8, type=int)
    p.add_argument("--static", action="store_true",
                   help="matplotlib page for one fixed image/token instead of "
                        "the interactive client-side viewer")
    p.add_argument("--max-models", default=8, type=int,
                   help="embed at most this many checkpoints (newest first)")
    p.add_argument("--device", default="cuda",
                   help="the torch device of the forward (default cuda)")
    args = p.parse_args(argv)

    if args.ckpt is not None:
        ckpts = [args.ckpt]
    else:
        ckpts = find_checkpoints(args.ckpt_dir)
        if not ckpts:
            raise SystemExit(f"no checkpoints found under {args.ckpt_dir!r}")
        if not args.static:
            ckpts = ckpts[-args.max_models:]
            print(f"embedding {len(ckpts)} checkpoint(s): {ckpts}")
        else:
            ckpts = ckpts[-1:]
            print(f"using latest checkpoint: {ckpts[0]}")

    if args.static:
        index = generate_report(
            ckpts[0], args.out, args.image, args.token, args.batch_size,
            args.device,
        )
    else:
        # the Streamlit-parity interactive viewer (dashboard.py:77-236):
        # model/image/token/head/colormap selectors switch maps client-side
        from .interactive import generate_interactive

        index = generate_interactive(ckpts, args.out, args.batch_size,
                                     args.device)
    print(f"report written to {index}")


if __name__ == "__main__":
    main()
