"""Rendered model-graph images (the torchview.draw_graph equivalent), as
``vit_cifar_tpu/analysis/graph_render.py``.

The reference draws a graphviz PNG of the whole model and, for ViT /
LocalGlobalCNN, of the first encoder block at depth 5
(``/root/reference/network.py:397-452`` via ``torchview.draw_graph`` with
``expand_nested=True``).  As in the JAX package, the same information --
the nested module tree in call order, with output shapes and parameter
counts -- is drawn as a matplotlib block diagram: one box per module,
children nested inside their parent, vertical order = call order, arrows
between consecutive top-level stages.

Structure comes from forward hooks on a real call of the model, in place
of flax's tabulate; the call runs on fake tensors, so it costs no device
work.  matplotlib is imported inside ``render_graph`` only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch
from torch import nn

__all__ = ["module_rows", "graph_table", "encoder_block_rows",
           "render_graph"]


@dataclasses.dataclass(frozen=True)
class Row:
    """One traced module call: its tree path, type name, output shape, params."""

    path: tuple
    type_name: str
    out_shape: tuple | None
    n_params: int


def _shape_of(outputs: Any) -> tuple | None:
    if isinstance(outputs, torch.Tensor):
        return tuple(outputs.shape)
    if isinstance(outputs, (tuple, list)) and outputs and isinstance(
            outputs[0], torch.Tensor):
        return tuple(outputs[0].shape)
    return None


def module_rows(model: nn.Module, *args, depth: int = 5,
                **kwargs) -> list[Row]:
    """Trace ``model(*args, **kwargs)`` and return its module tree in call
    order: a row for each module call up to ``depth`` levels below the
    root (the root is ``()``), as flax's tabulate gives them.

    The call runs under ``FakeTensorMode``: the shapes come out and no
    device work is done (no kernel is launched), as JAX's tabulate traces
    abstractly.  A row counts the parameters and buffers (flax's every
    collection) that the module holds itself and those of its children
    that were never called; at ``depth`` it counts its whole subtree; a
    repeated call counts none."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    calls: list[list] = []  # [path, module, output] in call order
    handles = []
    for name, mod in model.named_modules():
        path = tuple(name.split(".")) if name else ()

        def pre(_mod, _inp, path=path):
            calls.append([path, _mod, None])

        def post(_mod, _inp, output, path=path):
            for call in reversed(calls):
                if call[0] == path and call[2] is None:
                    call[2] = output
                    break

        handles.append(mod.register_forward_pre_hook(pre))
        handles.append(mod.register_forward_hook(post))
    try:
        with FakeTensorMode(allow_non_fake_inputs=True) as mode, \
                torch.no_grad():
            fake = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                    for a in args]
            model(*fake, **kwargs)
    finally:
        for h in handles:
            h.remove()

    sizes = {}  # the module path of each parameter and buffer -> numel
    for name, t in (*model.named_parameters(), *model.named_buffers()):
        mod = tuple(name.split(".")[:-1])
        sizes[mod] = sizes.get(mod, 0) + t.numel()
    called = {c[0] for c in calls}

    def owned(path: tuple) -> int:
        """Entries whose nearest called module on the way up is ``path``."""
        n = 0
        for mod, size in sizes.items():
            if mod[:len(path)] != path:
                continue
            inner = mod[len(path):]
            if not any(path + inner[:i] in called
                       for i in range(1, len(inner) + 1)):
                n += size
        return n

    rows, seen = [], set()
    for path, mod, output in calls:
        if len(path) > depth:
            continue
        if path in seen:
            n = 0
        elif len(path) == depth:
            n = sum(s for m, s in sizes.items() if m[:len(path)] == path)
        else:
            n = owned(path)
        seen.add(path)
        rows.append(Row(path, type(mod).__name__, _shape_of(output), n))
    return rows


def graph_table(rows: Sequence[Row], depth: int = 4) -> str:
    """The rows up to ``depth`` as a text table (the ``model_graph.txt`` of
    the training loop): path, type, output shape and parameters."""
    rows = [r for r in rows if len(r.path) <= depth]
    paths = ["/".join(r.path) or "(root)" for r in rows]
    w = max(len(p) for p in paths) + 2
    t = max(len(r.type_name) for r in rows) + 2
    lines = [f"{'path':<{w}}{'module':<{t}}{'output':<24}params"]
    for p, r in zip(paths, rows):
        shape = "" if r.out_shape is None else str(list(r.out_shape))
        lines.append(f"{p:<{w}}{r.type_name:<{t}}{shape:<24}{r.n_params:,}")
    total = sum(r.n_params for r in rows)
    lines.append(f"{'TOTAL':<{w + t + 24}}{total:,}")
    return "\n".join(lines)


def encoder_block_rows(rows: Sequence[Row]) -> list[Row] | None:
    """The subtree of the first encoder block (reference: ``model.enc[0]``).

    Encoder stacks are named ``enc0..encN`` across the zoo (ViT mixers and the
    LocalGlobalCNN encoder alike); returns None when no such block exists, in
    which case the caller prints the reference's warning.
    """
    first = next((r.path[0] for r in rows if len(r.path) == 1
                  and r.path[0].startswith("enc")), None)
    if first is None:
        return None
    sub = [r for r in rows if r.path[: 1] == (first,)]
    return [dataclasses.replace(r, path=r.path[1:] or (first,)) for r in sub]


def _label(row: Row) -> str:
    name = row.path[-1] if row.path else ""
    s = f"{name}: {row.type_name}" if name else row.type_name
    if row.out_shape is not None:
        s += f"  {list(row.out_shape)}"
    if row.n_params:
        s += f"  ({row.n_params:,}p)"
    return s


def render_graph(rows: Sequence[Row], out_path: str, title: str = "") -> None:
    """Draw the module tree as a nested block-diagram PNG.

    Layout: pre-order rows become nested boxes — each leaf takes one vertical
    slot, a container box spans its children; x-indent encodes depth; arrows
    connect consecutive top-level stages in call order (the reference's
    sequential data flow).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import FancyArrowPatch, Rectangle

    rows = list(rows)
    if not rows:
        return
    # drop a root row covering everything so nesting starts at its children
    if len(rows[0].path) == 0 or all(
        r.path[: len(rows[0].path)] == rows[0].path for r in rows
    ):
        root, rows = rows[0], rows[1:] or [rows[0]]
        base = len(root.path)
        rows = [dataclasses.replace(r, path=r.path[base:]) for r in rows]
        title = title or _label(root)

    # every row takes one header slot (pre-order); a container's box
    # additionally spans all its descendants' slots
    spans: list[list[int]] = []
    stack: list[int] = []  # indices of open containers
    for i, r in enumerate(rows):
        while stack and rows[stack[-1]].path != r.path[: len(rows[stack[-1]].path)]:
            stack.pop()
        spans.append([i, i])
        for j in stack:
            spans[j][1] = i
        if i + 1 < len(rows) and rows[i + 1].path[: len(r.path)] == r.path:
            stack.append(i)
    slots = len(rows)

    depth = max(len(r.path) for r in rows)
    slot_h, indent = 0.42, 0.28
    fig_h = max(2.0, slots * slot_h + 1.2)
    fig_w = max(6.0, depth * indent + 0.62 * max(len(_label(r)) for r in rows) * 0.11 + 2)
    fig, ax = plt.subplots(figsize=(min(fig_w, 16), min(fig_h, 48)))
    ax.set_xlim(0, 10)
    ax.set_ylim(-(slots * slot_h + 0.4), 0.4)
    ax.axis("off")
    if title:
        ax.set_title(title, fontsize=10, fontweight="bold")

    palette = ["#4c72b0", "#dd8452", "#55a868", "#c44e52", "#8172b3", "#937860"]
    tops: list[tuple[float, float, float]] = []  # (y_top, y_bot, x_left) of depth-1 boxes
    for i, r in enumerate(rows):
        d = len(r.path)
        x0 = d * indent
        x1 = 10 - d * indent
        y0 = -(spans[i][0] * slot_h)
        y1 = -(spans[i][1] * slot_h + slot_h * 0.92)
        is_leaf = not (i + 1 < len(rows) and rows[i + 1].path[: d] == r.path)
        color = palette[(d - 1) % len(palette)]
        ax.add_patch(
            Rectangle((x0, y1), x1 - x0, y0 - y1,
                      facecolor=color if is_leaf else "none",
                      alpha=0.25 if is_leaf else 1.0,
                      edgecolor=color, linewidth=1.2 if d == 1 else 0.8)
        )
        ax.text(x0 + 0.08, y0 - 0.055, _label(r), fontsize=7.5,
                va="top", ha="left", family="monospace")
        if d == 1:
            tops.append((y0, y1, (x0 + x1) / 2))
    for (_, y_prev, xc), (y_next, _, _) in zip(tops, tops[1:]):
        ax.add_patch(
            FancyArrowPatch((xc, y_prev), (xc, y_next), arrowstyle="-|>",
                            mutation_scale=9, color="0.35", linewidth=0.9)
        )
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
