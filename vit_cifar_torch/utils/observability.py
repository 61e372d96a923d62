"""Observability, as ``vit_cifar_tpu/utils/observability.py``: the model
summary, layer outputs, histograms and the profiler hook.

Reference equivalents:
  * Lightning's ModelSummary at fit start (network.py:124-132) ->
    ``model_summary``;
  * the forward-hook capture of layer outputs (utils.py:21-44) ->
    ``get_layer_outputs``, forward hooks here too;
  * Comet 3D histograms of weights and layer outputs each epoch and of
    gradients every ``log_gradients_interval`` steps (network.py:229-374)
    -> ``log_histograms``; with the CSV logger they land in
    ``{log_dir}/{experiment}/histograms/`` as .npz;
  * no profiler in the reference -> ``profile_trace`` wraps
    ``torch.profiler`` and writes a chrome trace.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
from torch import nn


def model_summary(named_params, depth: int = -1) -> str:
    """Parameter counts by module path (``name`` split at dots; ``depth``
    keeps that many leading parts, -1 all of them)."""
    rows: dict[str, int] = {}
    total = 0
    for name, p in named_params:
        parts = name.split(".")
        key = "/".join(parts if depth < 0 else parts[:depth])
        rows[key] = rows.get(key, 0) + p.numel()
        total += p.numel()
    width = max((len(k) for k in rows), default=10) + 2
    lines = [f"{'module':<{width}} params"]
    lines += [f"{k:<{width}} {v:,}" for k, v in rows.items()]
    lines.append(f"{'TOTAL':<{width}} {total:,}")
    return "\n".join(lines)


@torch.no_grad()
def get_layer_outputs(model: nn.Module, x: torch.Tensor,
                      **forward_kwargs) -> dict[str, torch.Tensor]:
    """Every submodule's tensor output on ``x`` (deterministic forward),
    keyed by module path, captured with forward hooks: a tuple's first
    tensor under the path, the i-th under ``path.i`` (an AE's
    reconstruction and hidden activity), and the tensors an AE mixer keeps
    (``ae_input``, ``ae_output``, ``ae_hidden``) under ``path.<name>``, as
    the JAX package's capture of the intermediates gives them."""
    out: dict[str, torch.Tensor] = {}
    handles = []
    for name, mod in model.named_modules():
        if not name:
            continue

        def hook(_mod, _inp, output, name=name):
            outputs = output if isinstance(output, tuple) else (output,)
            for i, t in enumerate(outputs):
                if isinstance(t, torch.Tensor):  # a module's first call
                    out.setdefault(name if i == 0 else f"{name}.{i}",
                                   t.detach())

        handles.append(mod.register_forward_hook(hook))
    try:
        model(x, deterministic=True, **forward_kwargs)
    finally:
        for h in handles:
            h.remove()
    for name, mod in model.named_modules():
        for key in ("ae_input", "ae_output", "ae_hidden"):
            t = getattr(mod, key, None)
            if isinstance(t, torch.Tensor):
                out[f"{name}.{key}" if name else key] = t.detach()
    return out


def compute_histograms(tree: dict[str, torch.Tensor], bins: int = 64
                       ) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """(counts, bin edges) of each tensor over ``bins`` equal bins from its
    min to its max (numpy's default range; a constant tensor gets
    [v - 0.5, v + 0.5]).  Computed on the tensors' device, then read back
    in one transfer."""
    counts, edges = [], []
    for t in tree.values():
        v = t.detach().reshape(-1).to(torch.float32)
        lo, hi = v.min(), v.max()
        flat = hi == lo
        lo, hi = torch.where(flat, lo - 0.5, lo), torch.where(flat, hi + 0.5,
                                                              hi)
        i = torch.clamp(((v - lo) / (hi - lo) * bins).to(torch.int64), 0,
                        bins - 1)
        counts.append(torch.zeros(bins, dtype=torch.int64, device=v.device)
                      .scatter_add_(0, i, torch.ones_like(i)))
        edges.append(lo + (hi - lo) * torch.linspace(0, 1, bins + 1,
                                                     device=v.device))
    if not counts:
        return {}
    counts, edges = torch.stack(counts).cpu(), torch.stack(edges).cpu()
    return {name: (counts[j].numpy(), edges[j].numpy())
            for j, name in enumerate(tree)}


def log_histograms(logger, tree: dict[str, torch.Tensor], prefix: str,
                   step: int, epoch: int, bins: int = 64) -> None:
    """Comet: ``log_histogram_3d`` of each tensor's values; CSV: one .npz
    of every tensor's histogram a call."""
    if getattr(logger, "comet", None) is not None:
        for name, t in tree.items():
            logger.comet.log_histogram_3d(
                t.detach().float().cpu().numpy().reshape(-1),
                name=f"{prefix}/{name.replace('.', '/')}", step=step,
                epoch=epoch)
        return
    payload = {}
    for name, (counts, edges) in compute_histograms(tree, bins).items():
        payload[f"{name}__counts"] = counts
        payload[f"{name}__edges"] = edges
    hist_dir = os.path.join(logger.dir, "histograms")
    os.makedirs(hist_dir, exist_ok=True)
    np.savez_compressed(
        os.path.join(hist_dir, f"{prefix}_e{epoch:04d}_s{step}.npz"),
        **payload)


@contextlib.contextmanager
def profile_trace(profile_dir: str):
    """A ``torch.profiler`` capture of the CPU and, where there is one, the
    CUDA card, written as a chrome trace into ``profile_dir`` ('' does
    nothing)."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
