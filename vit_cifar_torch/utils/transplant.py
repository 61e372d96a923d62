"""Carry weights between the JAX package's flax params and the port.

A flax ``params`` tree is a nested dict of arrays (what ``jax.device_get``
or orbax give).  The port's parameters have the flax names joined by dots;
a Linear's flax ``kernel`` (in, out) is the port's ``weight`` (out, in), and
a LayerNorm's ``scale`` is its ``weight``.  numpy and torch only.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def state_dict_from_flax(params) -> dict[str, torch.Tensor]:
    """Nested flax params -> the port's ``state_dict``."""
    out = {}
    for path, val in _flatten(params):
        arr = np.asarray(val)
        *mod, leaf = path
        if leaf == "kernel":
            leaf, arr = "weight", arr.T
        elif leaf == "scale":
            leaf = "weight"
        out[".".join((*mod, leaf))] = torch.from_numpy(np.array(arr))  # a copy
    return out


def flax_from_state_dict(state_dict) -> dict:
    """The port's ``state_dict`` -> nested flax params of numpy arrays."""
    out: dict = {}
    for key, val in state_dict.items():
        *mod, leaf = key.split(".")
        arr = val.detach().cpu().numpy()
        if leaf == "weight":
            leaf, arr = ("kernel", arr.T) if arr.ndim == 2 else ("scale", arr)
        node = out
        for m in mod:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(arr)
    return out
