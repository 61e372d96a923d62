"""Carry weights between the JAX package's flax params and the port.

A flax ``params`` tree is a nested dict of arrays (what ``jax.device_get``
or orbax give).  The port's parameters have the flax names joined by dots;
a Linear's flax ``kernel`` (in, out) is the port's ``weight`` (out, in), and
a LayerNorm's ``scale`` is its ``weight``.  Every other parameter keeps its
name and layout, whatever its rank: GatedMLP's TxT ``weight`` is a
``weight`` on both sides, AFT's ``w``, ``u`` and ``v`` are themselves, an
NNMF layer's (C, M) ``nnmf_weights`` is (C, M) on both sides.  JAX's
``state`` collection (the persistent ``bases`` of ``--train-md-bases``) is
the port's buffers, by the same dotted names.  numpy and torch only.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.common import LayerNorm
from ..ops.init import Linear


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def state_dict_from_flax(params, state=None) -> dict[str, torch.Tensor]:
    """Nested flax params (and the ``state`` collection, where given) ->
    the port's ``state_dict``."""
    out = {".".join(path): torch.from_numpy(np.array(val))
           for path, val in _flatten(state or {})}
    for path, val in _flatten(params):
        arr = np.asarray(val)
        *mod, leaf = path
        if leaf == "kernel":
            leaf, arr = "weight", arr.T
        elif leaf == "scale":
            leaf = "weight"
        out[".".join((*mod, leaf))] = torch.from_numpy(np.array(arr))  # a copy
    return out


def flax_from_state_dict(model: nn.Module, state_dict=None,
                         collection: str = "params") -> dict:
    """The port's ``state_dict`` (default ``model``'s own) -> the nested
    flax ``collection`` of numpy arrays: ``"params"`` from the parameters,
    ``"state"`` from the buffers.  ``model`` names the module that owns each
    parameter: a Linear's ``weight`` becomes a transposed ``kernel``, a
    LayerNorm's a ``scale``, anything else keeps its name."""
    if state_dict is None:
        state_dict = model.state_dict()
    owners = dict(model.named_modules())
    buffers = {name for name, _ in model.named_buffers()}
    out: dict = {}
    for key, val in state_dict.items():
        if (key in buffers) != (collection == "state"):
            continue
        *mod, leaf = key.split(".")
        arr = val.detach().cpu().numpy()
        owner = owners[".".join(mod)]
        if leaf == "weight" and isinstance(owner, Linear):
            leaf, arr = "kernel", arr.T
        elif leaf == "weight" and isinstance(owner, LayerNorm):
            leaf = "scale"
        node = out
        for m in mod:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(arr)
    return out
