"""Carry weights between the JAX package's flax variables and the port.

A flax collection is a nested dict of arrays (what ``jax.device_get`` or
orbax give).  The port's parameters and buffers have the flax names joined
by dots, flax's automatic names (``Conv_0`` inside ``TorchConv``,
``TorchBatchNorm_0`` and ``LayerNorm_0`` inside the norm wrappers)
included.  A Linear's flax ``kernel`` (in, out) is the port's ``weight``
(out, in); a convolution's ``kernel`` (kh, kw, in, out) is its ``weight``
(out, in, kh, kw); a LayerNorm's or BatchNorm's ``scale`` is its
``weight``.  Every other parameter keeps its name and layout, whatever its
rank: GatedMLP's TxT ``weight``, AFT's ``w``, ``u`` and ``v``, an NNMF
layer's (C, M) ``nnmf_weights``, the MoE's stacked ``expert_*``.  The
port's buffers are two flax collections: BatchNorm's ``mean`` and ``var``
are ``batch_stats``, every other buffer (the persistent ``bases`` of
``--train-md-bases``) is ``state``.  numpy and torch only.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.common import LayerNorm
from ..ops.init import Linear, NHWCConv
from ..ops.norm import TorchBatchNorm


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def state_dict_from_flax(params, state=None,
                         batch_stats=None) -> dict[str, torch.Tensor]:
    """Nested flax params (and the ``state`` and ``batch_stats``
    collections, where given) -> the port's ``state_dict``."""
    out = {".".join(path): torch.from_numpy(np.array(val))
           for tree in (state, batch_stats)
           for path, val in _flatten(tree or {})}
    for path, val in _flatten(params):
        arr = np.asarray(val)
        *mod, leaf = path
        if leaf == "kernel":
            leaf = "weight"
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        elif leaf == "scale":
            leaf = "weight"
        out[".".join((*mod, leaf))] = torch.from_numpy(np.array(arr))  # a copy
    return out


def flax_layout(owner: nn.Module, leaf: str) -> tuple[str, tuple | None]:
    """The flax name of entry ``leaf`` of module ``owner``, and the axes
    permutation that takes the port's layout to flax's (None: the same
    layout): a Linear's ``weight`` is a ``kernel`` (1, 0), a convolution's
    a ``kernel`` (2, 3, 1, 0), a LayerNorm's or BatchNorm's a ``scale``."""
    if leaf == "weight" and isinstance(owner, Linear):
        return "kernel", (1, 0)
    if leaf == "weight" and isinstance(owner, NHWCConv):
        return "kernel", (2, 3, 1, 0)
    if leaf == "weight" and isinstance(owner, (LayerNorm, TorchBatchNorm)):
        return "scale", None
    return leaf, None


def flax_from_state_dict(model: nn.Module, state_dict=None,
                         collection: str = "params") -> dict:
    """The port's ``state_dict`` (default ``model``'s own) -> the nested
    flax ``collection`` of numpy arrays: ``"params"`` from the parameters,
    ``"batch_stats"`` from BatchNorm's buffers, ``"state"`` from the other
    buffers.  ``model`` names the module that owns each entry: a Linear's
    or a convolution's ``weight`` becomes a transposed ``kernel``, a
    LayerNorm's or BatchNorm's a ``scale``, anything else keeps its
    name."""
    if state_dict is None:
        state_dict = model.state_dict()
    owners = dict(model.named_modules())
    buffers = {name for name, _ in model.named_buffers()}
    out: dict = {}
    for key, val in state_dict.items():
        *mod, leaf = key.split(".")
        owner = owners[".".join(mod)]
        if key not in buffers:
            kind = "params"
        else:
            kind = ("batch_stats" if isinstance(owner, TorchBatchNorm)
                    else "state")
        if kind != collection:
            continue
        arr = val.detach().cpu().numpy()
        leaf, perm = flax_layout(owner, leaf)
        if perm is not None:
            arr = arr.transpose(perm)
        node = out
        for m in mod:
            node = node.setdefault(m, {})
        node[leaf] = np.array(arr, copy=True)  # owns its memory: no view
    return out
