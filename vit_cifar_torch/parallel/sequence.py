"""Sequence parallelism: the token stream cut over a ``seq`` mesh axis, as
``vit_cifar_tpu/parallel/sequence.py``.

JAX pins the (B, T, F) stream to ``P('data', 'seq', None)`` after the
embedding and after every block, and GSPMD places the collectives.  Here
``seq_parallel_model`` sets the ``seq_axis`` hooks of the ViT and of its
modules (``models/vit.py``, ``ops/attention.py``, ``ops/common.py``,
``ops/moe.py``), which write the same schedule out by hand:

  * the padded stream is cut over the axis after the embedding;
  * LayerNorm, the residuals and the MLP run on the rank's tokens;
  * the attention runs the rank's queries against the keys and values
    gathered over the axis, masked by the global key index;
  * the pooled row is summed over the axis (``reduce_from``) from the rank
    holding the cls token, or from every rank's real tokens for the mean;
  * dropout draws at the padded global shape, cut by ``seq`` as by
    ``data``; the MoE's capacity, buffer places and statistics are those of
    the whole stream.

A rank's gradient is then its tokens' part, except the head's, which every
rank computes whole: the train step sums the flat gradient over the axis
with the head counted on the axis's first rank (``mesh.trunk_split``).

Padding: the parity token count (T = 65 = 8x8 patches + cls) divides no
power-of-two axis, so the stream gets ``(-T) % S`` zero tokens
(``ViT.seq_pad``) and the attention a ``valid_len`` of T, so real tokens
never attend to pad; pad rows are dropped before pooling.  Scope, as in
JAX: the ``vit`` mixer (``MultiHeadSelfAttention``) only, and no padded
stream under the MoE, whose router would give pad tokens expert capacity.
"""

from __future__ import annotations

from ..models.vit import ViT
from ..ops.attention import MultiHeadSelfAttention
from .mesh import Mesh


def has_seq_axis(mesh: Mesh | None) -> bool:
    return mesh is not None and mesh.shape.get("seq", 1) > 1


def pad_stream(vit: ViT, n_seq: int) -> int:
    """Pad ``vit``'s stream, in place, to a multiple of ``n_seq`` tokens,
    its attention masking the pad keys; returns the pad.  This is the
    one-process model that a seq axis of ``n_seq`` cuts."""
    seq_len = vit.patch ** 2 + (1 if vit.is_cls_token else 0)
    pad = (-seq_len) % n_seq
    vit.seq_pad = pad
    if pad:
        for m in vit.modules():
            if isinstance(m, MultiHeadSelfAttention):
                m.valid_len = seq_len
    return pad


def seq_parallel_model(vit: ViT, mesh: Mesh | None) -> ViT:
    """Cut ``vit``'s token stream over ``mesh``'s ``seq`` axis, in place
    (as ``shard_params`` lays the weights out in place), and return it.

    The parameters, their names and the checkpoint layout stay the
    one-device model's; the stream is padded (``pad_stream``) and each
    module that reads the token dim takes the axis."""
    if not isinstance(vit, ViT):
        raise ValueError(
            "sequence parallelism covers the ViT trunk (models/vit.ViT); "
            f"got {type(vit).__name__}. CNN models have no token stream to "
            "shard — run them on a data-only mesh.")
    if not has_seq_axis(mesh):
        raise ValueError("mesh has no 'seq' axis > 1")
    mixer = type(vit.enc0.mixer)
    if mixer is not MultiHeadSelfAttention:
        raise ValueError(
            "sequence parallelism is scoped to the MultiHeadSelfAttention "
            f"mixer (model 'vit'); mixer {mixer.__name__} mixes over the "
            "token dim without a pad mask and would silently mis-train on "
            "a padded stream. Run it on a data/model mesh.")
    seq_len = vit.patch ** 2 + (1 if vit.is_cls_token else 0)
    S = mesh.shape["seq"]
    if seq_len % S and vit.mlp_factory is not None:
        raise ValueError(
            "sequence parallelism needs pad tokens here (T="
            f"{seq_len} does not divide the seq axis {S}) and the MoE "
            "mlp_factory routes pad tokens through the Switch router, "
            "silently stealing per-example expert capacity from real "
            "tokens. Use a seq axis that divides T, or scale MoE over an "
            "'expert' mesh axis instead.")
    pad_stream(vit, S)
    axis = mesh.axis("seq")
    for m in vit.modules():
        if hasattr(type(m), "seq_axis"):
            m.seq_axis = axis
    return vit

