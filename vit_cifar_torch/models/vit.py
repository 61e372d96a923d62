"""The ViT trunk, as ``vit_cifar_tpu/models/vit.py``.

patchify (NHWC) -> ``emb`` -> cls token (broadcast, cast) -> + ``pos_emb``
-> ``enc0`` .. ``enc{L-1}`` -> cls token (or the token mean without one) ->
``fc_norm`` -> ``fc``.  Parameter names are the flax names, so carrying
weights across is a transpose and a rename (``utils/transplant.py``).

``pos_emb=False`` (reachable from the non-``vit`` models only) freezes the
embedding at zeros: there is no parameter and nothing is added (reference
vit.py:143-144).

``mlp_factory`` makes each block's MLP in place of the dense one (the MoE
MLP, ``ops/moe.py``).

``remat`` recomputes each encoder block in the backward
(``torch.utils.checkpoint``) instead of keeping its activations, as the JAX
package's ``nn.remat`` does.

``seq_pad`` appends that many zero tokens after ``pos_emb`` and slices them
off before pooling (JAX :84-85, :112-113); the mixer must mask them out of
its keys (``MultiHeadSelfAttention.valid_len``), as
``parallel/sequence.py`` arranges.  Two hooks take the place of JAX's
``act_constraint``, a GSPMD layout hint with no counterpart here; each is
set by its module of ``parallel/`` and is None otherwise:

  * ``seq_axis`` (``sequence.seq_parallel_model``): the padded stream is cut
    over the axis after the embedding, each rank runs the blocks on its
    tokens, and the pooled row is summed over the axis from the rank that
    holds it (the cls token) or from every rank's valid tokens (the mean);
  * ``pipeline`` (``pipeline.pipeline_model``): the encoder stack runs
    GPipe-style over the ``pipe`` axis wherever the pipeline takes the call
    (``Pipeline.takes``).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.common import EncoderBlock, LayerNorm
from ..ops.init import Linear, normal
from ..ops.patchify import to_words
from ..parallel.collectives import Axis, reduce_from


class ViT(nn.Module):
    seq_axis: Axis | None = None
    pipeline = None  # parallel.pipeline.Pipeline

    def __init__(self, mixer: Callable[[], nn.Module], num_classes: int = 10,
                 img_size: int = 32, patch: int = 8, num_layers: int = 7,
                 hidden: int = 384, mlp_hidden: int = 384,
                 dropout: float = 0.0, use_encoder_mlp: bool = True,
                 is_cls_token: bool = True, in_c: int = 3,
                 pos_emb: bool = True, *,
                 generator: torch.Generator,
                 dtype: torch.dtype = torch.float32, device=None,
                 remat: bool = False, seq_pad: int = 0, mlp_factory=None):
        super().__init__()
        self.patch, self.dtype, self.remat = patch, dtype, remat
        self.is_cls_token = is_cls_token
        self.num_layers, self.seq_pad = num_layers, seq_pad
        self.dropout, self.mlp_factory = dropout, mlp_factory
        ps = img_size // patch
        self.emb = Linear(ps * ps * in_c, hidden, generator=generator,
                          dtype=dtype, device=device)
        seq = patch * patch
        if is_cls_token:
            self.cls_token = nn.Parameter(
                normal((1, 1, hidden), generator).to(device))
            seq += 1
        self.pos_emb = nn.Parameter(normal((1, seq, hidden), generator).to(
            device)) if pos_emb else None
        for i in range(num_layers):
            self.add_module(f"enc{i}", EncoderBlock(
                hidden, mlp_hidden, mixer, use_encoder_mlp, dropout,
                generator=generator, dtype=dtype, device=device,
                mlp_factory=mlp_factory))
        self.fc_norm = LayerNorm(hidden, dtype=dtype, device=device)
        self.fc = Linear(hidden, num_classes, generator=generator,
                         dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: torch.Generator | None = None):
        """(B, H, W, C) images, already normalized -> (B, num_classes)
        logits in the compute dtype.  In training (``deterministic=False``)
        dropout draws from ``generator``."""
        out = self.embed(x)
        if self.pipeline is not None and self.pipeline.takes(deterministic):
            out = self.pipeline.run(self, out, deterministic)
        else:
            out = self.blocks(out, range(self.num_layers), deterministic,
                              generator)
        return self.head(out)

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """The token stream entering ``enc0``: patches -> ``emb`` -> cls ->
        + ``pos_emb`` -> pad; under ``seq_axis`` this rank's tokens."""
        out = self.emb(to_words(x.to(self.dtype), self.patch))
        if self.is_cls_token:
            cls = self.cls_token.to(self.dtype).expand(out.shape[0], 1, -1)
            out = torch.cat([cls, out], dim=1)
        if self.pos_emb is not None:
            out = out + self.pos_emb.to(self.dtype)
        if self.seq_pad:
            out = F.pad(out, (0, 0, 0, self.seq_pad))
        if self.seq_axis is not None:
            out = self.seq_axis.block(out, 1)
        return out

    def blocks(self, out: torch.Tensor, layers, deterministic: bool,
               generator: torch.Generator | None = None) -> torch.Tensor:
        """The encoder blocks ``layers`` (indices, in order) on ``out``."""
        for i in layers:
            block = getattr(self, f"enc{i}")
            if self.remat and torch.is_grad_enabled():
                out = _recomputed(block, out, deterministic, generator)
            else:
                out = block(out, deterministic=deterministic,
                            generator=generator)
        return out

    def head(self, out: torch.Tensor) -> torch.Tensor:
        """Pool the stream leaving the last block (the cls token, or the
        mean of the real tokens) -> ``fc_norm`` -> ``fc``."""
        if self.seq_axis is not None:
            out = self._pool_over_seq(out)
        elif self.is_cls_token:
            out = out[:, 0]
        else:
            out = out[:, :out.shape[1] - self.seq_pad].mean(dim=1)
        return self.fc(self.fc_norm(out))

    def _pool_over_seq(self, out: torch.Tensor) -> torch.Tensor:
        """The pooled row from this rank's tokens, summed over ``seq_axis``
        forward and passed through backward: every rank then holds it whole
        and its head's cotangent reaches each rank's own tokens once.  Each
        rank's pooled part reads its own stream, so that its blocks, whose
        backward holds the key/value gathers every rank takes part in, stay
        in its graph."""
        axis = self.seq_axis
        n_local = out.shape[1]
        if self.is_cls_token:  # the rank holding global token 0 gives it
            first = torch.tensor(axis.rank == 0, device=out.device)
            pooled = torch.where(first, out[:, 0], torch.zeros(
                (), dtype=out.dtype, device=out.device))
        else:
            seq_len = n_local * axis.size - self.seq_pad
            real = max(0, min(n_local, seq_len - axis.rank * n_local))
            pooled = out[:, :real].sum(dim=1) / seq_len
        return reduce_from(pooled, axis)


def _recomputed(block: nn.Module, x: torch.Tensor, deterministic: bool,
                generator: torch.Generator | None) -> torch.Tensor:
    """``block(x)`` under ``torch.utils.checkpoint``.  The recomputation in
    the backward redraws the block's dropout masks from ``generator``: it
    is rewound to where the forward found it, and left afterwards where
    the backward found it, so both passes see the same masks and the
    generator's stream is unchanged.  The block's buffers are treated the
    same way: the recomputation reads the values the forward read (which
    the forward may have updated, as the persistent bases' EMA does), and
    leaves the buffers as the backward found them."""
    start = None if generator is None else generator.get_state()
    read = [b.clone() for b in block.buffers()]
    first = [True]

    def run(x):
        if first[0]:
            first[0] = False
            return block(x, deterministic=deterministic, generator=generator)
        now = None if generator is None else generator.get_state()
        left = [b.clone() for b in block.buffers()]
        _load_buffers(block, read)
        if generator is not None:
            generator.set_state(start)
        try:
            return block(x, deterministic=deterministic, generator=generator)
        finally:
            if generator is not None:
                generator.set_state(now)
            _load_buffers(block, left)

    return checkpoint(run, x, use_reentrant=False)


@torch.no_grad()
def _load_buffers(block: nn.Module, values: list[torch.Tensor]) -> None:
    for b, v in zip(block.buffers(), values):
        b.copy_(v)
