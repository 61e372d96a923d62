"""Autoencoder attention, as ``vit_cifar_tpu/ops/ae_attention.py``.

Reference: layers.py:813-907 (AEAttention), layers.py:910-1086
(AEAttentionHeads), layers.py:1199-1257 (BaselineAEAttention), with the AE
type dispatch at layers.py:1089-1196.

  * lift x with U + GELU; z = LayerNorm(x or its chunk half, detached),
    taken to f32;
  * the AE (built in f32) reconstructs z; its input, hidden activity and
    output stay on the module as ``ae_input``, ``ae_hidden`` and
    ``ae_output`` (the reference's attributes, layers.py:858-860) for the
    ``aece`` criterion and the unsupervised AE steps;
  * the score between tokens i and j is <AE(masked row), z_j>, where the
    masked row keeps only token j (zeros or random fill);
  * the softmax is detached (layers.py:882-884), except in the baseline;
  * x is mixed with the map, cast to the compute dtype, and projected
    with V.

The detached scores are computed under ``torch.no_grad``: nothing of them
reaches a gradient, so no activation of the masked path is kept.  As in
the JAX package, ``ae_type="simple"`` with the zeros mask takes the
structured path (two O(B*T*F) terms and one AE call on a zero vector in
place of the (B,T,T,F) eye-masked tensor), and ``AEAttentionHeads`` with
the zeros mask builds the eye-masked rows ``mask_chunk`` at a time.

With ``--use-nnmf-layers`` the AEs are built from NNMF layers: each
DenseBlock is an ``NNMFLinear``, and the heads AE is one ``AutoNNMFLayer``
over (B, 1, heads*T, F/heads), always trainable, whose code
(``hidden_activity``) is kept as ``ae_hidden``; its masked rows take the
reference's W.W^T shortcut (layers.py:1026-1029) in place of AE calls.

``mask_type="random"`` fills the masked entries with N(mean(z), std(z))
noise.  The standard-normal draw comes from the step's generator; without
one (the eval step) from a generator seeded 0 on z's device, where JAX
falls back to ``PRNGKey(0)``; that draw is the operator ``seeded_draw``
(``ops/cuda/registry.py``), so that the eval path exports.  A test may set ``mask_noise`` to hand the
module JAX's draw.

Under a model axis U is column-parallel and V row-parallel: each rank
gathers U's output, runs the rest whole, and keeps its own columns for V.
Under a data axis the random fill is drawn for the global batch and scaled
by the global batch's mean and standard deviation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import (Axis, copy_to, gather_from, local_draw,
                                    scatter_to)
from .autoencoders import (Autoencoder, Autoencoder2D, AutoencoderH,
                           AutoencoderT, NNMFParams)
from .common import LayerNorm
from .cuda.registry import seeded_draw
from .init import Linear
from .nnmf.layers import AutoNNMFLayer


def build_ae(*, ae_type: str, seq_len: int, ffn_features: int, heads: int = 1,
             chunk: bool = False, legacy_heads: bool = False,
             ae_hidden_features: int = 128, ae_hidden_seq_len: int = 8,
             order_2d: str = "sfsf", nnmf: bool = False,
             nnmf_params: NNMFParams = NNMFParams(),
             generator: torch.Generator, device=None) -> nn.Module:
    """The AE of ``ae_type`` (layers.py:1113-1196), in f32."""
    width = ffn_features // 2 if chunk else ffn_features
    kw = dict(nnmf=nnmf, nnmf_params=nnmf_params, generator=generator,
              device=device)
    if ae_type == "simple":
        return Autoencoder(width, ae_hidden_features, **kw)
    if ae_type == "transpose":
        return AutoencoderT(seq_len, ae_hidden_seq_len, **kw)
    if ae_type == "heads":
        if legacy_heads:
            return AutoencoderH(seq_len * heads, ae_hidden_features, heads,
                                **kw)
        if nnmf:
            return AutoNNMFLayer(
                1, ae_hidden_seq_len, (seq_len * heads, width // heads),
                (seq_len * heads, 1), nnmf_params.number_of_iterations,
                local_learning=nnmf_params.local_learning, w_trainable=True,
                disable_scale_grade=False, generator=generator, device=device)
        return AutoencoderT(seq_len * heads, ae_hidden_seq_len, **kw)
    if ae_type == "2d":
        return Autoencoder2D(order_2d, seq_len, width, ae_hidden_seq_len,
                             ae_hidden_features, **kw)
    raise NotImplementedError(f"AE type {ae_type} not implemented")


def _eye_mask(z: torch.Tensor, mask_type: str,
              noise: torch.Tensor | None = None,
              data: Axis | None = None) -> torch.Tensor:
    """The (B,T,T,F) masked tensor (layers.py:862-873): row i keeps token
    i of z; the rest is zeros, or ``noise`` (standard normal, (B,T,T,F))
    scaled to z's mean and standard deviation, over the global batch
    under a data axis."""
    B, T, F_ = z.shape
    rep = z[:, None].expand(B, T, T, F_)
    eye = torch.eye(T, dtype=z.dtype, device=z.device)[None, :, :, None]
    if mask_type == "zeros":
        return eye * rep
    if data is None:
        std, mean = z.std(correction=0), z.mean()
    else:
        n = z.numel() * data.size
        mean = data.all_reduce_(z.sum()) / n
        std = torch.sqrt(data.all_reduce_((z - mean).square().sum()) / n)
    return eye * rep + (1.0 - eye) * (noise * std + mean)


def _lift(mixer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """gelu(U(x)), whole on every rank under a model axis."""
    tp = mixer.tp_axis
    if tp is None:
        return F.gelu(mixer.U(x))
    return gather_from(F.gelu(mixer.U(copy_to(x, tp))), tp)


def _project(mixer: nn.Module, attn: torch.Tensor) -> torch.Tensor:
    """V of the mixed features, row-parallel under a model axis."""
    tp = mixer.tp_axis
    if tp is not None:
        attn = scatter_to(attn, tp)
    return mixer.V(attn, reduce_over=tp)


class _AEMixer(nn.Module):
    """What the AE mixers share: the random fill's draw and the
    intermediates they keep."""

    TP_LAYOUT = {"U": "col", "V": "row"}
    data_axis: Axis | None = None
    tp_axis: Axis | None = None
    mask_noise: torch.Tensor | None = None
    ae_input = ae_output = ae_hidden = None

    def _noise(self, shape, like: torch.Tensor,
               generator: torch.Generator | None) -> torch.Tensor:
        """The (B,T,T,F) standard-normal fill on ``like``'s device, drawn
        for the global batch under a data axis."""
        if self.mask_noise is not None:
            return self.mask_noise.to(like.device)
        if generator is None:  # the eval step: an exportable seed-0 draw
            draw = lambda s: seeded_draw(like, s, "normal")  # noqa: E731
        else:
            draw = lambda s: torch.randn(  # noqa: E731
                s, generator=generator, device=like.device)
        return local_draw(draw, shape, ((0, self.data_axis),))


class AEAttention(_AEMixer):
    """layers.py:813-907: simple, transpose, 2d and legacy-heads AE
    attention."""

    def __init__(self, features: int, seq_len: int, ffn_features: int,
                 head: int = 1, ae_type: str = "simple",
                 ae_hidden_features: int = 128, ae_hidden_seq_len: int = 8,
                 order_2d: str = "sfsf", mask_type: str = "zeros",
                 chunk: bool = False, legacy_heads: bool = False,
                 use_nnmf_layers: bool = False,
                 nnmf_params: NNMFParams = NNMFParams(),
                 save_attn_map: bool = False, *, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if mask_type not in ("zeros", "random"):
            raise ValueError(f"mask_type={mask_type!r}")
        self.ae_type, self.mask_type, self.chunk = ae_type, mask_type, chunk
        self.save_attn_map, self.dtype = save_attn_map, dtype
        self.attn_map: torch.Tensor | None = None
        width = ffn_features // 2 if chunk else ffn_features
        lin = dict(generator=generator, dtype=dtype, device=device)
        self.U = Linear(features, ffn_features, **lin)
        self.norm1 = LayerNorm(width, dtype=dtype, device=device)
        self.AE = build_ae(
            ae_type=ae_type, seq_len=seq_len, ffn_features=ffn_features,
            heads=head, chunk=chunk, legacy_heads=legacy_heads,
            ae_hidden_features=ae_hidden_features,
            ae_hidden_seq_len=ae_hidden_seq_len, order_2d=order_2d,
            nnmf=use_nnmf_layers, nnmf_params=nnmf_params,
            generator=generator, device=device)
        self.V = Linear(width, features, **lin)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: torch.Generator | None = None):
        h = _lift(self, x)
        x1, z = h.chunk(2, dim=-1) if self.chunk else (h, h)
        z = self.norm1(z.detach()).to(torch.float32)
        ae_out, ae_hidden = self.AE(z)
        self.ae_input, self.ae_output, self.ae_hidden = z, ae_out, ae_hidden
        with torch.no_grad():
            T = z.shape[1]
            if self.ae_type == "simple" and self.mask_type == "zeros":
                # the structured equivalent of the (B,T,T,F) eye mask: row
                # j of the AE acts on z_j alone, so
                # dist[b,i,j] = <AE(z_j), z_j> if i == j else <AE(0), z_j>
                diag = torch.sum(ae_out * z, dim=-1)
                ae0 = self.AE(z.new_zeros(1, 1, z.shape[-1]))[0]
                off = z @ ae0[0, 0]
                eye = torch.eye(T, dtype=z.dtype, device=z.device)
                dist = off[:, None, :] + eye[None] * (diag - off)[:, None, :]
            else:
                noise = None if self.mask_type == "zeros" else self._noise(
                    (z.shape[0], T, T, z.shape[-1]), z, generator)
                preds = self.AE(_eye_mask(z, self.mask_type, noise,
                                          self.data_axis))[0]
                dist = torch.sum(preds * z[:, None], dim=-1)  # (B,T,T)
            attn_map = torch.softmax(dist, dim=-1)
        if self.save_attn_map:
            self.attn_map = attn_map
        attn = torch.einsum("bij,bjf->bif", attn_map.to(self.dtype), x1)
        return _project(self, attn)


class AEAttentionHeads(_AEMixer):
    """layers.py:910-1086: multi-head AE attention, the ``ae`` model's
    mixer for ``ae_type="heads"`` without ``--legacy-heads``.

    ``mask_chunk`` rows of the eye-masked tensor are built and consumed at
    a time (the zeros mask); 0, or the random mask, materializes the whole
    (B,T,heads*T,F/heads) tensor.
    """

    def __init__(self, features: int, seq_len: int, ffn_features: int,
                 heads: int = 1, ae_hidden_seq_len: int = 8,
                 mask_type: str = "zeros", chunk: bool = False,
                 use_nnmf_layers: bool = False,
                 nnmf_params: NNMFParams = NNMFParams(),
                 save_attn_map: bool = False, mask_chunk: int = 16, *,
                 generator: torch.Generator,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if mask_type not in ("zeros", "random"):
            raise ValueError(f"mask_type={mask_type!r}")
        self.nnmf = use_nnmf_layers
        self.heads, self.mask_type, self.chunk = heads, mask_type, chunk
        self.mask_chunk = mask_chunk
        self.save_attn_map, self.dtype = save_attn_map, dtype
        self.attn_map: torch.Tensor | None = None
        width = ffn_features // 2 if chunk else ffn_features
        lin = dict(generator=generator, dtype=dtype, device=device)
        self.U = Linear(features, ffn_features, **lin)
        self.norm1 = LayerNorm(width, dtype=dtype, device=device)
        self.AE = build_ae(
            ae_type="heads", seq_len=seq_len, ffn_features=ffn_features,
            heads=heads, chunk=chunk, ae_hidden_seq_len=ae_hidden_seq_len,
            nnmf=use_nnmf_layers, nnmf_params=nnmf_params,
            generator=generator, device=device)
        self.V = Linear(width, features, **lin)

    def _to_heads(self, x: torch.Tensor) -> torch.Tensor:
        """[..., T, F] -> [..., heads, T, F/heads] (layers.py:1054-1061)."""
        y = x.reshape(*x.shape[:-1], self.heads, x.shape[-1] // self.heads)
        return y.transpose(-2, -3)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: torch.Generator | None = None):
        h = _lift(self, x)
        if self.chunk:
            x1, z = h.chunk(2, dim=-1)
            z = self.norm1(z.detach())
        else:
            # the reference normalizes x itself and takes z as its
            # detached copy (layers.py:989-992)
            x1 = self.norm1(h)
            z = x1.detach()
        z = z.to(torch.float32)
        B, T, width = z.shape
        Fh, S = width // self.heads, self.heads * T
        x_heads, z_heads = self._to_heads(x1), self._to_heads(z)
        ae_input = z_heads.reshape(B, S, Fh)
        if self.nnmf:
            ae_input = ae_input[:, None]  # (B, 1, h*T, F/h)
            ae_out = self.AE(ae_input)
            ae_hidden = self.AE.hidden_activity
            w = self.AE.nnmf_weights.detach()
            wwt = w @ w.T
            # the W.W^T shortcut over the masked rows (layers.py:1026-1029)
            preds_of = lambda zm: torch.einsum(  # noqa: E731
                "cd,bidf->bicf", wwt, zm)
        else:
            ae_out, ae_hidden = self.AE(ae_input)
            preds_of = lambda zm: self.AE(zm)[0]  # noqa: E731
        self.ae_input, self.ae_output, self.ae_hidden = (ae_input, ae_out,
                                                         ae_hidden)
        with torch.no_grad():
            if self.mask_type == "zeros" and self.mask_chunk > 0:
                # masked row i keeps only token i: a chunk of rows is
                # eye[rows, j] * z_heads, consumed at once
                col = torch.arange(T, device=z.device)
                parts = []
                for r0 in range(0, T, self.mask_chunk):
                    rows = torch.arange(r0, min(r0 + self.mask_chunk, T),
                                        device=z.device)
                    eye_c = (rows[:, None] == col[None, :]).to(z.dtype)
                    # (B, c, heads, T, F/h)
                    zm = eye_c[None, :, None, :, None] * z_heads[:, None]
                    preds = preds_of(zm.reshape(B, len(rows), S, Fh))
                    preds = preds.reshape(zm.shape)
                    parts.append(torch.sum(preds * z_heads[:, None], dim=-1))
                dist = torch.cat(parts, dim=1)  # (B,T,h,T)
            else:
                noise = None if self.mask_type == "zeros" else self._noise(
                    (B, T, T, width), z, generator)
                zm = self._to_heads(_eye_mask(z, self.mask_type, noise,
                                              self.data_axis))
                preds = preds_of(zm.reshape(B, T, S, Fh)).reshape(zm.shape)
                dist = torch.sum(preds * z_heads[:, None], dim=-1)
            attn_map = torch.softmax(dist.transpose(1, 2), dim=-1)
        if self.save_attn_map:
            self.attn_map = attn_map
        attn = torch.einsum("bhij,bhjf->bihf", attn_map.to(self.dtype),
                            x_heads).reshape(B, T, width)
        return _project(self, attn)


class BaselineAEAttention(nn.Module):
    """layers.py:1199-1257: AE attention over the chunk half z2 with its
    softmax NOT detached, the working equivalent the JAX package gives of
    the reference's model, which crashes as shipped."""

    TP_LAYOUT = {"U": "col", "V": "row"}
    tp_axis: Axis | None = None

    def __init__(self, features: int, seq_len: int, ffn_features: int,
                 ae_hidden_features: int = 128, save_attn_map: bool = False,
                 *, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if ffn_features % 2:
            raise ValueError(f"ffn_features={ffn_features} is odd")
        self.save_attn_map, self.dtype = save_attn_map, dtype
        self.attn_map: torch.Tensor | None = None
        half = ffn_features // 2
        lin = dict(generator=generator, dtype=dtype, device=device)
        self.U = Linear(features, ffn_features, **lin)
        self.norm1 = LayerNorm(half, dtype=dtype, device=device)
        self.AE = Autoencoder(half, ae_hidden_features, generator=generator,
                              device=device)
        self.norm2 = LayerNorm(half, device=device)
        self.V = Linear(half, features, **lin)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: torch.Generator | None = None):
        z1, z2 = _lift(self, x).chunk(2, dim=-1)
        z2 = self.norm1(z2).to(torch.float32)
        # no detach (the "baseline" difference); the structured path, since
        # the AE acts on the feature dim
        ae_out = self.AE(z2)[0]
        ae0 = self.norm2(self.AE(z2.new_zeros(1, 1, z2.shape[-1]))[0])
        diag = torch.sum(self.norm2(ae_out) * z2, dim=-1)
        off = z2 @ ae0[0, 0]
        T = z2.shape[1]
        eye = torch.eye(T, dtype=z2.dtype, device=z2.device)
        dist = off[:, None, :] + eye[None] * (diag - off)[:, None, :]
        attn_map = torch.softmax(dist, dim=-1)
        if self.save_attn_map:
            self.attn_map = attn_map
        attn = torch.einsum("bij,bjf->bif", attn_map.to(self.dtype), z1)
        return _project(self, attn)
