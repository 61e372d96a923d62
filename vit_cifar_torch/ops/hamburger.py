"""Hamburger, as ``vit_cifar_tpu/ops/hamburger.py``: the matrix
decomposition, the bread and the burger assemblies, and the two token
mixers built of them.

Reference: hamburger/ham.py (the decomposition), hamburger/burger.py (V1,
V2, V2+), hamburger/bread.py (ConvBNReLU), layers.py:243-300 (``Hamburger``
and ``HamburgerAttention``).

``MatrixDecomposition2D`` takes (B, H, W, C) NHWC inputs:

  * ``train_steps`` (training) or ``eval_steps`` multiplicative-update
    iterations run without gradients (ham.py:47-57), then ONE
    gradient-tracked ``compute_coef`` step (ham.py:85-88), and the
    reconstruction bases @ coef^T;
  * NMF: uniform bases, inv_t = 1, eta = 0.1 (ham.py:215-255); VQ: cosine
    similarity (ham.py:115-163); CD: the intended ridge-regression solve,
    where the reference's ``compute_coef`` has a NameError (ham.py:206);
  * ``rand_init``: fresh bases every call.  The draw comes from the step's
    generator; without one (the eval step) from a generator seeded 0 on the
    input's device, where JAX falls back to ``PRNGKey(0)``, through the
    operator ``seeded_draw`` (``ops/cuda/registry.py``) so that the eval
    path exports.  A test may set
    ``bases_draw`` to hand the module JAX's draw (before the L2 norm);
  * otherwise (``--train-md-bases``) the bases persist as the buffer
    ``bases`` (S, D, R), the counterpart of JAX's ``state`` collection:
    in training mode its EMA with the batch's mean bases (ham.py:75-83,
    102-112) is written in place, without gradients.  The train step's
    non-finite guard does not roll it back, as JAX's does not.

The math runs in f32 whatever the compute dtype; the output is cast back.

The burgers (burger.py:17-206) run on NHWC: 1x1 convolutions with the
He-normal init of fan kh*kw*OUT (biases zero, flax's default), BatchNorm
with the reference's momentum 3e-4 (flax 1 - 3e-4) and torch's running
statistics (``ops/norm.py``), an NMF ham with MD_D = 512, and 6 train /
7 eval steps (the factory never sets the JAX module's ``ham_type`` or
``md_iter``, so neither is an option here).  V2+ runs two hams over a
channel split, both ``spatial = not depthwise`` as shipped (the reference
assigns SPATIAL per ham but the base reads only DEPTHWISE), with
``coef_shortcut`` = 1 and ``coef_ham`` = 0.  ``--burger-mode Gated``
KeyErrors in the reference; it raises ``NotImplementedError`` here.
``Hamburger`` implements the reference's intended semantics where its
wrapper crashes: the (B, T, F) tokens become the NHWC image (B, F, 1, T),
so ``in_c`` = seq_len.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import Axis, copy_to, local_draw, scatter_to
from .common import dropout
from .cuda.registry import seeded_draw
from .init import Linear, NHWCConv, he_conv_init
from .norm import TorchBatchNorm


def _l2_normalize(x: torch.Tensor, dim: int, eps: float = 1e-12):
    """torch F.normalize: x / max(||x||, eps)."""
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(n, min=eps)


def _nmf_local_step(x, bases, coef):
    """ham.py:231-247: multiplicative updates."""
    numerator = torch.einsum("bdn,bdr->bnr", x, bases)
    denominator = coef @ torch.einsum("bdr,bds->brs", bases, bases)
    coef = coef * numerator / (denominator + 1e-6)
    numerator = x @ coef
    denominator = bases @ torch.einsum("bnr,bns->brs", coef, coef)
    bases = bases * numerator / (denominator + 1e-6)
    return bases, coef


def _nmf_compute_coef(x, bases, coef):
    numerator = torch.einsum("bdn,bdr->bnr", x, bases)
    denominator = coef @ torch.einsum("bdr,bds->brs", bases, bases)
    return coef * numerator / (denominator + 1e-6)


def _vq_local_step(inv_t, x, bases, coef):
    """ham.py:126-145: cosine-similarity VQ."""
    std_x = _l2_normalize(x, 1)
    std_bases = _l2_normalize(bases, 1, eps=1e-6)
    coef = torch.einsum("bdn,bdr->bnr", std_x, std_bases)
    coef = torch.softmax(inv_t * coef, dim=-1)
    coef = coef / (1e-6 + coef.sum(dim=1, keepdim=True))
    return x @ coef, coef


def _vq_compute_coef(inv_t, x, bases, coef):
    x_norm = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    std_x = x / (1e-6 + x_norm.detach())
    std_bases = _l2_normalize(bases, 1, eps=1e-6)
    c = torch.einsum("bdn,bdr->bnr", std_x, std_bases)
    return torch.softmax(inv_t * c, dim=-1)


def _cd_local_step(inv_t, x, bases, coef):
    """ham.py:176-199."""
    std_x = _l2_normalize(x, 1)
    coef = torch.einsum("bdn,bdr->bnr", std_x, bases)
    coef = torch.softmax(inv_t * coef, dim=-1)
    coef = coef / (1e-6 + coef.sum(dim=1, keepdim=True))
    bases = _l2_normalize(x @ coef, 1, eps=1e-6)
    return bases, coef


def _cd_compute_coef(beta, R, x, bases, coef):
    """The intended semantics of ham.py:201-211."""
    gram = torch.einsum("bdr,bds->brs", bases, bases)
    temp = torch.linalg.inv(
        gram + beta * torch.eye(R, dtype=x.dtype, device=x.device))
    return torch.einsum("bdn,bdr,brs->bns", x, bases, temp)


class MatrixDecomposition2D(nn.Module):
    """_MatrixDecomposition2DBase (ham.py:14-112) on (B, H, W, C) inputs.

    ``dim`` is the D of the bases the input gives: C // S when
    ``spatial``, else H*W; the persistent bases are built from it.  Under a
    data axis the random bases are drawn for the global batch and the EMA
    takes the global batch's mean.
    """

    data_axis: Axis | None = None

    def __init__(self, dim: int, ham_type: str = "NMF", spatial: bool = True,
                 S: int = 1, R: int = 64, train_steps: int = 6,
                 eval_steps: int = 7, inv_t: float = 100.0, eta: float = 0.9,
                 beta: float = 0.1, rand_init: bool = True, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        if ham_type not in ("NMF", "VQ", "CD"):
            raise NotImplementedError(f"ham type {ham_type}")
        self.dim, self.ham_type, self.spatial = dim, ham_type, spatial
        self.S, self.R = S, R
        self.train_steps, self.eval_steps = train_steps, eval_steps
        self.inv_t = 1.0 if ham_type == "NMF" else inv_t
        self.eta = 0.1 if ham_type == "NMF" else eta
        self.rand_init = rand_init
        self.local_step = {
            "NMF": _nmf_local_step,
            "VQ": functools.partial(_vq_local_step, self.inv_t),
            "CD": functools.partial(_cd_local_step, self.inv_t)}[ham_type]
        self.compute_coef = {
            "NMF": _nmf_compute_coef,
            "VQ": functools.partial(_vq_compute_coef, self.inv_t),
            "CD": functools.partial(_cd_compute_coef, beta, R)}[ham_type]
        self.bases_draw: torch.Tensor | None = None
        if not rand_init:
            self.register_buffer("bases", _l2_normalize(
                self._draw((S, dim, R), generator, None), 1).to(device))

    def _draw(self, shape, generator, device) -> torch.Tensor:
        if self.ham_type == "NMF":
            return torch.rand(shape, generator=generator, device=device)
        return torch.randn(shape, generator=generator, device=device)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        B, H, W, C = x.shape
        orig_dtype = x.dtype
        xc = x.to(torch.float32).reshape(B, H * W, C).transpose(1, 2)
        if self.spatial:
            D, N = C // self.S, H * W
            xm = xc.reshape(B * self.S, D, N)
        else:
            D, N = H * W, C // self.S
            xm = xc.reshape(B * self.S, N, D).transpose(1, 2)
        if D != self.dim:
            raise ValueError(f"bases of dim {self.dim} for an input that "
                             f"gives {D}")

        if self.rand_init:
            shape = (B * self.S, D, self.R)
            rows = ((0, self.data_axis),)
            if self.bases_draw is not None:
                draw = self.bases_draw.to(x.device)
            elif generator is None:  # the eval step: an exportable draw
                kind = "uniform" if self.ham_type == "NMF" else "normal"
                draw = local_draw(lambda s: seeded_draw(x, s, kind), shape,
                                  rows)
            else:
                draw = local_draw(
                    lambda s: self._draw(s, generator, x.device), shape, rows)
            bases = _l2_normalize(draw, 1)
        else:
            bases = self.bases.repeat(B, 1, 1)

        steps = self.eval_steps if deterministic else self.train_steps
        with torch.no_grad():
            xs = xm.detach()
            coef = torch.softmax(
                self.inv_t * torch.einsum("bdn,bdr->bnr", xs, bases), dim=-1)
            for _ in range(steps):
                bases, coef = self.local_step(xs, bases, coef)

        # the one gradient-tracked step (ham.py:85-88)
        coef = self.compute_coef(xm, bases, coef)
        recon = torch.einsum("bdr,bnr->bdn", bases, coef)
        if self.spatial:
            rc = recon.reshape(B, C, H * W)
        else:
            rc = recon.transpose(1, 2).reshape(B, C, H * W)
        out = rc.transpose(1, 2).reshape(B, H, W, C).to(orig_dtype)

        if not self.rand_init and not deterministic:
            with torch.no_grad():  # the EMA of the bases (ham.py:102-112)
                b = bases.reshape(B, self.S, D, self.R).sum(dim=0)
                if self.data_axis is not None:  # the global batch's mean
                    self.data_axis.all_reduce_(b)
                    B *= self.data_axis.size
                b = b / B
                new = self.bases + self.eta * (b - self.bases)
                self.bases.copy_(_l2_normalize(new, 1))
        return out


# -- the bread and the burgers ---------------------------------------------


class _HeConv1x1(nn.Module):
    """A 1x1 convolution with the burger's He-normal init; its flax
    ``nn.Conv`` is the child ``conv``."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 *, generator: torch.Generator, dtype: torch.dtype,
                 device=None):
        super().__init__()
        weight = he_conv_init((features, in_features, 1, 1), generator)
        bias = torch.zeros(features, device=device) if use_bias else None
        self.conv = NHWCConv(weight.to(device), bias, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class _BN(nn.Module):
    """bread.py's norm layer: SyncBN(momentum=3e-4), flax momentum
    1 - 3e-4, as the child ``TorchBatchNorm_0`` (flax's automatic name)."""

    def __init__(self, features: int, *, dtype: torch.dtype, device=None):
        super().__init__()
        self.TorchBatchNorm_0 = TorchBatchNorm(
            features, momentum=1.0 - 3e-4, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, *,
                deterministic: bool = True) -> torch.Tensor:
        return self.TorchBatchNorm_0(x, deterministic=deterministic)


class ConvBNReLU(nn.Module):
    """bread.py:17-50: a 1x1 conv without bias, BN, ReLU."""

    def __init__(self, in_features: int, features: int, *,
                 generator: torch.Generator, dtype: torch.dtype, device=None):
        super().__init__()
        self.c = _HeConv1x1(in_features, features, use_bias=False,
                            generator=generator, dtype=dtype, device=device)
        self.bn = _BN(features, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, *,
                deterministic: bool = True) -> torch.Tensor:
        return F.relu(self.bn(self.c(x), deterministic=deterministic))


class HamburgerBurger(nn.Module):
    """The V1/V2/V2+ assemblies (burger.py:17-206) on (B, H, W, in_c)
    NHWC inputs with ``H * W == spatial_size``."""

    MD_D = 512  # the JAX module's default, which no caller changes

    def __init__(self, in_c: int, version: str = "V1", spatial: bool = True,
                 rand_init: bool = True, *,
                 spatial_size: int, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if version not in ("V1", "V2", "V2+"):
            raise NotImplementedError(
                f"--burger-mode {version!r}: the reference CLI offers "
                "'Gated' but its dispatch KeyErrors (main.py:135 vs "
                "burger.py:209-217)")
        self.version = version
        MD_D = self.MD_D
        kw = dict(generator=generator, dtype=dtype, device=device)
        md = functools.partial(
            MatrixDecomposition2D, MD_D if spatial else spatial_size, "NMF",
            spatial=spatial, train_steps=6, eval_steps=7,
            rand_init=rand_init, generator=generator, device=device)
        if version in ("V1", "V2"):
            self.lower_bread = _HeConv1x1(in_c, MD_D, **kw)
            self.ham = md()
            if version == "V1":
                self.upper_bread = _HeConv1x1(MD_D, in_c, use_bias=False,
                                              **kw)
                self.upper_bn = _BN(in_c, dtype=dtype, device=device)
            else:
                self.cheese = ConvBNReLU(MD_D, MD_D, **kw)
                self.upper_bread = _HeConv1x1(MD_D, in_c, use_bias=False,
                                              **kw)
            return
        C = 2 * MD_D  # V2+: two hams over a channel split
        self.lower_bread = _HeConv1x1(in_c, C, **kw)
        self.ham_1, self.ham_2 = md(), md()
        # CHEESE_FACTOR = S (1), doubled for the dual ham (burger.py:148-151)
        self.cheese = ConvBNReLU(C, C // 2, **kw)
        self.upper_bread = _HeConv1x1(C // 2, in_c, use_bias=False, **kw)
        self.coef_shortcut = nn.Parameter(torch.ones(1, device=device))
        self.coef_ham = nn.Parameter(torch.zeros(1, device=device))  # ZERO_HAM

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        kw = dict(deterministic=deterministic, generator=generator)
        shortcut = x
        x = F.relu(self.lower_bread(x))  # NMF wants a nonnegative input
        if self.version == "V2+":
            x1, x2 = x.chunk(2, dim=-1)
            x = torch.cat([self.ham_1(x1, **kw), self.ham_2(x2, **kw)], -1)
            x = self.cheese(x, deterministic=deterministic)
            x = self.upper_bread(x)
            # f32 coefficients: the sum is f32, as in JAX
            return F.relu(self.coef_ham * x + self.coef_shortcut * shortcut)
        x = self.ham(x, **kw)
        if self.version == "V1":
            x = self.upper_bn(self.upper_bread(x),
                              deterministic=deterministic)
        else:
            x = self.upper_bread(self.cheese(x, deterministic=deterministic))
        return F.relu(x + shortcut)


class Hamburger(nn.Module):
    """The token mixer of layers.py:243-260: the burger over the token
    dimension, the (B, T, F) sequence viewed as the NHWC image
    (B, F, 1, T)."""

    def __init__(self, seq_len: int, features: int, burger_mode: str = "V1",
                 depthwise: bool = False, rand_init: bool = True, *,
                 generator: torch.Generator,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.burger = HamburgerBurger(
            seq_len, burger_mode, spatial=not depthwise, rand_init=rand_init,
            spatial_size=features, generator=generator, dtype=dtype,
            device=device)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        img = x.transpose(1, 2)[:, :, None, :]  # (B, F, 1, T)
        out = self.burger(img, deterministic=deterministic,
                          generator=generator)
        return out[:, :, 0, :].transpose(1, 2)


class HamburgerAttention(nn.Module):
    """layers.py:263-300: AFT-Simple whose K is the burger's output, with
    the optional sigmoid gate ``Wq``.  Under a model axis Wv and Wq are
    column-parallel and out_project row-parallel; the burger runs whole on
    every rank, which keeps its softmax's columns."""

    TP_LAYOUT = {"Wq": "col", "Wv": "col", "out_project": "row"}
    data_axis: Axis | None = None
    tp_axis: Axis | None = None

    def __init__(self, seq_len: int, features: int, burger_mode: str = "V1",
                 depthwise: bool = False, rand_init: bool = True,
                 dropout: float = 0.0, query: bool = True, *,
                 generator: torch.Generator,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.rate, self.dtype = dropout, dtype
        lin = dict(generator=generator, dtype=dtype, device=device)
        self.Wv = Linear(features, features, **lin)
        self.hamburger = Hamburger(seq_len, features, burger_mode, depthwise,
                                   rand_init, **lin)
        self.Wq = Linear(features, features, **lin) if query else None
        self.out_project = Linear(features, features, **lin)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        tp = self.tp_axis
        xin = x if tp is None else copy_to(x, tp)
        v = self.Wv(xin)
        k = self.hamburger(x, deterministic=deterministic,
                           generator=generator)
        attn = torch.softmax(k.to(torch.float32), dim=1).to(self.dtype)
        if tp is not None:
            attn = scatter_to(attn, tp)
        y = torch.sum(attn * v, dim=1, keepdim=True)
        if self.Wq is not None:
            y = torch.sigmoid(self.Wq(xin)) * y
        return dropout(self.out_project(y, reduce_over=tp), self.rate,
                       deterministic, generator, ((0, self.data_axis),))
