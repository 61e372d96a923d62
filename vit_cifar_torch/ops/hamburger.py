"""Matrix decomposition, as ``vit_cifar_tpu/ops/hamburger.py``: only
``MatrixDecomposition2D`` (and its NMF, VQ and CD steps), which the
``gnnmf_ham`` mixer runs.

Reference: hamburger/ham.py.  The module takes (B, H, W, C) NHWC inputs:

  * ``train_steps`` (training) or ``eval_steps`` multiplicative-update
    iterations run without gradients (ham.py:47-57), then ONE
    gradient-tracked ``compute_coef`` step (ham.py:85-88), and the
    reconstruction bases @ coef^T;
  * NMF: uniform bases, inv_t = 1, eta = 0.1 (ham.py:215-255); VQ: cosine
    similarity (ham.py:115-163); CD: the intended ridge-regression solve,
    where the reference's ``compute_coef`` has a NameError (ham.py:206);
  * ``rand_init``: fresh bases every call.  The draw comes from the step's
    generator; without one (the eval step) from a generator seeded 0 on the
    input's device, where JAX falls back to ``PRNGKey(0)``.  A test may set
    ``bases_draw`` to hand the module JAX's draw (before the L2 norm);
  * otherwise (``--train-md-bases``) the bases persist as the buffer
    ``bases`` (S, D, R), the counterpart of JAX's ``state`` collection:
    in training mode its EMA with the batch's mean bases (ham.py:75-83,
    102-112) is written in place, without gradients.  The train step's
    non-finite guard does not roll it back, as JAX's does not.

The math runs in f32 whatever the compute dtype; the output is cast back.
``Hamburger``, ``HamburgerAttention`` and the burger assemblies come with
BatchNorm (ROADMAP queue 1, item 7).
"""

from __future__ import annotations

import functools

import torch
from torch import nn


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
    ``spatial``, else H*W; the persistent bases are built from it.
    """

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
            if self.bases_draw is not None:
                draw = self.bases_draw.to(x.device)
            else:
                if generator is None:
                    generator = torch.Generator(
                        device=x.device).manual_seed(0)
                draw = self._draw(shape, generator, x.device)
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
                b = bases.reshape(B, self.S, D, self.R).mean(dim=0)
                new = self.bases + self.eta * (b - self.bases)
                self.bases.copy_(_l2_normalize(new, 1))
        return out
