"""The port's operators in ``torch.library``, namespace ``vit_cifar_torch``.

Each attention kernel is an operator with three implementations: a CUDA one
(the kernel's launch, with its checks and its launch count), a CPU one (its
plain PyTorch version) and a fake one that gives only the output shapes, so
that ``torch.export`` traces a model through the operator and the exported
graph names it.  The dispatcher picks the implementation by the tensors'
device, so there is no fallback between the kernel and its plain version.
The implementations are registered by ``attention.py`` and
``flash_attention.py``; importing ``vit_cifar_torch.ops.cuda`` registers
them all, which is all a process that serves an exported model needs of
this package.

``seeded_draw`` is the seed-0 draw that the eval path makes where it has no
generator (the AE attention's random mask, the hamburger's fresh bases): a
``torch.Generator`` made inside a model's forward cannot be exported, so the
draw happens inside this operator's body, on the device of its ``like``
tensor, and gives the same numbers as the eager code did.

=================  =====================================================
operator           schema
=================  =====================================================
``mhsa_fwd``       (q, k, v, scale) -> out (B, T, H, D)
``mhsa_fwd_lse``   (q, k, v, scale) -> (out, lse (B, H, T) f32)
``flash_fwd``      (q, k, v, scale) -> out
``flash_fwd_lse``  (q, k, v, scale) -> (out, lse)
``flash_bwd_dq``   (q, k, v, o, do, lse, scale) -> dq
``flash_bwd_dkv``  (q, k, v, o, do, lse, scale) -> (dk, dv)
``seeded_draw``    (like, shape, dist) -> f32 draw of ``shape``
=================  =====================================================
"""

from __future__ import annotations

import torch

NAMESPACE = "vit_cifar_torch"
LIB = torch.library.Library(NAMESPACE, "DEF")

_FWD = "(Tensor q, Tensor k, Tensor v, float scale)"
_BWD = ("(Tensor q, Tensor k, Tensor v, Tensor o, Tensor dout, Tensor lse, "
        "float scale)")
for _name, _schema in (
        ("mhsa_fwd", f"{_FWD} -> Tensor"),
        ("mhsa_fwd_lse", f"{_FWD} -> (Tensor, Tensor)"),
        ("flash_fwd", f"{_FWD} -> Tensor"),
        ("flash_fwd_lse", f"{_FWD} -> (Tensor, Tensor)"),
        ("flash_bwd_dq", f"{_BWD} -> Tensor"),
        ("flash_bwd_dkv", f"{_BWD} -> (Tensor, Tensor)"),
        ("seeded_draw", "(Tensor like, SymInt[] shape, str dist) -> Tensor")):
    LIB.define(_name + _schema)
del _name, _schema

# the wrappers call the operators through this name, so that a timing can
# put the CUDA implementations (``CUDA_IMPLS``) in the dispatcher's place
OPS = getattr(torch.ops, NAMESPACE)
CUDA_IMPLS: dict = {}


def register(name: str, *, cpu, cuda, fake) -> None:
    """Register operator ``name``'s CPU, CUDA and fake implementations."""
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=LIB)
    CUDA_IMPLS[name] = cuda


def fwd_fake(q, k, v, scale):
    B, H, T, D = q.shape
    return q.new_empty((B, T, H, D))


def fwd_lse_fake(q, k, v, scale):
    B, H, T, D = q.shape
    return q.new_empty((B, T, H, D)), q.new_empty((B, H, T),
                                                  dtype=torch.float32)


def _seeded_draw(like: torch.Tensor, shape, dist: str) -> torch.Tensor:
    """A standard-normal (``"normal"``) or uniform [0, 1) (``"uniform"``)
    f32 draw of ``shape`` from a generator seeded 0 on ``like``'s device."""
    generator = torch.Generator(device=like.device).manual_seed(0)
    draw = {"normal": torch.randn, "uniform": torch.rand}[dist]
    return draw(shape, generator=generator, device=like.device)


register("seeded_draw", cpu=_seeded_draw, cuda=_seeded_draw,
         fake=lambda like, shape, dist: like.new_empty(shape,
                                                      dtype=torch.float32))


def seeded_draw(like: torch.Tensor, shape, dist: str) -> torch.Tensor:
    """The seed-0 draw of ``shape`` on ``like``'s device, as an operator."""
    return OPS.seeded_draw(like.detach(), list(shape), dist)
