"""On-device AutoAugment, as ``vit_cifar_tpu/data/autoaugment.py``.

The 14 PIL ops of the reference's AutoAugment (the DeepVoltaire port), its
three policies (ImageNet, CIFAR10 with 24 active sub-policies, SVHN) and the
published magnitude grids, kept here as the port's own copy.  Each op takes a
batch (B, H, W, C) f32 in [0, 255], a per-image magnitude (B,) and a
per-image sign (B,) of +1 or -1, and returns the batch in f32.  The
semantics are the JAX package's, which holds them against PIL:

* invert, solarize, posterize, equalize (PIL's integer lut
  ``(step//2 + cumsum)//step``, with its identity cases), translate and the
  four enhance ops (PIL's L-mode luma, blend, sharpness leaving the 1-pixel
  border untouched) are exact;
* autocontrast truncates like PIL's ``int(ix*scale + offset)``;
* shear is PIL ``Image.transform``'s BICUBIC, the a = -1 cubic, sampled at
  ``x + m*(y + 0.5)`` with fill 128 outside, then ``floor(v + 0.5)``; the 20
  (magnitude x sign) variants of the published grid are tabled once per
  device and applied as four gathers (JAX applies them as a one-hot matrix
  product, so a sum can round one level apart at a tie);
* rotate is NEAREST, counter-clockwise, over gray 128, with no random sign.

The magnitude sign is randomized for exactly the ops the reference
randomizes: shear, translate, color, contrast, sharpness, brightness.

A sub-policy applies two (probability, op, magnitude) stages.  As JAX's
vmapped ``lax.switch`` computes every branch, each stage here computes every
op the policy uses once for the whole batch, stacks them and selects each
image's op with one gather; between the stages the batch is re-quantized to
``clip(round(x), 0, 255)``, as PIL holds uint8 between ops.

Random draws are split from the ops: ``autoaugment_draws`` draws from a
``torch.Generator``, ``apply_autoaugment`` is deterministic, so that tests
can hand it the JAX package's draws.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_FILL = 128.0


def _per_image(t: torch.Tensor) -> torch.Tensor:
    """A (B,) tensor broadcast against (B, H, W, C)."""
    return t[:, None, None, None]


# -- photometric ops --------------------------------------------------------

def _invert(img, mag, sign):
    return 255.0 - img


def _solarize(img, mag, sign):
    # PIL lut: i if i < threshold else 255 - i
    return torch.where(img < _per_image(mag), img, 255.0 - img)


def _posterize(img, mag, sign):
    s = _per_image(torch.exp2(8.0 - torch.round(mag)))
    return torch.floor(img / s) * s


def _equalize(img, mag, sign):
    """PIL ImageOps.equalize per image and channel, in integer arithmetic:
    a 256-bin histogram per (image, channel) by ``scatter_add_``, then
    lut = (step//2 + cumsum before the bin) // step, clipped, where
    step = (pixels - count of the last nonzero bin) // 255; the identity
    where at most one bin is nonzero or step is 0."""
    B, H, W, C = img.shape
    dev = img.device
    idx = img.to(torch.int64).permute(0, 3, 1, 2).reshape(B * C, H * W)
    bins = torch.arange(256, device=dev)
    offsets = idx + 256 * torch.arange(B * C, device=dev)[:, None]
    one = torch.ones(1, dtype=torch.int64, device=dev).expand(offsets.numel())
    hist = torch.zeros(B * C * 256, dtype=torch.int64, device=dev) \
        .scatter_add_(0, offsets.reshape(-1), one).view(B * C, 256)
    nonzero = hist > 0
    last = (nonzero * bins).amax(-1, keepdim=True)  # the last nonzero bin
    step = (H * W - hist.gather(-1, last)) // 255  # (B*C, 1)
    before = torch.cumsum(hist, -1) - hist
    lut = torch.clamp((step // 2 + before) // torch.clamp(step, min=1), 0, 255)
    identity = (nonzero.sum(-1, keepdim=True) <= 1) | (step == 0)
    lut = torch.where(identity, bins, lut)
    out = lut.gather(-1, idx).to(torch.float32)
    return out.view(B, C, H, W).permute(0, 2, 3, 1)


def _autocontrast(img, mag, sign):
    """PIL ImageOps.autocontrast (cutoff=0) per image and channel."""
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    scale = 255.0 / torch.clamp(hi - lo, min=1e-12)
    out = torch.clamp(torch.floor((img - lo) * scale), 0, 255)  # int()
    return torch.where(hi > lo, out, img)


def _luma(img):
    """PIL 'L' conversion: round(0.299 R + 0.587 G + 0.114 B), (B, H, W)."""
    return torch.round(img[..., 0] * 0.299 + img[..., 1] * 0.587
                       + img[..., 2] * 0.114)


def _blend(degenerate, img, factor):
    """Image.blend: degenerate + factor*(img - degenerate), rounded and
    clipped; ``factor`` is per image."""
    return torch.clamp(torch.round(
        degenerate + _per_image(factor) * (img - degenerate)), 0, 255)


def _brightness(img, mag, sign):
    # the blend with a black image: 0 + factor*(img - 0)
    return torch.clamp(torch.round(_per_image(1.0 + mag * sign) * img), 0,
                       255)


def _color(img, mag, sign):
    gray = _luma(img)[..., None].expand_as(img)
    return _blend(gray, img, 1.0 + mag * sign)


def _contrast(img, mag, sign):
    mean = torch.floor(_luma(img).mean(dim=(1, 2)) + 0.5)  # int(x + 0.5)
    return _blend(_per_image(mean), img, 1.0 + mag * sign)


def _sharpness(img, mag, sign):
    """ImageFilter.SMOOTH, [[1,1,1],[1,5,1],[1,1,1]]/13, rounded, on the
    interior; PIL leaves the 1-pixel border untouched.  The kernel's sum of
    integers is exact in f32 and n/13 is never within 1/26 of a tie, so the
    rounded result does not depend on the order of the sum."""
    rows = img[:, :-2] + img[:, 1:-1] + img[:, 2:]
    box = rows[:, :, :-2] + rows[:, :, 1:-1] + rows[:, :, 2:]
    smooth = torch.round((box + 4.0 * img[:, 1:-1, 1:-1]) / 13.0)
    degenerate = img.clone()
    degenerate[:, 1:-1, 1:-1] = smooth
    return _blend(degenerate, img, 1.0 + mag * sign)


# -- geometric ops ----------------------------------------------------------

def _cubic_weights(t: torch.Tensor) -> list[torch.Tensor]:
    """PIL ``Image.transform``'s BICUBIC kernel, the classic a = -1 cubic
    (not resize's a = -0.5), for taps -1..2 at fraction t in [0, 1)."""
    a = -1.0

    def k(x):
        x = torch.abs(x)
        near = (a + 2.0) * x**3 - (a + 3.0) * x**2 + 1.0
        far = a * (x**3 - 5.0 * x**2 + 8.0 * x - 4.0)
        return torch.where(x <= 1.0, near, torch.where(x < 2.0, far, 0.0))

    return [k(t + 1.0), k(t), k(t - 1.0), k(t - 2.0)]


@functools.cache
def _shear_tables(n_line: int, n_samp: int, device: str):
    """(weights (20, L, S, 4) f32, source indices (20, L, S, 4) int64, fill
    (20, L, S) bool) of a shear along the sample axis, source
    ``samp + m*(line + 0.5)``, for the published grid x both signs, ordered
    [+m0, -m0, +m1, -m1, ...].  Built in f32 on the CPU once per shape and
    device, then moved there: every image's variant is known before any
    image is seen."""
    m = torch.tensor([float(g) * s for g in _RANGES["shearX"]
                      for s in (1.0, -1.0)], dtype=torch.float32)
    line = torch.arange(n_line, dtype=torch.float32)
    samp = torch.arange(n_samp, dtype=torch.float32)
    src = samp[None, None, :] + (m[:, None] * (line + 0.5))[:, :, None]
    base = torch.floor(src)
    weights = torch.stack(_cubic_weights(src - base), -1)
    index = torch.stack([torch.clamp(base + k, 0, n_samp - 1)
                         for k in (-1, 0, 1, 2)], -1).to(torch.int64)
    fill = (src < -0.5) | (src >= n_samp - 0.5)
    return weights.to(device), index.to(device), fill.to(device)


def _shear(img, mag, sign, axis: int):
    """BICUBIC shear along W (``axis=2``, shearX: each row shifts by
    m*(y + 0.5)) or H (``axis=1``, shearY).  ``mag`` is one of the grid's
    values; its bin and the sign pick the tabled variant."""
    x = img if axis == 2 else img.transpose(1, 2)  # (B, lines, samples, C)
    B, L, S, C = x.shape
    weights, index, fill = _shear_tables(L, S, str(img.device))
    grid_max = float(_RANGES["shearX"][-1])
    # a magnitude off the grid (another op's, in a branch that is not
    # selected) is clamped to a valid bin
    mi = torch.clamp(torch.round(mag * (9.0 / grid_max)).to(torch.int64), 0,
                     9)
    var = mi * 2 + (sign < 0).to(torch.int64)
    w, idx, out_of_range = weights[var], index[var], fill[var]
    taps = torch.gather(x, 2, idx.reshape(B, L, S * 4, 1).expand(
        B, L, S * 4, C)).view(B, L, S, 4, C)
    out = (w[..., None] * taps).sum(3)
    # PIL clips with (int)(v + 0.5): floor(+0.5), not round-half-even
    out = torch.where(out_of_range[..., None], _FILL,
                      torch.clamp(torch.floor(out + 0.5), 0, 255))
    return out if axis == 2 else out.transpose(1, 2)


def _shear_x(img, mag, sign):
    return _shear(img, mag, sign, axis=2)


def _shear_y(img, mag, sign):
    return _shear(img, mag, sign, axis=1)


def _translate(img, shift, axis: int):
    """PIL AFFINE + NEAREST: the integer shift floor(shift + 0.5) along W
    (``axis=2``) or H (``axis=1``), fill 128 outside."""
    B, H, W, C = img.shape
    n = img.shape[axis]
    s = torch.floor(shift + 0.5).to(torch.int64)
    src = torch.arange(n, device=img.device) + s[:, None]  # (B, n)
    valid = (src >= 0) & (src < n)
    src = torch.clamp(src, 0, n - 1)
    if axis == 2:
        out = torch.gather(img, 2, src[:, None, :, None].expand(B, H, W, C))
        return torch.where(valid[:, None, :, None], out, _FILL)
    out = torch.gather(img, 1, src[:, :, None, None].expand(B, H, W, C))
    return torch.where(valid[:, :, None, None], out, _FILL)


def _translate_x(img, mag, sign):
    return _translate(img, mag * img.shape[2] * sign, axis=2)


def _translate_y(img, mag, sign):
    return _translate(img, mag * img.shape[1] * sign, axis=1)


def _rotate(img, mag, sign):
    """rotate_with_fill: NEAREST rotation by ``mag`` degrees
    counter-clockwise about the center, over gray 128.  The inverse map is
    src = R(-theta) (out - c) + c, sampled at pixel centers."""
    B, H, W, C = img.shape
    theta = torch.deg2rad(mag)
    cos = torch.cos(theta)[:, None, None]
    sin = torch.sin(theta)[:, None, None]
    cx, cy = W / 2.0, H / 2.0
    f32 = dict(dtype=torch.float32, device=img.device)
    xx = torch.arange(W, **f32)[None, :] + 0.5 - cx
    yy = torch.arange(H, **f32)[:, None] + 0.5 - cy
    ix = torch.floor(cos * xx - sin * yy + cx).to(torch.int64)  # (B, H, W)
    iy = torch.floor(sin * xx + cos * yy + cy).to(torch.int64)
    valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
    flat = torch.clamp(iy, 0, H - 1) * W + torch.clamp(ix, 0, W - 1)
    out = torch.gather(img.reshape(B, H * W, C), 1,
                       flat.reshape(B, H * W, 1).expand(B, H * W, C))
    return torch.where(valid[..., None], out.view(B, H, W, C), _FILL)


_OP_NAMES = [
    "shearX", "shearY", "translateX", "translateY", "rotate", "color",
    "posterize", "solarize", "contrast", "sharpness", "brightness",
    "autocontrast", "equalize", "invert",
]
_OP_FNS = [
    _shear_x, _shear_y, _translate_x, _translate_y, _rotate, _color,
    _posterize, _solarize, _contrast, _sharpness, _brightness,
    _autocontrast, _equalize, _invert,
]
_OP_ID = {name: i for i, name in enumerate(_OP_NAMES)}

# -- policies (the published constants) -----------------------------------

_RANGES = {
    "shearX": np.linspace(0, 0.3, 10),
    "shearY": np.linspace(0, 0.3, 10),
    "translateX": np.linspace(0, 150 / 331, 10),
    "translateY": np.linspace(0, 150 / 331, 10),
    "rotate": np.linspace(0, 30, 10),
    "color": np.linspace(0.0, 0.9, 10),
    "posterize": np.round(np.linspace(8, 4, 10), 0).astype(int),
    "solarize": np.linspace(256, 0, 10),
    "contrast": np.linspace(0.0, 0.9, 10),
    "sharpness": np.linspace(0.0, 0.9, 10),
    "brightness": np.linspace(0.0, 0.9, 10),
    "autocontrast": [0] * 10,
    "equalize": [0] * 10,
    "invert": [0] * 10,
}


def _sub(p1, op1, i1, p2, op2, i2):
    return (
        (p1, op1, float(_RANGES[op1][i1])),
        (p2, op2, float(_RANGES[op2][i2])),
    )


IMAGENET_POLICY = [
    _sub(0.4, "posterize", 8, 0.6, "rotate", 9),
    _sub(0.6, "solarize", 5, 0.6, "autocontrast", 5),
    _sub(0.8, "equalize", 8, 0.6, "equalize", 3),
    _sub(0.6, "posterize", 7, 0.6, "posterize", 6),
    _sub(0.4, "equalize", 7, 0.2, "solarize", 4),
    _sub(0.4, "equalize", 4, 0.8, "rotate", 8),
    _sub(0.6, "solarize", 3, 0.6, "equalize", 7),
    _sub(0.8, "posterize", 5, 1.0, "equalize", 2),
    _sub(0.2, "rotate", 3, 0.6, "solarize", 8),
    _sub(0.6, "equalize", 8, 0.4, "posterize", 6),
    _sub(0.8, "rotate", 8, 0.4, "color", 0),
    _sub(0.4, "rotate", 9, 0.6, "equalize", 2),
    _sub(0.0, "equalize", 7, 0.8, "equalize", 8),
    _sub(0.6, "invert", 4, 1.0, "equalize", 8),
    _sub(0.6, "color", 4, 1.0, "contrast", 8),
    _sub(0.8, "rotate", 8, 1.0, "color", 2),
    _sub(0.8, "color", 8, 0.8, "solarize", 7),
    _sub(0.4, "sharpness", 7, 0.6, "invert", 8),
    _sub(0.6, "shearX", 5, 1.0, "equalize", 9),
    _sub(0.4, "color", 0, 0.6, "equalize", 3),
    _sub(0.4, "equalize", 7, 0.2, "solarize", 4),
    _sub(0.6, "solarize", 5, 0.6, "autocontrast", 5),
    _sub(0.6, "invert", 4, 1.0, "equalize", 8),
    _sub(0.6, "color", 4, 1.0, "contrast", 8),
    _sub(0.8, "equalize", 8, 0.6, "equalize", 3),
]

# one sub-policy is commented out in the reference, leaving 24 active
CIFAR10_POLICY = [
    _sub(0.1, "invert", 7, 0.2, "contrast", 6),
    _sub(0.8, "sharpness", 1, 0.9, "sharpness", 3),
    _sub(0.5, "shearY", 8, 0.7, "translateY", 9),
    _sub(0.5, "autocontrast", 8, 0.9, "equalize", 2),
    _sub(0.2, "shearY", 7, 0.3, "posterize", 7),
    _sub(0.4, "color", 3, 0.6, "brightness", 7),
    _sub(0.3, "sharpness", 9, 0.7, "brightness", 9),
    _sub(0.6, "equalize", 5, 0.5, "equalize", 1),
    _sub(0.6, "contrast", 7, 0.6, "sharpness", 5),
    _sub(0.7, "color", 7, 0.5, "translateX", 8),
    _sub(0.3, "equalize", 7, 0.4, "autocontrast", 8),
    _sub(0.4, "translateY", 3, 0.2, "sharpness", 6),
    _sub(0.9, "brightness", 6, 0.2, "color", 8),
    _sub(0.5, "solarize", 2, 0.0, "invert", 3),
    _sub(0.2, "equalize", 0, 0.6, "autocontrast", 0),
    _sub(0.2, "equalize", 8, 0.6, "equalize", 4),
    _sub(0.9, "color", 9, 0.6, "equalize", 6),
    _sub(0.8, "autocontrast", 4, 0.2, "solarize", 8),
    _sub(0.1, "brightness", 3, 0.7, "color", 0),
    _sub(0.4, "solarize", 5, 0.9, "autocontrast", 3),
    _sub(0.9, "translateY", 9, 0.7, "translateY", 9),
    _sub(0.9, "autocontrast", 2, 0.8, "solarize", 3),
    _sub(0.8, "equalize", 8, 0.1, "invert", 3),
    _sub(0.7, "translateY", 9, 0.9, "autocontrast", 1),
]

SVHN_POLICY = [
    _sub(0.9, "shearX", 4, 0.2, "invert", 3),
    _sub(0.9, "shearY", 8, 0.7, "invert", 5),
    _sub(0.6, "equalize", 5, 0.6, "solarize", 6),
    _sub(0.9, "invert", 3, 0.6, "equalize", 3),
    _sub(0.6, "equalize", 1, 0.9, "rotate", 3),
    _sub(0.9, "shearX", 4, 0.8, "autocontrast", 3),
    _sub(0.9, "shearY", 8, 0.4, "invert", 5),
    _sub(0.9, "shearY", 5, 0.2, "solarize", 6),
    _sub(0.9, "invert", 6, 0.8, "autocontrast", 1),
    _sub(0.6, "equalize", 3, 0.9, "rotate", 3),
    _sub(0.9, "shearX", 4, 0.3, "solarize", 3),
    _sub(0.8, "shearY", 8, 0.7, "invert", 4),
    _sub(0.9, "equalize", 5, 0.6, "translateY", 6),
    _sub(0.9, "invert", 4, 0.6, "equalize", 7),
    _sub(0.3, "contrast", 3, 0.8, "rotate", 4),
    _sub(0.8, "invert", 5, 0.0, "translateY", 2),
    _sub(0.7, "shearY", 6, 0.4, "solarize", 8),
    _sub(0.6, "invert", 4, 0.8, "rotate", 4),
    _sub(0.3, "shearY", 7, 0.9, "translateX", 3),
    _sub(0.1, "shearX", 6, 0.6, "invert", 5),
    _sub(0.7, "solarize", 2, 0.6, "translateY", 7),
    _sub(0.8, "shearY", 4, 0.8, "invert", 8),
    _sub(0.7, "shearX", 9, 0.8, "translateY", 3),
    _sub(0.8, "shearY", 5, 0.7, "autocontrast", 3),
    _sub(0.7, "shearX", 2, 0.1, "invert", 5),
]

_POLICIES = {
    "imagenet": IMAGENET_POLICY,
    "cifar10": CIFAR10_POLICY,
    "svhn": SVHN_POLICY,
}


def policy_for_dataset(dataset: str) -> str:
    """c10 and c100 both use the CIFAR10 policy."""
    return {"c10": "cifar10", "c100": "cifar10", "svhn": "svhn"}[dataset]


@functools.cache
def _policy_arrays(policy: str, device: str):
    """(probs (n, 2) f32, op index into ``fns`` (n, 2), mags (n, 2) f32, the
    op functions the policy uses), the tensors on ``device``.  Only the ops
    the policy names are computed (the CIFAR10 policy never shears along
    x), and the tensors are made once per device: a copy from the host at
    every step would wait for the card."""
    subs = _POLICIES[policy]
    used = sorted({_OP_ID[stage[1]] for s in subs for stage in s})
    probs = torch.tensor([[s[0][0], s[1][0]] for s in subs],
                         dtype=torch.float32)
    ops = torch.tensor([[used.index(_OP_ID[stage[1]]) for stage in s]
                        for s in subs])
    mags = torch.tensor([[s[0][2], s[1][2]] for s in subs],
                        dtype=torch.float32)
    return (probs.to(device), ops.to(device), mags.to(device),
            tuple(_OP_FNS[i] for i in used))


def autoaugment_draws(generator: torch.Generator, batch: int, policy: str):
    """Every random number of a batch's AutoAugment, on the generator's
    device: the sub-policy index (B,), the two stages' gate uniforms (B, 2)
    and their sign bits (B, 2), True for +magnitude (p=0.5)."""
    dev = generator.device
    sub = torch.randint(0, len(_POLICIES[policy]), (batch,),
                        generator=generator, device=dev)
    gate_u = torch.rand((batch, 2), generator=generator, device=dev)
    sign = torch.rand((batch, 2), generator=generator, device=dev) < 0.5
    return sub, gate_u, sign


def apply_autoaugment(imgs: torch.Tensor, sub: torch.Tensor,
                      gate_u: torch.Tensor, sign: torch.Tensor,
                      policy: str) -> torch.Tensor:
    """Apply each image's sub-policy with the given draws: (B, H, W, C)
    uint8 -> uint8.  A stage applies when its gate uniform is under the
    stage's probability."""
    probs, ops, mags, fns = _policy_arrays(policy, str(imgs.device))
    rows = torch.arange(imgs.shape[0], device=imgs.device)
    signs = torch.where(sign, 1.0, -1.0)
    img = imgs.to(torch.float32)
    for stage in range(2):
        mag, s = mags[sub, stage], signs[:, stage]
        applied = torch.stack([fn(img, mag, s) for fn in fns])[
            ops[sub, stage], rows]
        do = gate_u[:, stage] < probs[sub, stage]
        img = torch.where(_per_image(do), applied, img)
        img = torch.clamp(torch.round(img), 0, 255)
    return img.to(torch.uint8)


def autoaugment_batch(generator: torch.Generator, imgs: torch.Tensor,
                      policy: str) -> torch.Tensor:
    """A random sub-policy per image: (B, H, W, C) uint8 -> uint8."""
    return apply_autoaugment(
        imgs, *autoaugment_draws(generator, imgs.shape[0], policy), policy)
