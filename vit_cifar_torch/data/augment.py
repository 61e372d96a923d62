"""On-device data augmentation, as ``vit_cifar_tpu/data/augment.py``.

* ``normalize``: ToTensor + Normalize (reference utils.py:353-356);
* ``random_crop_flip``: RandomCrop(size, padding=4, zero fill) +
  RandomHorizontalFlip (utils.py:340-342);
* ``cutmix``: CutMix (da.py:51-78), with the float floor-div quirk of its
  box arithmetic (``r_w // 2`` on a float);
* ``mixup``: MixUp (da.py:81-93);
* ``random_crop_paste``: RandomCropPaste (da.py:4-49);
* ``augment_dataset``: the once-per-epoch whole-dataset pass of
  ``--preaugment-epoch``.

Each random op is split in two: ``*_draws`` takes a ``torch.Generator`` and
draws every random number the op needs, on the generator's device, and
``apply_*`` takes those draws.  The op itself is the two in a row.  Tests
hand ``apply_*`` the JAX package's draws, since the two frameworks' random
streams never agree.  AutoAugment itself is ``data/autoaugment.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .autoaugment import apply_autoaugment, autoaugment_draws


def normalize(x: torch.Tensor, mean, std) -> torch.Tensor:
    """(x/255 - mean)/std in f32 on the trailing channel axis; takes uint8
    or float input."""
    x = x.to(torch.float32) / 255.0
    mean = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def uniform(generator: torch.Generator, shape=()) -> torch.Tensor:
    """U(0, 1) draws from ``generator``, on its device."""
    return torch.rand(shape, generator=generator, device=generator.device)


# -- random crop and flip ---------------------------------------------------

def crop_flip_draws(generator: torch.Generator, batch: int, padding: int,
                    flip: bool = True):
    """(off_y, off_x) in [0, 2*padding] and, with ``flip``, the flip mask
    (p=0.5), each of shape (batch,)."""
    hi = 2 * padding + 1
    dev = generator.device
    off_y = torch.randint(0, hi, (batch,), generator=generator, device=dev)
    off_x = torch.randint(0, hi, (batch,), generator=generator, device=dev)
    do_flip = uniform(generator, (batch,)) < 0.5 if flip else None
    return off_y, off_x, do_flip


def apply_crop_flip(x: torch.Tensor, padding: int, off_y: torch.Tensor,
                    off_x: torch.Tensor,
                    do_flip: torch.Tensor | None) -> torch.Tensor:
    """Crop (B, H, W, C) images out of their zero-padded borders at the
    given offsets, then flip the rows of ``do_flip`` left to right."""
    B, H, W, C = x.shape
    xp = F.pad(x, (0, 0, padding, padding, padding, padding))
    rows = off_y[:, None] + torch.arange(H, device=x.device)  # (B, H)
    cols = off_x[:, None] + torch.arange(W, device=x.device)  # (B, W)
    b = torch.arange(B, device=x.device)[:, None, None]
    out = xp[b, rows[:, :, None], cols[:, None, :]]
    if do_flip is not None:
        out = torch.where(do_flip[:, None, None, None], out.flip(2), out)
    return out


def random_crop_flip(generator: torch.Generator, x: torch.Tensor,
                     padding: int, flip: bool = True) -> torch.Tensor:
    """Per-image random crop from zero-padded borders + horizontal flip
    p=0.5.  x: (B, H, W, C), any dtype (the step's is uint8)."""
    return apply_crop_flip(x, padding,
                           *crop_flip_draws(generator, x.shape[0], padding,
                                            flip))


# -- CutMix -----------------------------------------------------------------

def cutmix_draws(generator: torch.Generator, batch: int, size: int):
    """(lam0 ~ Beta(1, 1), r_x, r_y ~ U(0, size), perm) as tensors.  The
    reference's CutMix and MixUp draw Beta(1, 1), which is U(0, 1)."""
    lam0 = uniform(generator)
    r_x = uniform(generator) * size
    r_y = uniform(generator) * size
    perm = torch.randperm(batch, generator=generator, device=generator.device)
    return lam0, r_x, r_y, perm


def apply_cutmix(img: torch.Tensor, label: torch.Tensor, size: int,
                 lam0: torch.Tensor, r_x: torch.Tensor, r_y: torch.Tensor,
                 perm: torch.Tensor):
    """da.py:51-78 with the given draws: the box [x1, x2) x [y1, y2) of
    each image comes from image ``perm``; x slices the H axis, as the
    reference's NCHW ``img[:, :, x1:x2, y1:y2]`` does.  Returns (img,
    label, label[perm], lam), lam = 1 - box area / size^2 from the clipped
    box."""
    f32 = dict(dtype=torch.float32, device=img.device)
    lam0, r_x, r_y = (torch.as_tensor(a, **f32) for a in (lam0, r_x, r_y))
    r_w = size * torch.sqrt(1.0 - lam0)
    half = torch.floor(r_w / 2.0)  # float floor-div quirk: r_w // 2
    x1 = torch.floor(torch.clamp(r_x - half, 0, size))
    x2 = torch.floor(torch.clamp(r_x + half, 0, size))
    y1 = torch.floor(torch.clamp(r_y - half, 0, size))
    y2 = torch.floor(torch.clamp(r_y + half, 0, size))
    r = torch.arange(size, **f32)
    mask_h = (r >= x1) & (r < x2)
    mask_w = (r >= y1) & (r < y2)
    box = (mask_h[:, None] & mask_w[None, :])[None, :, :, None]
    perm = perm.to(img.device)
    img = torch.where(box, img[perm], img)
    lam = 1.0 - (x2 - x1) * (y2 - y1) / float(size * size)
    return img, label, label[perm], lam


def cutmix(generator: torch.Generator, img: torch.Tensor,
           label: torch.Tensor, size: int):
    return apply_cutmix(img, label, size,
                        *cutmix_draws(generator, img.shape[0], size))


# -- MixUp ------------------------------------------------------------------

def mixup_draws(generator: torch.Generator, batch: int):
    """(lam ~ Beta(1, 1), perm)."""
    lam = uniform(generator)
    perm = torch.randperm(batch, generator=generator, device=generator.device)
    return lam, perm


def apply_mixup(img: torch.Tensor, label: torch.Tensor, lam: torch.Tensor,
                perm: torch.Tensor):
    """da.py:81-93 with the given draws: one lambda for the whole batch.
    Returns (mixed, label, label[perm], lam)."""
    lam = torch.as_tensor(lam, dtype=torch.float32, device=img.device)
    perm = perm.to(img.device)
    mixed = lam * img + (1.0 - lam) * img[perm]
    return mixed, label, label[perm], lam


def mixup(generator: torch.Generator, img: torch.Tensor, label: torch.Tensor):
    return apply_mixup(img, label, *mixup_draws(generator, img.shape[0]))


# -- random crop-paste ------------------------------------------------------

def crop_paste_draws(generator: torch.Generator, batch: int, size: int):
    """Per image: lam ~ Beta(1, 1), which is U(0, 1); the crop's center
    (cx, cy), integers in [0, size); two uniforms for the paste origin; the
    front and background flips (p=0.5); the blend weight ~ U(0, 1)."""
    dev = generator.device
    lam = uniform(generator, (batch,))
    cx = torch.randint(0, size, (batch,), generator=generator, device=dev)
    cy = torch.randint(0, size, (batch,), generator=generator, device=dev)
    u_px = uniform(generator, (batch,))
    u_py = uniform(generator, (batch,))
    flip_front = uniform(generator, (batch,)) <= 0.5
    flip_bg = uniform(generator, (batch,)) <= 0.5
    mix = uniform(generator, (batch,))
    return lam, cx, cy, u_px, u_py, flip_front, flip_bg, mix


def apply_crop_paste(x: torch.Tensor, lam, cx, cy, u_px, u_py, flip_front,
                     flip_bg, mix) -> torch.Tensor:
    """RandomCropPaste (da.py:4-49) with the given draws, on (B, H, W, C)
    float images: crop a box of side floor(W*sqrt(1 - lam)) around (cx,
    cy), clipped to the image, flip it, and blend it into the (flipped)
    background at a random origin: bg*mix + front*(1 - mix) inside the
    box.  The origin's range is clamped to >= 1 (the reference crashes when
    the crop spans the whole image)."""
    B, H, W, C = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    cut = torch.floor(W * torch.sqrt(1.0 - lam))  # np.int truncation
    half = torch.floor(cut / 2.0)
    cx, cy = cx.to(torch.float32), cy.to(torch.float32)
    fx1, fx2 = torch.clamp(cx - half, 0, W), torch.clamp(cx + half, 0, W)
    fy1, fy2 = torch.clamp(cy - half, 0, H), torch.clamp(cy + half, 0, H)
    fw, fh = fx2 - fx1, fy2 - fy1
    px1 = torch.floor(u_px * torch.clamp(W - fw, min=1.0))
    py1 = torch.floor(u_py * torch.clamp(H - fh, min=1.0))

    yy = torch.arange(H, **f32)[None, :, None]
    xx = torch.arange(W, **f32)[None, None, :]

    def b(a):
        return a[:, None, None]

    in_box = ((yy >= b(py1)) & (yy < b(py1 + fh)) & (xx >= b(px1))
              & (xx < b(px1 + fw)))  # (B, H, W)
    src_y = yy - b(py1) + b(fy1)
    src_x = torch.where(b(flip_front), b(fx2) - 1.0 - (xx - b(px1)),
                        xx - b(px1) + b(fx1))
    iy = torch.clamp(src_y, 0, H - 1).to(torch.int64).expand(B, H, W)
    ix = torch.clamp(src_x, 0, W - 1).to(torch.int64).expand(B, H, W)
    flat = (iy * W + ix).reshape(B, H * W, 1).expand(B, H * W, C)
    front = torch.gather(x.reshape(B, H * W, C), 1, flat).view(B, H, W, C)
    bg = torch.where(flip_bg[:, None, None, None], x.flip(2), x)
    m = mix[:, None, None, None]
    blended = bg * m + front * (1.0 - m)
    return torch.where(in_box[..., None], blended, bg)


def random_crop_paste(generator: torch.Generator,
                      x: torch.Tensor) -> torch.Tensor:
    """RandomCropPaste on a (B, H, W, C) float batch, every image with its
    own draws."""
    return apply_crop_paste(x, *crop_paste_draws(generator, x.shape[0],
                                                 x.shape[2]))


# -- the per-epoch pass over the dataset ------------------------------------

def augment_dataset_draws(generator: torch.Generator, n: int, padding: int,
                          flip: bool = True,
                          autoaugment_policy: str | None = None):
    """The draws of one epoch's pass over ``n`` images: the crop/flip
    draws, then (with a policy) the AutoAugment draws of every image."""
    crop = crop_flip_draws(generator, n, padding, flip)
    aa = (autoaugment_draws(generator, n, autoaugment_policy)
          if autoaugment_policy is not None else None)
    return crop, aa


def apply_augment_dataset(xs: torch.Tensor, padding: int, crop, aa,
                          autoaugment_policy: str | None = None,
                          chunk: int = 2500) -> torch.Tensor:
    """Crop/flip the whole (N, H, W, C) uint8 dataset with the given draws,
    then AutoAugment it ``chunk`` images at a time (which bounds the memory
    of every op's output for a whole chunk); returns uint8."""
    x = apply_crop_flip(xs, padding, *crop)
    if autoaugment_policy is None:
        return x
    return torch.cat([
        apply_autoaugment(x[i:i + chunk], *(d[i:i + chunk] for d in aa),
                          autoaugment_policy)
        for i in range(0, len(x), chunk)])


def augment_dataset(generator: torch.Generator, xs: torch.Tensor,
                    padding: int, flip: bool = True,
                    autoaugment_policy: str | None = None,
                    chunk: int = 2500) -> torch.Tensor:
    """The once-per-epoch whole-dataset crop/flip(/AutoAugment) pass of
    ``--preaugment-epoch``: (N, H, W, C) uint8 -> uint8, on xs's device."""
    crop, aa = augment_dataset_draws(generator, len(xs), padding, flip,
                                     autoaugment_policy)
    return apply_augment_dataset(xs, padding, crop, aa, autoaugment_policy,
                                 chunk)
