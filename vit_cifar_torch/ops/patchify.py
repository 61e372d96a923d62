"""Patch extraction on NHWC images, in the JAX package's token order.

Feature order inside a patch is (row-in-patch, col-in-patch, channel), the
order of the reference's NCHW unfold + ``permute(0,2,3,4,5,1)``.
"""

from __future__ import annotations

import torch


def to_words(x: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, patch*patch, patch_size*patch_size*C)."""
    B, H, W, C = x.shape
    ps = H // patch
    if ps * patch != H or H != W:
        raise ValueError(f"image {H}x{W} does not split into {patch}x{patch} "
                         "square patches")
    x = x.reshape(B, patch, ps, patch, ps, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, patch * patch, ps * ps * C)


def from_words(tokens: torch.Tensor, patch: int, img_size: int,
               channels: int) -> torch.Tensor:
    """Inverse of :func:`to_words`."""
    B = tokens.shape[0]
    ps = img_size // patch
    x = tokens.reshape(B, patch, patch, ps, ps, channels).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, img_size, img_size, channels)
