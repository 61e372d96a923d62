"""Input normalization (the eval and serving preprocessing).

Only ``normalize`` is ported so far; the training augmentations of
``vit_cifar_tpu/data/augment.py`` come with the training slice.
"""

from __future__ import annotations

import torch


def normalize(x: torch.Tensor, mean, std) -> torch.Tensor:
    """(x/255 - mean)/std in f32 on the trailing channel axis; takes uint8
    or float input."""
    x = x.to(torch.float32) / 255.0
    mean = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    return (x - mean) / std
