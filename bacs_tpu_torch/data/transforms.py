"""Image normalization (port of ``bacs_tpu/data/transforms.py:25-35``)."""

from __future__ import annotations

import functools

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@functools.lru_cache(maxsize=None)
def _stats(device: torch.device):
    # made once per device, so a call never waits on a host-to-device copy
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device)
    return mean, std


def normalize_image(img: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 3] -> normalized float32, on the image's device."""
    mean, std = _stats(img.device)
    return (img.float() / 255.0 - mean) / std
