"""Image normalization and the replay augmentation, on the tensors' device.

Port of ``bacs_tpu/data/transforms.py``: ``normalize_image`` /
``denormalize_image`` (``:29-40``) and ``replay_augment`` (``:121-138``),
which re-applies the train transform (RandomResizedCrop, scale 0.5-2.0,
and a horizontal flip) to buffered crops at every replay.  The draws
(:func:`sample_crop_params`) come from a ``torch.Generator``; what they
make of the pixels (:func:`apply_crop_params`, :func:`resize_region`) is a
function of the parameters (i, j, ch, cw, flip), computed in the same
float32 order as the JAX code, so the two packages agree on the same
parameters.  The JAX function vmaps over single images; here the batch is
a dimension, and nothing leaves the device.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

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


def denormalize_image(x: torch.Tensor) -> torch.Tensor:
    """Normalized float [..., 3] -> uint8 pixels, clipped and truncated as
    the JAX function."""
    mean, std = _stats(x.device)
    return torch.clamp((x * std + mean) * 255.0, 0, 255).to(torch.uint8)


def sample_crop_params(
    n: int,
    src_hw: Tuple[int, int],
    generator: Optional[torch.Generator] = None,
    device: torch.device | str = "cpu",
    scale: Tuple[float, float] = (0.5, 2.0),
    ratio: Tuple[float, float] = (3 / 4, 4 / 3),
) -> Dict[str, torch.Tensor]:
    """A RandomResizedCrop region and a flip per image, as
    ``_sample_crop_params`` (``bacs_tpu/data/transforms.py:48-63``): area
    uniform in scale x the source area, log aspect uniform in log(ratio),
    sides clamped to [8, source side], top-left uniform.  Returns [n]
    tensors ``i``, ``j``, ``ch``, ``cw`` (f32) and ``flip`` (bool)."""
    h, w = src_hw
    u = torch.rand((5, n), generator=generator, device=device)
    area = h * w * (scale[0] + u[0] * (scale[1] - scale[0]))
    lo, hi = math.log(ratio[0]), math.log(ratio[1])
    aspect = torch.exp(lo + u[1] * (hi - lo))
    cw = torch.clamp(torch.sqrt(area * aspect), 8.0, w)
    ch = torch.clamp(torch.sqrt(area / aspect), 8.0, h)
    return {"i": u[2] * (h - ch), "j": u[3] * (w - cw), "ch": ch, "cw": cw,
            "flip": u[4] < 0.5}


def resize_region(img: torch.Tensor, i, j, ch, cw, out: int, method: str) -> torch.Tensor:
    """Sample an out x out grid from each image's region [i:i+ch, j:j+cw]
    (``_resize_region``, ``bacs_tpu/data/transforms.py:66-87``).

    ``img`` is [N, H, W] or [N, H, W, C]; ``i``, ``j``, ``ch``, ``cw`` are
    [N] f32.  ``nearest`` gathers (labels keep their dtype); ``bilinear``
    interpolates with half-pixel centres in f32.
    """
    h, w = img.shape[1], img.shape[2]
    ar = torch.arange(out, device=img.device, dtype=torch.float32)[None, :]
    i, j, ch, cw = (t[:, None] for t in (i, j, ch, cw))
    b = torch.arange(img.shape[0], device=img.device)[:, None, None]
    if method == "nearest":
        ys = torch.clamp(i + (ar + 0.0) * ch / out, 0, h - 1)
        xs = torch.clamp(j + (ar + 0.0) * cw / out, 0, w - 1)
        yi = torch.floor(ys).long().clamp(0, h - 1)
        xi = torch.floor(xs).long().clamp(0, w - 1)
        return img[b, yi[:, :, None], xi[:, None, :]]
    ys = torch.clamp(i + (ar + 0.5) * ch / out - 0.5, 0, h - 1)
    xs = torch.clamp(j + (ar + 0.5) * cw / out - 0.5, 0, w - 1)
    y0 = torch.floor(ys).long().clamp(0, h - 1)
    x0 = torch.floor(xs).long().clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    wy = (ys - y0)[:, :, None, None]
    wx = (xs - x0)[:, None, :, None]
    f = img.float()

    def at(yy, xx):
        return f[b, yy[:, :, None], xx[:, None, :]]

    top = at(y0, x0) * (1 - wx) + at(y0, x1) * wx
    bot = at(y1, x0) * (1 - wx) + at(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def apply_crop_params(images: torch.Tensor, labels: torch.Tensor,
                      params: Dict[str, torch.Tensor]):
    """The augmentation for given parameters: images [N, H, W, 3] resized
    bilinearly and labels [N, H, W] by nearest to the same out x out grid
    (out = H), then flipped where ``flip``."""
    crop = images.shape[1]
    region = (params["i"], params["j"], params["ch"], params["cw"])
    img = resize_region(images, *region, crop, "bilinear")
    lbl = resize_region(labels, *region, crop, "nearest")
    flip = params["flip"]
    img = torch.where(flip[:, None, None, None], img.flip(2), img)
    lbl = torch.where(flip[:, None, None], lbl.flip(2), lbl)
    return img, lbl


def replay_augment(images: torch.Tensor, labels: torch.Tensor,
                   generator: Optional[torch.Generator] = None):
    """Re-augment a buffered batch at replay time (``replay_augment``,
    ``bacs_tpu/data/transforms.py:121-138``): a fresh crop and flip per
    image, drawn from ``generator`` on the images' device."""
    params = sample_crop_params(images.shape[0], tuple(images.shape[1:3]),
                                generator, images.device)
    return apply_crop_params(images, labels, params)
