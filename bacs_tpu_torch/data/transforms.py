"""The on-device transforms: normalization, label remap, the train and eval
transforms, and the replay augmentation, on the tensors' device.

Port of ``bacs_tpu/data/transforms.py``: ``normalize_image`` /
``denormalize_image`` (``:29-40``), ``remap_labels`` (``:43-45``),
``train_transform`` (RandomResizedCrop, scale 0.5-2.0, and a horizontal
flip, then normalize and remap, ``:101-118``), ``eval_transform``
(``:141-161``) and ``replay_augment`` (``:121-138``), which re-applies the
train augmentation to buffered crops at every replay.  The draws
(:func:`sample_crop_params`) are JAX's, bit for bit: a key per image
(``split(key, N)``), split in two for the crop and the flip and the crop's
in four scalar uniforms, the region computed in f32 with XLA's CPU ``exp``
(``ops/rng.py``), on the host, so the numbers are the same on the card and
on the CPU; what they make of the pixels (:func:`apply_crop_params`,
:func:`resize_region`) is a function of the parameters (i, j, ch, cw,
flip), computed in the same float32 order as the JAX code.  The JAX
function vmaps over single images; here the batch is a dimension, and
nothing leaves the device.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from bacs_tpu_torch.ops import rng

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
    key: Optional[rng.Key] = None,
    device: torch.device | str = "cpu",
    scale: Tuple[float, float] = (0.5, 2.0),
    ratio: Tuple[float, float] = (3 / 4, 4 / 3),
    rows: Optional[Tuple[int, int]] = None,
) -> Dict[str, torch.Tensor]:
    """A RandomResizedCrop region and a flip per image, JAX's draws from
    ``key`` for a batch of ``n`` (``train_transform`` and ``_augment_one``,
    ``_sample_crop_params``, ``bacs_tpu/data/transforms.py:48-63,90-118``):
    area uniform in scale x the source area, log aspect uniform in
    log(ratio), sides clamped to [8, source side], top-left uniform, a fair
    coin for the flip.  ``rows`` = (first, count) keeps those images' draws.
    Returns tensors ``i``, ``j``, ``ch``, ``cw`` (f32) and ``flip`` (bool)
    on ``device``, drawn and computed on the host and copied without
    waiting (the card's ``exp`` differs from the CPU's in the last bit)."""
    h, w = src_hw
    per_image = np.asarray(rng.split(rng.given(key), n), np.int64)
    if rows is not None:
        per_image = per_image[rows[0]:rows[0] + rows[1]]
    crop_keys, flip_keys = rng.split_keys(per_image, 2)
    r_area, r_ratio, r_i, r_j = rng.split_keys(crop_keys, 4)
    area = (h * w) * rng.scalar_uniforms(r_area, scale[0], scale[1])
    # jnp.log of the ratio's ends, folded to f32 constants in the jit
    lo, hi = (float(np.log(np.float32(r))) for r in ratio)
    log_aspect = rng.scalar_uniforms(r_ratio, lo, hi)
    cw = torch.clamp(rng.xla_sqrt(area * rng.xla_exp(log_aspect)), 8.0, w)
    # XLA rewrites area / exp(x) as area * exp(-x)
    ch = torch.clamp(rng.xla_sqrt(area * rng.xla_exp(-log_aspect)), 8.0, h)
    params = {"i": rng.scalar_uniforms(r_i) * (h - ch), "j": rng.scalar_uniforms(r_j) * (w - cw),
              "ch": ch, "cw": cw, "flip": rng.scalar_uniforms(flip_keys) < 0.5}
    return {k: rng.to_device(v, device) for k, v in params.items()}


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
                      params: Dict[str, torch.Tensor], out: Optional[int] = None):
    """The augmentation for given parameters: images [N, H, W, 3] resized
    bilinearly and labels [N, H, W] by nearest to the same out x out grid
    (default out = H), then flipped where ``flip``."""
    crop = out or images.shape[1]
    region = (params["i"], params["j"], params["ch"], params["cw"])
    img = resize_region(images, *region, crop, "bilinear")
    lbl = resize_region(labels, *region, crop, "nearest")
    flip = params["flip"]
    img = torch.where(flip[:, None, None, None], img.flip(2), img)
    lbl = torch.where(flip[:, None, None], lbl.flip(2), lbl)
    return img, lbl


def replay_augment(images: torch.Tensor, labels: torch.Tensor,
                   key: Optional[rng.Key] = None):
    """Re-augment a buffered batch at replay time (``replay_augment``,
    ``bacs_tpu/data/transforms.py:121-138``): a fresh crop and flip per
    image, JAX's draws from ``key``, on the images' device."""
    params = sample_crop_params(images.shape[0], tuple(images.shape[1:3]),
                                key, images.device)
    return apply_crop_params(images, labels, params)


def remap_labels(labels: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Apply a [256] lookup table (int32, on the labels' device) to integer
    labels."""
    return table[labels.long().clamp(0, 255)]


def train_transform(key: Optional[rng.Key], images: torch.Tensor,
                    labels: torch.Tensor, table: torch.Tensor, crop: int = 512,
                    scale: Tuple[float, float] = (0.5, 2.0),
                    rows: Optional[Tuple[int, int]] = None) -> Dict[str, torch.Tensor]:
    """uint8 images [N, H, W, 3] and labels [N, H, W] -> the augmented batch
    {image: normalized f32 [N, crop, crop, 3], label: int32 [N, crop, crop]}:
    a crop region and a flip per image, JAX's draws from ``key``, on the
    images' device, the region resized to ``crop`` (bilinear images,
    nearest labels), then normalize and remap.  ``rows`` = (first row,
    global batch): the images are rows ``first..first + N`` of a global
    batch, and the draws are the global batch's, those rows taken."""
    lo, total = rows or (0, images.shape[0])
    params = sample_crop_params(total, tuple(images.shape[1:3]), key, images.device,
                                scale, rows=(lo, images.shape[0]))
    img, lbl = apply_crop_params(images, labels, params, out=crop)
    return {"image": normalize_image(img), "label": remap_labels(lbl, table)}


def eval_transform(images: torch.Tensor, labels: torch.Tensor, table: torch.Tensor,
                   crop: int = 512) -> Dict[str, torch.Tensor]:
    """Resize (short side -> crop) + CenterCrop + Normalize.  Sources arrive
    square; one of another size than ``crop`` is resized: images by
    anti-aliased bilinear interpolation with half-pixel centres (JAX's
    ``jax.image.resize(..., "linear")``), labels by the nearest source row
    and column ``floor(k * h / crop)``."""
    n, h, w, _ = images.shape
    if (h, w) != (crop, crop):
        x = images.float().permute(0, 3, 1, 2)
        images = torch.nn.functional.interpolate(
            x, size=(crop, crop), mode="bilinear", align_corners=False,
            antialias=True).permute(0, 2, 3, 1)
        k = torch.arange(crop, device=labels.device, dtype=torch.float32)
        ys = torch.floor(k * (h / crop)).long().clamp(0, h - 1)
        xs = torch.floor(k * (w / crop)).long().clamp(0, w - 1)
        labels = labels[:, ys][:, :, xs]
    return {"image": normalize_image(images), "label": remap_labels(labels, table)}
