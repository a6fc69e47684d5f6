"""Resize primitives matching the JAX package's, NHWC.

Port of ``bacs_tpu/ops/interpolate.py``: bilinear with half-pixel centres
(the logit upsampling, ``NetOutput.logits``), bilinear with aligned corners
(the background detector's x16 upsample), and nearest with
src = floor(dst * in / out) (the prototypes' label downsample).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize_bilinear(
    x: torch.Tensor, size: Tuple[int, int], align_corners: bool = False
) -> torch.Tensor:
    """Bilinear resize of [N, H, W, C] to [N, size[0], size[1], C]:
    half-pixel centres (``align_corners=False``, the reference's logit
    upsampling) or src = dst * (in - 1) / (out - 1) (``align_corners=True``,
    the background detector's, ``bacs_tpu/ops/interpolate.py:32-54``)."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    y = F.interpolate(
        x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
        align_corners=align_corners,
    )
    return y.permute(0, 2, 3, 1)


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of [N, H, W] label maps or [N, H, W, C] tensors:
    src = floor(dst * in / out) in float32, as the JAX function
    (``bacs_tpu/ops/interpolate.py:57-80``), so the two pick the same
    source pixels."""
    h, w = x.shape[1:3]
    oh, ow = size
    if (h, w) == (oh, ow):
        return x
    ar = lambda n: torch.arange(n, dtype=torch.float32, device=x.device)  # noqa: E731
    ys = torch.floor(ar(oh) * (h / oh)).long().clamp(0, h - 1)
    xs = torch.floor(ar(ow) * (w / ow)).long().clamp(0, w - 1)
    return x[:, ys][:, :, xs]
