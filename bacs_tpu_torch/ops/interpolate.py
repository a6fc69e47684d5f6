"""Bilinear resize matching the JAX package's ``resize_bilinear``, NHWC.

Port of ``bacs_tpu/ops/interpolate.py:21-31``.  It feeds
``NetOutput.logits``; the serving path never calls it (the Predictor works
from the pre-upsample logits, ``ops/upsample_argmax.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of [N, H, W, C] to [N, size[0], size[1], C] with
    half-pixel centres (``align_corners=False``, the reference's logit
    upsampling).  The JAX function's corner-aligned mode serves the
    background detector and is not ported yet.
    """
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    y = F.interpolate(
        x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
        align_corners=False,
    )
    return y.permute(0, 2, 3, 1)
