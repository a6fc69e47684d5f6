"""Bilinear interpolation weights shared by the upsample kernels.

Port of the interpolation math of ``bacs_tpu/ops/upsample_tiles.py``
(``interp_matrix`` and ``kmats``): half-pixel centres (align_corners=False)
with source coordinates clamped to the edge.  The Pallas scaffolding of that
module (row blocks, channel padding, BlockSpecs) is TPU tiling and has no
counterpart here; the CUDA kernel in ``csrc/upsample_argmax.cu`` computes the
same indices and weights per pixel.  The JAX function's shard-window
arguments (``scale``, ``offset``, ``clamp``) serve its spatially
partitioned training path and are not ported.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def interp_matrix(out_dim: int, in_dim: int) -> np.ndarray:
    """[out, in] bilinear matrix with half-pixel centres.

    Each row holds at most two nonzero weights, ``1 - w`` at ``lo`` and ``w``
    at ``lo + 1``, for the source coordinate ``(r + 0.5) * in/out - 0.5``
    clamped to ``[0, in - 1]``.
    """
    if out_dim == in_dim:
        return np.eye(out_dim, dtype=np.float32)
    k = np.zeros((out_dim, in_dim), np.float32)
    coords = (np.arange(out_dim) + 0.5) * (in_dim / out_dim) - 0.5
    coords = np.clip(coords, 0, in_dim - 1)
    lo = np.floor(coords).astype(np.int64)
    hi = np.clip(lo + 1, 0, in_dim - 1)
    w = (coords - lo).astype(np.float32)
    k[np.arange(out_dim), lo] += 1.0 - w
    k[np.arange(out_dim), hi] += w
    return k


def kmats(
    sem_shape: Sequence[int], out_hw: Tuple[int, int]
) -> Tuple[np.ndarray, np.ndarray]:
    """Dense (kh [H, h], kw [W, w]) for NHWC logits of shape ``sem_shape``."""
    return (
        interp_matrix(out_hw[0], sem_shape[1]),
        interp_matrix(out_hw[1], sem_shape[2]),
    )
