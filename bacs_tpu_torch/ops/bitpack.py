"""Bit-packing of class-id masks for the serving wire format.

Port of ``bacs_tpu/ops/bitpack.py``; the wire format is the same, byte for
byte.  Class ids need only ``ceil(log2(n_classes))`` bits (5 for VOC's 21
classes), so the mask is packed on the device before it is copied to the
host.  Layout: byte-planes over H-groups.  Pixels are grouped 8 along H;
plane ``b`` holds, for group row ``g`` and column ``w``, the byte whose bit
``k`` is bit ``b`` of pixel ``(8g + k, w)``.  The packed array is
``[N, bits, H/8, W]`` flattened to ``[N, -1]``.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def bits_needed(n_classes: int) -> int:
    """Smallest bits-per-pixel that can hold class ids 0..n_classes-1."""
    if not 2 <= n_classes <= 256:
        raise ValueError(f"n_classes must be in [2, 256], got {n_classes}")
    return max(1, math.ceil(math.log2(n_classes)))


def pack_bits(preds: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack uint8 class ids [N, H, W] -> packed bytes [N, bits*H*W//8].

    Requires H % 8 == 0.  Plain shifts on the tensor's own device.
    """
    if not 1 <= bits <= 8:
        raise ValueError(f"bits must be in [1, 8], got {bits}")
    n, h, w = preds.shape
    if h % 8:
        raise ValueError(f"H must be divisible by 8, got {h}")
    v = preds.to(torch.uint8).reshape(n, 1, h // 8, 8, w)
    plane = torch.arange(bits, dtype=torch.uint8, device=preds.device)
    k = torch.arange(8, dtype=torch.uint8, device=preds.device)
    # [N, bits, H/8, 8, W]: bit b of pixel (8g+k, w), moved to bit k
    spread = ((v >> plane.view(1, bits, 1, 1, 1)) & 1) << k.view(1, 1, 1, 8, 1)
    # the 8 terms hold disjoint bits, so their sum is their OR
    return spread.sum(dim=3, dtype=torch.uint8).reshape(n, -1)


def unpack_bits(packed: np.ndarray, shape: tuple, bits: int) -> np.ndarray:
    """Host-side inverse of :func:`pack_bits`.

    packed: uint8 [N, bits*H*W//8]; shape: the original (N, H, W).
    """
    from bacs_tpu_torch.data.native import unpack_bitplanes

    n, h, w = shape
    planes = np.asarray(packed, np.uint8).reshape(n, bits, h // 8, w)
    native = unpack_bitplanes(planes, n, bits, h // 8, w)
    if native is not None:  # the host library's loop, as JAX's
        return native
    # byte at (g, w) expands LSB-first to pixels (8g+k, w), k = 0..7
    plane_bits = np.unpackbits(planes, axis=2, bitorder="little")
    out = np.zeros((n, h, w), np.uint8)
    for b in range(bits):
        out |= plane_bits[:, b] << b
    return out
