"""Forward contract shared by all networks (port of ``bacs_tpu/models/base.py``)."""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

from bacs_tpu_torch.ops.interpolate import resize_bilinear


@dataclasses.dataclass
class NetOutput:
    """Everything a loss may need from one forward pass, all NHWC.

    sem_logits:  [N, h, w, C] pre-upsample classifier output
    penultimate: [N, h, w, D] backbone features
    attentions:  per-stage pre-activation maps + head output
    out_hw:      the input's (H, W)
    logits:      [N, H, W, C] f32, ``sem_logits`` upsampled to ``out_hw``,
                 computed on first access: eager PyTorch has no dead-code
                 elimination, and the kernel paths never read it (XLA drops
                 it from the JAX step)
    """

    sem_logits: torch.Tensor
    penultimate: torch.Tensor
    attentions: Tuple[torch.Tensor, ...]
    out_hw: Tuple[int, int]

    @functools.cached_property
    def logits(self) -> torch.Tensor:
        return resize_bilinear(self.sem_logits.float(), self.out_hw)
