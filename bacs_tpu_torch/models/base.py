"""Forward contract shared by all networks (port of ``bacs_tpu/models/base.py``)."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class NetOutput(NamedTuple):
    """Everything a loss may need from one forward pass, all NHWC.

    logits:      [N, H, W, C] upsampled to input resolution
    sem_logits:  [N, h, w, C] pre-upsample classifier output
    penultimate: [N, h, w, D] backbone features
    attentions:  per-stage pre-activation maps + head output
    """

    logits: torch.Tensor
    sem_logits: torch.Tensor
    penultimate: torch.Tensor
    attentions: Tuple[torch.Tensor, ...]
