"""Segmentation losses, NHWC (port of ``bacs_tpu/ops/losses.py``).

Ported so far: :func:`cross_entropy`, the composed fallback of the CE step
(``methods/base.py``, ``ce_with_upsample``) and half of the upsample+CE
kernel's plain version (``ops/upsample_ce.py``).  The BACS, MiB, PLOP and
iCaRL losses come with their methods (ROADMAP.md queue 1 items 9 and 11).
"""

from __future__ import annotations

from typing import Optional

import torch

_EPS = 1e-8


def cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    ignore_index: int = 255,
    class_weights: Optional[torch.Tensor] = None,
    reduction: str = "mean",
) -> torch.Tensor:
    """Softmax cross entropy over the last axis, with an ignore index and
    optional per-class weights, computed in float32.

    torch ``F.cross_entropy`` semantics: with ``class_weights`` the "mean"
    divides by the sum of the target pixels' weights, not by their count.
    """
    mask = (labels != ignore_index).float()
    safe = torch.where(labels != ignore_index, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    w = mask if class_weights is None else class_weights.float()[safe] * mask
    if reduction == "none":
        return nll * w
    if reduction == "sum":
        return (nll * w).sum()
    return (nll * w).sum() / torch.clamp(w.sum(), min=_EPS)
