"""Representation drift (port of ``bacs_tpu/viz/drift.py``).

After each task's test, :meth:`DriftProbe.snapshot` keeps up to
``max_samples`` images and their L2-normalized penultimate features;
during the next task, every ``measure_every`` train steps,
:meth:`DriftProbe.measure` recomputes them on the same images and returns
the mean absolute change, which the Trainer logs as
``representation_drift`` (reference: visualization/log_drift.py,
training/model.py:371-374).  The images and features stay on the device.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from bacs_tpu_torch.methods.base import ModelContext


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-5)


@torch.no_grad()
def _features(ctx: ModelContext, state, images: torch.Tensor) -> torch.Tensor:
    """The normalized penultimate features of the eval-mode forward."""
    return _normalize(ctx.forward(state.model, images, False).penultimate)


class DriftProbe:
    def __init__(self, max_samples: int = 10, measure_every: int = 50):
        self.max_samples = max_samples
        self.measure_every = measure_every
        self._images: Optional[torch.Tensor] = None
        self._feats: Optional[torch.Tensor] = None

    def snapshot(self, ctx: ModelContext, state, batch: Dict[str, torch.Tensor]) -> None:
        """Keep ``batch``'s first images and their features (reference:
        log_drift.py:22-42 on_test_end)."""
        self._images = batch["image"][: self.max_samples].clone()
        self._feats = _features(ctx, state, self._images)

    def measure(self, ctx: ModelContext, state, step: int) -> Optional[float]:
        """Mean |change| of the normalized features on the kept images at
        every ``measure_every``-th step, else None (reference:
        log_drift.py:44-62)."""
        if self._images is None or step % self.measure_every != 0:
            return None
        return float(torch.mean(torch.abs(_features(ctx, state, self._images) - self._feats)))
