"""MiB: unbiased CE + unbiased knowledge distillation.

Port of ``bacs_tpu/methods/mib.py``.  At a task > 0 in training the loss is

    UCE(sem, labels) + lkd * UKD(sem, sem of the previous model)

with the reference's reduction: both terms are means over ALL pixels,
ignored ones included (reference mib.py:23,73-76).  Below label resolution
UCE is the K6 kernel's sum over N H W and UKD the K7 kernel's; otherwise
the composed losses of ``ops/losses.py`` on the full-resolution logits.
Task 0 and the eval step take plain CE with the same reduction (K1's
forward).  ``bg_weighted_ce`` (BACS's seen-weighted CE inside MiB) is set
by no shipped MiB config and raises (ROADMAP.md queue 1 item 11).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from bacs_tpu_torch.methods.base import Method, ModelContext, StepAux
from bacs_tpu_torch.ops.losses import unbiased_cross_entropy
from bacs_tpu_torch.ops.upsample_ce import upsampled_uce_sums


class MiBMethod(Method):
    needs_prev_model = True

    def __init__(self, name: str = "MiB", bg_weighted_ce: bool = False,
                 lkd: float = 10.0, **kwargs):
        if bg_weighted_ce:
            raise NotImplementedError(
                "MiB with bg_weighted_ce is ROADMAP.md queue 1 item 11 (set by no "
                "shipped MiB config)")
        super().__init__(name=name, **kwargs)
        self.lkd = lkd

    def compute_loss(
        self,
        ctx: ModelContext,
        state,
        batch: Dict[str, torch.Tensor],
        train: bool,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, StepAux]:
        image, mask = batch["image"], batch["label"]
        out = ctx.forward(state.model, image, train, generator)
        loss = self._mib_ce(ctx, out, mask, train)
        if state.prev_model is not None and train:
            old_out = ctx.forward_prev(state, image)
            loss = loss + self.lkd * self.ukd_with_upsample(ctx, out, old_out, mask)
        return loss, StepAux(
            sem_logits=out.sem_logits[..., : ctx.n_cur],
            output=out,
            n_cur=ctx.n_cur,
            state_updates=self.prototype_updates(ctx, state, out.penultimate, mask, train),
        )

    def _mib_ce(self, ctx: ModelContext, out, mask, train: bool) -> torch.Tensor:
        """The unbiased CE (when old classes exist, in training) or the plain
        CE, each summed over the valid pixels and divided by N H W."""
        old = ctx.task.old_classes
        if old == 0 or not train:
            return self.ce_over_all_pixels(ctx, out, mask)
        sem = out.sem_logits[..., : ctx.n_cur]
        if self._fused_gate(ctx, sem, mask):
            total, _ = upsampled_uce_sums(sem.contiguous(), mask, tuple(mask.shape[1:3]), old,
                                          self.ignore_index)
            return total / mask.numel()
        return unbiased_cross_entropy(out.logits[..., : ctx.n_cur], mask, old,
                                      self.ignore_index, reduction="none").mean()
