"""MiB: unbiased CE + unbiased knowledge distillation.

Port of ``bacs_tpu/methods/mib.py``.  At a task > 0 in training the loss is

    UCE(sem, labels) + lkd * UKD(sem, sem of the previous model)

with the reference's reduction: both terms are means over ALL pixels,
ignored ones included (reference mib.py:23,73-76).  Below label resolution
UCE is the K6 kernel's sum over N H W and UKD the K7 kernel's; otherwise
the composed losses of ``ops/losses.py`` on the full-resolution logits.
Task 0 and the eval step take plain CE with the same reduction (K1's
forward).  With ``bg_weighted_ce`` (BACS's seen-weighted CE inside MiB; it
needs the seen detector, ``training.bg_detector``) the CE of a training
step is ``compute_base_loss``'s: the seen-weighted CE (K3) once old
classes exist, plain CE (K1) at task 0.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from bacs_tpu_torch.methods.base import Method, ModelContext, StepAux, proto_updates
from bacs_tpu_torch.ops import rng


class MiBMethod(Method):
    needs_prev_model = True

    def __init__(self, name: str = "MiB", bg_weighted_ce: bool = False,
                 lkd: float = 10.0, **kwargs):
        super().__init__(name=name, **kwargs)
        self.bg_weighted_ce = bg_weighted_ce
        self.lkd = lkd

    def compute_loss(
        self,
        ctx: ModelContext,
        state,
        batch: Dict[str, torch.Tensor],
        train: bool,
        key: Optional[rng.Key] = None,
    ) -> Tuple[torch.Tensor, StepAux]:
        image, mask = batch["image"], batch["label"]
        if self.bg_weighted_ce and train:
            base = self.compute_base_loss(ctx, state, image, mask, train, key,
                                          use_weighted_ce=ctx.task.old_classes != 0)
            out, loss = base.out, base.loss
            updates = proto_updates(base)
        else:
            out = ctx.forward(state.model, image, train, key)
            loss = self._mib_ce(ctx, out, mask, train)
            updates = self.prototype_updates(ctx, state, out.penultimate, mask, train)
        if state.prev_model is not None and train:
            old_out = ctx.forward_prev(state, image)
            loss = loss + self.lkd * self.ukd_with_upsample(ctx, out, old_out, mask)
        return loss, StepAux(
            sem_logits=out.sem_logits[..., : ctx.n_cur],
            output=out,
            n_cur=ctx.n_cur,
            state_updates=updates,
        )

    def _mib_ce(self, ctx: ModelContext, out, mask, train: bool) -> torch.Tensor:
        """The unbiased CE (when old classes exist, in training; K6) or the
        plain CE (K1), each summed over the valid pixels and divided by N H W."""
        if ctx.task.old_classes == 0 or not train:
            return self.ce_over_all_pixels(ctx, out, mask)
        return self.uce_with_upsample(ctx, out, mask, over_all_pixels=True)
