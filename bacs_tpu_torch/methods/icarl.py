"""iCaRL: BCE against one-hot targets, the old channels distilled.

Port of ``bacs_tpu/methods/icarl.py`` (reference loss/icarl_loss.py;
training/loss_utils.py:591-620).  With a previous model, in training, the
loss is ``icarl_criterion`` of the full-resolution logits against the
previous model's sigmoid on the old classes (the mean over all pixels);
otherwise the plain CE of the full-resolution logits (the mean over the
valid pixels).  JAX computes both on the full-resolution logits, outside
any Pallas kernel, and so does this: at 512^2 in f32 each [N, H, W, C]
tensor is about 0.26 GB an image batch of 12 at 21 classes.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from bacs_tpu_torch.methods.base import Method, ModelContext, StepAux
from bacs_tpu_torch.ops import rng
from bacs_tpu_torch.ops.losses import cross_entropy, icarl_criterion


class IcarlMethod(Method):
    needs_prev_model = True

    def __init__(self, name: str = "Icarl", **kwargs):
        super().__init__(name=name, **kwargs)

    def compute_loss(
        self,
        ctx: ModelContext,
        state,
        batch: Dict[str, torch.Tensor],
        train: bool,
        key: Optional[rng.Key] = None,
    ) -> Tuple[torch.Tensor, StepAux]:
        image, mask = batch["image"], batch["label"]
        out = ctx.forward(state.model, image, train, key)
        logits = out.logits[..., : ctx.n_cur]
        if state.prev_model is not None and train:
            old = ctx.forward_prev(state, image).logits[..., : ctx.task.old_classes]
            loss = icarl_criterion(logits, mask, torch.sigmoid(old.float()), bkg=False,
                                   ignore_index=self.ignore_index)
        else:
            loss = cross_entropy(logits, mask, self.ignore_index)
        return loss, StepAux(
            sem_logits=out.sem_logits[..., : ctx.n_cur],
            output=out,
            n_cur=ctx.n_cur,
            state_updates=self.prototype_updates(ctx, state, out.penultimate, mask, train),
        )
