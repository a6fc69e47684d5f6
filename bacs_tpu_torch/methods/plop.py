"""PLOP: entropy-gated pseudo-labels + local POD distillation.

Port of ``bacs_tpu/methods/plop.py``:

- ``begin_task`` (task > 0): one pass over the task's batches with the
  frozen previous model builds per-class 100-bin histograms of the
  normalised entropy of the background pixels, on the device with no host
  read per batch; the host then takes each class's median with the
  reference's literal recurrence (``_median_from_histogram``), floored at
  0.001.  The thresholds and the entropy normaliser log(C_cur) go into the
  ``TrainState``.
- the loss at a task > 0 in training: the background and old-class pixels
  take the previous model's prediction where its entropy is below the
  class's threshold and are ignored elsewhere (K9); the CE of those labels
  per image (K1's forward, K8 its backward) weighted by the image's share
  of confident pixels (the adaptive factor), summed and divided by N H W;
  plus local POD over the four backbone attentions, the ASPP output and the
  logits (factors 0.01 and 0.0005 for the logits).  Without a previous
  model, and in evaluation, plain CE with the same reduction (K1).
  Above label resolution the composed losses run on the full-resolution
  logits (``ops/upsample_pseudo.pseudo_labels``, K9's plain core).

With ``bg_weighted_ce`` (BACS's seen-weighted CE inside PLOP; it needs
the seen detector) ``begin_task`` computes no thresholds and a training
step takes ``compute_base_loss``'s CE: seen-weighted (K3) with a previous
model, plain (K1) without; the local POD then covers the attentions only,
not the logits (``bacs_tpu/methods/plop.py:102-112``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from bacs_tpu_torch.methods.base import Method, ModelContext, StepAux, proto_updates
from bacs_tpu_torch.ops import rng
from bacs_tpu_torch.ops.losses import cross_entropy, features_distillation, pixel_entropy
from bacs_tpu_torch.ops.upsample_ce import upsampled_ce_sums_per_image
from bacs_tpu_torch.ops.upsample_pseudo import pseudo_labels, upsampled_plop_pseudo_labels

NB_BINS = 100


class PlopMethod(Method):
    needs_prev_model = True

    def __init__(self, name: str = "Plop", bg_weighted_ce: bool = False, **kwargs):
        super().__init__(name=name, **kwargs)
        self.bg_weighted_ce = bg_weighted_ce

    # ------------------------------------------------------------------

    def begin_task(self, state, ctx: ModelContext, data: Any):
        """The entropy thresholds of task ``ctx.task`` (> 0) from the
        previous model's predictions on ``data`` (batches of device
        tensors), one host read at the end."""
        task = ctx.task
        if task.task_id == 0 or self.bg_weighted_ce:
            return state
        hist = self.entropy_histogram(state, ctx, data)
        device = next(state.model.parameters()).device
        state.plop_thresholds = entropy_thresholds(hist, task.num_classes).to(device)
        state.plop_max_entropy = torch.tensor(math.log(task.nb_current_classes),
                                              dtype=torch.float32, device=device)
        return state

    @torch.no_grad()
    def entropy_histogram(self, state, ctx: ModelContext, data: Any) -> torch.Tensor:
        """int64 [C_cur, 100]: per predicted class, the 100-bin histogram of
        the previous model's entropy (normalised, then divided by log C_cur
        again: the reference's double normalisation) over the pixels
        labelled 0.  The step's mask is label < C_old instead (the
        reference's two quirks, kept)."""
        c_cur, c_old = ctx.task.nb_current_classes, ctx.task.old_classes
        hist = torch.zeros((c_cur, NB_BINS), dtype=torch.int64,
                           device=next(state.model.parameters()).device)
        for batch in data:
            old = ctx.forward_prev(state, batch["image"])
            add_entropy_histogram(hist, old.logits[..., :c_old], batch["label"])
        return hist

    # ------------------------------------------------------------------

    def compute_loss(
        self,
        ctx: ModelContext,
        state,
        batch: Dict[str, torch.Tensor],
        train: bool,
        key: Optional[rng.Key] = None,
    ) -> Tuple[torch.Tensor, StepAux]:
        task = ctx.task
        image, mask = batch["image"], batch["label"]
        distill = state.prev_model is not None and train
        old_out = None
        if self.bg_weighted_ce:
            base = self.compute_base_loss(ctx, state, image, mask, train, key,
                                          use_weighted_ce=distill, need_old_out=distill)
            out, old_out, loss = base.out, base.old_out, base.loss
            updates = proto_updates(base)
        else:
            out = ctx.forward(state.model, image, train, key)
            if distill:
                old_out = ctx.forward_prev(state, image)
                loss = self._pseudo_ce(ctx, state, out, old_out, mask)
            else:
                loss = self.ce_over_all_pixels(ctx, out, mask)
            updates = self.prototype_updates(ctx, state, out.penultimate, mask, train)
        if old_out is not None:
            atts_old, atts_new = old_out.attentions, out.attentions
            if not self.bg_weighted_ce:  # the logits join the POD
                atts_old += (old_out.sem_logits[..., : task.old_classes],)
                atts_new += (out.sem_logits[..., : ctx.n_cur],)
            loss = loss + features_distillation(
                atts_old, atts_new,
                index_new_class=task.old_classes,
                nb_current_classes=task.nb_current_classes,
                nb_new_classes=task.nb_new_classes,
                pod_factor=0.01, last_layer_factor=0.0005, spp_scales=(1, 2, 4))
        return loss, StepAux(
            sem_logits=out.sem_logits[..., : ctx.n_cur],
            output=out,
            n_cur=ctx.n_cur,
            state_updates=updates,
        )

    def _pseudo_ce(self, ctx: ModelContext, state, out, old_out, mask) -> torch.Tensor:
        """The pseudo-label CE, each image's term weighted by its adaptive
        factor, summed and divided by N H W."""
        old = ctx.task.old_classes
        sem = out.sem_logits[..., : ctx.n_cur]
        if self._fused_gate(ctx, sem, mask):
            hw = tuple(mask.shape[1:3])
            pseudo, num, den = upsampled_plop_pseudo_labels(
                old_out.sem_logits[..., :old].contiguous(), mask, state.plop_thresholds,
                hw, state.plop_max_entropy, self.ignore_index)
            factor = adaptive_factor(num, den)
            sums, _ = upsampled_ce_sums_per_image(sem.contiguous(), pseudo, hw,
                                                  self.ignore_index)
            return (factor * sums).sum() / mask.numel()
        # the composed path: the same pseudo-labels of the full-resolution
        # teacher logits (reference plop_loss.py:67-124)
        pseudo, num, den = pseudo_labels(old_out.logits[..., :old], mask, state.plop_thresholds,
                                         state.plop_max_entropy, self.ignore_index)
        nll = cross_entropy(out.logits[..., : ctx.n_cur], pseudo, self.ignore_index,
                            reduction="none")
        return (adaptive_factor(num, den)[:, None, None] * nll).mean()


def add_entropy_histogram(hist: torch.Tensor, old_logits: torch.Tensor,
                          labels: torch.Tensor) -> None:
    """Add to ``hist`` (int64 [C_cur, 100]) the pixels labelled 0 of one
    batch of full-resolution teacher logits [N, H, W, C_old], binned by
    their predicted class and their entropy divided by log C_cur."""
    probs = torch.softmax(old_logits, dim=-1)
    vals = pixel_entropy(probs) / math.log(hist.shape[0])
    bins = (vals * NB_BINS).long().clamp(0, NB_BINS - 1)
    idx = probs.argmax(dim=-1) * NB_BINS + bins
    hist.view(-1).index_add_(0, idx.reshape(-1), (labels == 0).reshape(-1).long())


def entropy_thresholds(hist: torch.Tensor, num_classes: int) -> torch.Tensor:
    """f32 [num_classes]: each class's median of ``hist`` (the reference's
    recurrence, floored at 0.001), 0 past C_cur; one host read."""
    full = np.zeros((num_classes,), np.float32)
    full[: hist.shape[0]] = _median_from_histogram(hist.cpu().numpy(), base_threshold=0.001)
    return torch.from_numpy(full)


def adaptive_factor(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """PLOP's per-image classification factor: the share of the image's
    background and old-class pixels that took a pseudo-label (the JAX
    method's ``classif_adaptive_factor``, always on)."""
    return torch.clamp(num / torch.clamp(den, min=1.0), min=0.0)


def _median_from_histogram(histograms: np.ndarray,
                           base_threshold: float = 0.001) -> np.ndarray:
    """The reference's literal histogram-median recurrence (reference
    training/utils.py:110-145, as the original PLOP release has it, its
    running sum adding bin indices, not counts: kept for parity; a copy of
    ``bacs_tpu/methods/plop.py:_median_from_histogram``)."""
    c, nb_bins = histograms.shape
    thresholds = np.zeros((c,), np.float32)
    for cls in range(c):
        total = histograms[cls].sum()
        if total <= 0:
            thresholds[cls] = base_threshold
            continue
        half = total / 2
        running_sum = 0.0
        lower_border = 0.0
        bin_index = 0
        for b in range(nb_bins):
            lower_border = b / nb_bins
            bin_index = int(lower_border * nb_bins)
            if running_sum <= half <= (running_sum + histograms[cls, bin_index]):
                break
            running_sum += lower_border * nb_bins
        median = lower_border + (
            (half - running_sum) / max(histograms[cls, bin_index], 1)) * (1.0 / nb_bins)
        thresholds[cls] = max(median, base_threshold)
    return thresholds
