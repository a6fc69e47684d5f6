"""Seen-detector auxiliary evaluation.

Port of ``aux_bg_step`` and ``aux_bg_summary`` (``bacs_tpu/train/ood.py:
27-96``), which the task loop's test pass runs on every eval batch when the
background detector is on (reference: training/ood_model.py): the
detector's max seen-probability, thresholded at 0.5, is a binary fg/bg
prediction scored against the fg/bg ground truth (a 2-class confusion
matrix on the device), with the seen-probability's mean and variance over
the background, foreground, current-task and old-class pixels.  With the
context's process group each rank scores its slice of the batch and the
matrix and the statistics' sums are summed across the ranks, so they are
the global batch's, as the JAX step computes them on the sharded batch.

``ood_test`` is the OOD dataset pass, run after each task's test when the
config has an ``ood`` dataset and the detector is on: every pixel of that
dataset is unseen, and the last task head's seen-probability is scored
against that.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from bacs_tpu_torch.methods.base import ModelContext
from bacs_tpu_torch.ops.confusion import confusion_matrix, iou_from_confusion
from bacs_tpu_torch.parallel import all_reduce_


@torch.no_grad()
def aux_bg_step(ctx: ModelContext, state, batch: Dict[str, torch.Tensor],
                conf2: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One eval batch of the seen/unseen aux metrics (reference:
    ood_model.py:114-174 `step`); returns the updated [2, 2] int32 matrix
    and the batch's statistics (0-dim tensors, no host read)."""
    task = ctx.task
    ignore = task.ignore_index
    mask = batch["label"]
    out = ctx.forward(state.model, batch["image"], False)
    seen_prob = state.model.seen_probs(out.penultimate, state.prototypes,
                                       task.task_id + 1).amax(dim=-1)
    target = torch.where(mask == ignore, ignore, (mask != 0).to(mask.dtype))
    preds = (seen_prob > 0.5).to(torch.int32)
    group = ctx.group
    conf2 = conf2 + all_reduce_([confusion_matrix(preds, target, 2, ignore_index=ignore)],
                                group, mean=False)[0]

    def _stats(sel):
        sel = sel.float()
        total, count = all_reduce_([torch.stack([(seen_prob * sel).sum(), sel.sum()])],
                                   group, mean=False)[0]
        cnt = torch.clamp(count, min=1.0)
        mean = total / cnt
        sq = all_reduce_([(torch.square(seen_prob - mean) * sel).sum()], group, mean=False)[0]
        return mean, sq / cnt

    stats = {}
    stats["bg_prob_mean"], stats["bg_prob_var"] = _stats(target == 0)
    stats["fg_prob_mean"], stats["fg_prob_var"] = _stats(target == 1)
    cur = (target == 1) & (mask >= task.old_classes) & (mask <= task.nb_current_classes)
    stats["fg_current_prob_mean"], stats["fg_current_prob_var"] = _stats(cur)
    if task.old_classes > 0:
        old = (target != 0) & (mask <= task.old_classes)
        stats["old_cl_prob_mean"], stats["old_cl_prob_var"] = _stats(old)
    return conf2, stats


def aux_bg_summary(conf2: np.ndarray) -> Dict[str, float]:
    """2-class IoU summary with the reference's metric names
    (reference: ood_model.py:63-101 `_log_iou`)."""
    m = iou_from_confusion(torch.as_tensor(np.asarray(conf2)))
    iou = m.iou_per_class.numpy()
    return {
        "IoU-bg": float(iou[0]),
        "IoU-not-bg": float(iou[1]),
        "mIoU": float(iou.mean()),
        "Accuracy": float(m.accuracy.mean()),
        "Precision": float(m.precision.mean()),
        "Recall": float(m.recall.mean()),
    }


@torch.no_grad()
def ood_counts(ctx: ModelContext, state, batches: Iterable[Dict[str, torch.Tensor]]
               ) -> Tuple[int, int, List[float]]:
    """The OOD pass's device work (``bacs_tpu/train/ood.py:106-133``):
    (pixels predicted unseen, pixels predicted seen, each batch's mean
    seen-probability) of the LAST task head over every pixel of
    ``batches``, padded tail images included, as JAX counts every pixel of
    a batch.  The counts and sums stay on the device, are summed across
    ``ctx.group``'s ranks once at the end (a batch's mean is the global
    batch's), and are read once."""
    n_tasks = ctx.task.task_id + 1
    counts = None  # [predicted unseen, predicted seen], int64
    prob_sums, sizes = [], []
    for batch in batches:
        out = ctx.forward(state.model, batch["image"], False)
        seen_prob = state.model.seen_probs(out.penultimate, state.prototypes,
                                           n_tasks)[..., -1].float()
        n_seen = (seen_prob > 0.5).sum()
        batch_counts = torch.stack([seen_prob.numel() - n_seen, n_seen])
        counts = batch_counts if counts is None else counts + batch_counts
        prob_sums.append(seen_prob.sum())
        sizes.append(seen_prob.numel())
    if counts is None:
        return 0, 0, []
    sums = torch.stack(prob_sums)
    size = torch.tensor(sizes, dtype=torch.float32, device=sums.device)
    all_reduce_([counts, sums, size], ctx.group, mean=False)
    tp, fn = (int(v) for v in counts.cpu())
    return tp, fn, (sums / size).cpu().tolist()


def ood_test(ctx: ModelContext, state, batches: Iterable[Dict[str, torch.Tensor]]
             ) -> Dict[str, float]:
    """The OOD pass (``bacs_tpu/train/ood.py:98-142``; reference:
    ood_model.py:175-210 `test_step`): every pixel is unseen, and the last
    task head's seen-probability, thresholded at 0.5, is scored with
    pos_label 0 (:func:`ood_counts`).  As in JAX: F1 takes precision as 1
    (no pixel is seen, so there is no false positive), accuracy is the
    unseen share, and ``ood_detection_prob_mean`` is the mean of the
    per-batch means.  (JAX also computes each batch's variance and drops
    it; so nothing here.)"""
    return ood_summary(*ood_counts(ctx, state, batches))


def ood_summary(tp: int, fn: int, means: List[float]) -> Dict[str, float]:
    """:func:`ood_test`'s metrics of :func:`ood_counts`'s figures."""
    recall = tp / max(tp + fn, 1)
    return {
        "F1_score_current": 2 * recall / (1 + recall) if recall > 0 else 0.0,
        "Accuracy_current": tp / max(tp + fn, 1),
        "ood_detection_prob_mean": float(np.mean(means)) if means else 0.0,
    }
