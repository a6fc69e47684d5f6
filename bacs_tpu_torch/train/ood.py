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
the global batch's, as the JAX step computes them on the sharded batch.  The OOD
dataset pass (``ood_test``) is ROADMAP.md queue 1 item 14 and raises.
"""

from __future__ import annotations

from typing import Dict, Tuple

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


def ood_test(*args, **kwargs):
    raise NotImplementedError("the OOD dataset pass is ROADMAP.md queue 1 item 14")
