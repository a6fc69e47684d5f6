"""Confusion-matrix accumulation and the IoU metrics derived from it.

Port of ``bacs_tpu/ops/confusion.py``.  The matrix stays on the device and
is added to per eval batch; nothing reaches the host until the metrics are
read.  :func:`confusion_matrix` is also the second half of the
upsample+argmax+confusion kernel's plain version
(``ops/upsample_confusion.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def confusion_matrix(
    preds: torch.Tensor,
    labels: torch.Tensor,
    num_classes: int,
    ignore_index: int = 255,
) -> torch.Tensor:
    """int32 [num_classes, num_classes]; rows are targets, columns
    predictions.

    Pixels whose label lies outside [0, num_classes) are dropped (which
    drops ``ignore_index`` too); predictions are clipped into range.
    """
    t = labels.reshape(-1).long()
    p = preds.reshape(-1).long().clamp(0, num_classes - 1)
    valid = (t >= 0) & (t < num_classes)
    idx = t[valid] * num_classes + p[valid]
    counts = torch.bincount(idx, minlength=num_classes * num_classes)
    return counts.to(torch.int32).reshape(num_classes, num_classes)


class IouMetrics(NamedTuple):
    """Per-class metric vectors of an accumulated confusion matrix."""

    iou_per_class: torch.Tensor
    miou: torch.Tensor
    accuracy: torch.Tensor
    precision: torch.Tensor
    recall: torch.Tensor
    specificity: torch.Tensor


def iou_from_confusion(conf_mat: torch.Tensor) -> IouMetrics:
    """IoU, accuracy, precision, recall and specificity per class.

    A ratio whose denominator is 0 (a class absent from both targets and
    predictions) is 0, and ``miou`` is the mean over all classes, as in the
    JAX package.
    """
    cm = conf_mat.float()
    tp = torch.diagonal(cm)
    fn = cm.sum(dim=1) - tp  # row sum = target count
    fp = cm.sum(dim=0) - tp  # column sum = predicted count
    tn = cm.sum() - (tp + fn + fp)

    def safe(num, den):
        return torch.where(den > 0, num / torch.clamp(den, min=1.0),
                           torch.zeros_like(num))

    iou = safe(tp, tp + fp + fn)
    return IouMetrics(
        iou_per_class=iou,
        miou=iou.mean(),
        accuracy=safe(tp + tn, tp + fp + fn + tn),
        precision=safe(tp, tp + fp),
        recall=safe(tp, tp + fn),
        specificity=safe(tn, tn + fp),
    )
