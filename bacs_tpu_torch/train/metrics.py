"""Metric aggregation: per-prefix IoU and across-task results.

The port's copy of ``bacs_tpu/train/metrics.py`` (``detailed_iou_metrics``,
``PerStepResult``): numpy on the host, from a confusion matrix accumulated
on the device, through the port's ``ops/confusion.py:iou_from_confusion``.
It emits the reference's metric key strings (`test.<d>/Task <t>/<metric>`,
`Final/test.<d>/<metric>`; reference: training/metrics.py:20-156,
training/model.py:183-258).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

import torch

from bacs_tpu_torch.ops.confusion import iou_from_confusion


def detailed_iou_metrics(
    conf_mat: np.ndarray,
    initial_classes: int,
    nb_current_classes: int,
    class_names: Sequence[str] | None = None,
) -> Dict[str, float]:
    """Derive the reference's detailed IoU metric dict from a confusion matrix.

    IoU-Old  = mean IoU over classes [0, initial_classes)
    IoU-Old-nobg = same without background (class 0)
    IoU-New  = mean IoU over classes [initial_classes, nb_current_classes)
    mIoU     = mean over all active classes
    (reference: training/model.py:183-258)
    """
    active = np.asarray(conf_mat)[:nb_current_classes, :nb_current_classes]
    m = iou_from_confusion(torch.from_numpy(np.ascontiguousarray(active)))
    iou = np.asarray(m.iou_per_class)
    out: Dict[str, float] = {"mIoU": float(iou.mean())}
    init = min(initial_classes, nb_current_classes)
    if init > 0:
        out["IoU-Old"] = float(iou[:init].mean())
    if init > 1:
        out["IoU-Old-nobg"] = float(iou[1:init].mean())
    if nb_current_classes > init:
        out["IoU-New"] = float(iou[init:].mean())
    out["Accuracy"] = float(np.asarray(m.accuracy).mean())
    out["Precision"] = float(np.asarray(m.precision).mean())
    out["Recall"] = float(np.asarray(m.recall).mean())
    # the reference's IoU.compute derives specificity alongside the others
    # (reference: training/metrics.py:73-85) though Model._log_iou never
    # surfaced it; exposed here so reports carry the full confusion-derived set
    out["Specificity"] = float(np.asarray(m.specificity).mean())
    if class_names is not None:
        for i, name in enumerate(class_names[: len(iou)]):
            out[f"IoU-{name}"] = float(iou[i])
    return out


class PerStepResult:
    """Across-task aggregation of per-dataset test metrics.

    Keys and shapes mirror the reference exactly
    (reference: training/metrics.py:105-156).
    """

    METRICS = ("mIoU", "IoU-Old", "IoU-Old-nobg", "IoU-New")

    def __init__(self, continual: bool):
        self.continual = continual
        self.task_id = 0
        self._per_step: Dict[str, List[List[float]]] = {
            m: [] for m in self.METRICS
        }

    def update(self, final_result: List[Dict[str, float]]) -> None:
        """final_result: one metric dict per test dataset for this task."""
        for metric in self.METRICS:
            self._per_step[metric].append([])
        for dataset_id, result in enumerate(final_result):
            for metric in self.METRICS:
                if self.continual:
                    key = f"test.{dataset_id}/Task {self.task_id}/{metric}"
                else:
                    key = f"test.{dataset_id}/{metric}"
                if key in result:
                    self._per_step[metric][-1].append(result[key])
        self.task_id += 1

    def get_avg_iou(self) -> np.ndarray:
        """Avg-IoU = per-dataset mean of mIoU over the tasks that evaluated it
        (the per-task dataset list grows by one each task, so rows are padded
        with NaN and nan-averaged; reference: metrics.py:143-146)."""
        rows = self._per_step["mIoU"]
        width = max(len(r) for r in rows)
        mat = np.full((len(rows), width), np.nan)
        for i, r in enumerate(rows):
            mat[i, : len(r)] = r
        return np.nanmean(mat, axis=0)

    def compute(self) -> Dict[str, object]:
        results: Dict[str, object] = {}
        for metric in self.METRICS:
            results[metric] = self._per_step[metric][-1]
        results["Avg-IoU"] = self.get_avg_iou()
        return results

    @property
    def final_miou(self) -> float:
        """The scalar Trainer.fit returns (reference: trainer.py:432-433)."""
        last = self._per_step["mIoU"][-1]
        return float(last[-1]) if last else float("nan")
