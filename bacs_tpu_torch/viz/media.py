"""Segmentation media: the VOC palette and prediction collages on disk.

Port of ``bacs_tpu/viz/media.py``: :func:`voc_colormap`, and
:class:`MediaLogger` (``:36-127``), which keeps the last batches per split
and writes one input | ground truth | prediction collage PNG per split at
a task's end with PIL, and hands the masks to wandb where the logger has
it (neither machine the port runs on does; the call then returns).  The
arrays are numpy on the host; tensors handed in are copied there.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Deque, Dict, Optional

import numpy as np
import torch

from bacs_tpu_torch.data.transforms import denormalize_image


def voc_colormap(n: int = 256) -> np.ndarray:
    """[n, 3] uint8 VOC palette: the bits of the class id spread over RGB."""
    cmap = np.zeros((n, 3), np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _pixels(image: np.ndarray) -> np.ndarray:
    """Normalized float [N, H, W, 3] -> uint8 pixels."""
    return denormalize_image(torch.from_numpy(np.asarray(image, np.float32))).numpy()


class MediaLogger:
    """Keeps the last ``max_len`` batches per split, ``max_samples`` images
    of each, and writes collages at a task's end (reference: LogMediaQueue,
    base_medialogger.py:14-53)."""

    def __init__(self, out_dir: str, max_len: int = 3, max_samples: int = 8):
        self.out_dir = out_dir
        self.max_samples = max_samples
        self.queues: Dict[str, Deque] = {}
        self.max_len = max_len
        self.cmap = voc_colormap()

    def append(self, split: str, image, label, pred) -> None:
        q = self.queues.setdefault(split, deque(maxlen=self.max_len))
        q.append(tuple(_host(a[: self.max_samples]) for a in (image, label, pred)))

    def _colorize(self, labels: np.ndarray) -> np.ndarray:
        return self.cmap[np.clip(labels, 0, 255)]

    def flush(self, task_id: int) -> Optional[str]:
        """One collage per split, ``task<t>_<split>.png``: a row per sample,
        columns input | ground truth | prediction (reference:
        log_media.py:141-290).  Returns the last path written."""
        from PIL import Image

        os.makedirs(self.out_dir, exist_ok=True)
        last_path = None
        for split, q in self.queues.items():
            if not q:
                continue
            image, label, pred = q[-1]
            img_u8 = _pixels(image)
            collage = np.concatenate(
                [np.concatenate([img_u8[i], self._colorize(label[i]), self._colorize(pred[i])],
                                axis=1) for i in range(image.shape[0])], axis=0)
            path = os.path.join(self.out_dir, f"task{task_id}_{split.replace('/', '_')}.png")
            Image.fromarray(collage).save(path)
            last_path = path
        return last_path

    def log_wandb(self, logger, task_id: int, class_names=None) -> None:
        """One wandb Image per sample with prediction and ground-truth mask
        layers under ``<Split>/Task <t>/Predictions`` (reference:
        log_media.py:265-290; "groud_truth" is the reference's spelling,
        kept so that the panels line up).  Returns where the logger has no
        ``_wandb``."""
        wandb = getattr(logger, "_wandb", None)
        if wandb is None:
            return
        class_labels = ({i: str(n) for i, n in enumerate(class_names)}
                        if class_names else None)
        for split, q in self.queues.items():
            if not q:
                continue
            image, label, pred = q[-1]
            imgs = _pixels(image)
            mask_list = []
            for i in range(imgs.shape[0]):
                masks = {"predictions": {"mask_data": np.asarray(pred[i], np.uint8)},
                         "groud_truth": {"mask_data": np.asarray(label[i], np.uint8)}}
                if class_labels is not None:
                    for layer in masks.values():
                        layer["class_labels"] = class_labels
                mask_list.append(wandb.Image(imgs[i], masks=masks))
            wandb.log({f"{split.title()}/Task {task_id}/Predictions": mask_list},
                      commit=False)
