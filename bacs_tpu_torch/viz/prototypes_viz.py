"""Prototype space: a t-SNE scatter and distance-to-prototype bars.

Port of ``bacs_tpu/viz/prototypes_viz.py`` (reference:
visualization/log_prototypes.py:119-248): :meth:`PrototypeLogger.collect`
takes the per-class mean penultimate feature over up to ``max_batches``
eval batches (nearest-resized labels, 255 ignored, float32 features),
summed on the device and across the context's ranks; :meth:`plot` embeds
the class means with the stored task prototypes by t-SNE and draws each
class mean's L1 distance to its task's prototype, ``tsne_task<t>.png`` and
``proto_dist_task<t>.png``.  matplotlib and scikit-learn are imported by
``plot`` alone, as in JAX.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from bacs_tpu_torch.methods.base import ModelContext, label_task_ids
from bacs_tpu_torch.ops.interpolate import resize_nearest
from bacs_tpu_torch.parallel import all_reduce_


class PrototypeLogger:
    def __init__(self, out_dir: str, max_batches: int = 8):
        self.out_dir = out_dir
        self.max_batches = max_batches

    @torch.no_grad()
    def collect(self, ctx: ModelContext, state, batches) -> Dict[str, np.ndarray]:
        """Per-class mean penultimate features over at most ``max_batches``
        batches: ``{"class_means": [C, D], "counts": [C]}``.  With
        ``ctx.group`` each rank takes its slice of a batch and the sums are
        summed across the ranks."""
        task = ctx.task
        classes = torch.arange(task.num_classes, device=state.prototypes.device)
        sums = torch.zeros((task.num_classes, state.prototypes.shape[-1]),
                           device=state.prototypes.device)
        counts = torch.zeros((task.num_classes,), device=state.prototypes.device)
        for i, batch in enumerate(batches):
            if i >= self.max_batches:
                break
            feats = ctx.forward(state.model, batch["image"], False).penultimate.float()
            lbl = resize_nearest(batch["label"], tuple(feats.shape[1:3]))
            valid = lbl != task.ignore_index
            # a label outside [0, C) gets a zero row, as jax.nn.one_hot gives
            onehot = ((torch.where(valid, lbl, 0)[..., None] == classes)
                      & valid[..., None]).float()
            sums += torch.einsum("nhwc,nhwd->cd", onehot, feats)
            counts += onehot.sum(dim=(0, 1, 2))
        all_reduce_([sums, counts], ctx.group, mean=False)
        sums, counts = sums.cpu().numpy(), counts.cpu().numpy()
        return {"class_means": sums / np.maximum(counts[:, None], 1.0), "counts": counts}

    def plot(self, ctx: ModelContext, state, collected: Dict, task_id: int) -> List[str]:
        """The two plots of ``collected`` beside the first ``task_id + 1``
        prototypes; returns the paths written (none for a model whose
        features are not finite)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from sklearn.manifold import TSNE

        os.makedirs(self.out_dir, exist_ok=True)
        means = collected["class_means"]
        present = collected["counts"] > 0
        protos = state.prototypes[: task_id + 1].float().cpu().numpy()
        paths = []

        # t-SNE of class means + prototypes (log_prototypes.py:119-178)
        pts = np.concatenate([means[present], protos], axis=0)
        if not np.isfinite(pts).all():
            return paths  # a diverged model: nothing meaningful to embed
        if pts.shape[0] >= 3:
            emb = TSNE(n_components=2, perplexity=min(5, pts.shape[0] - 1),
                       init="random").fit_transform(pts)
            n_cls = int(present.sum())
            fig, ax = plt.subplots(figsize=(6, 5))
            ax.scatter(emb[:n_cls, 0], emb[:n_cls, 1], c="tab:blue", label="class mean")
            ax.scatter(emb[n_cls:, 0], emb[n_cls:, 1], c="tab:red", marker="*", s=120,
                       label="task prototype")
            for i, cls in enumerate(np.where(present)[0]):
                ax.annotate(str(cls), emb[i])
            ax.legend()
            p = os.path.join(self.out_dir, f"tsne_task{task_id}.png")
            fig.savefig(p, dpi=100)
            plt.close(fig)
            paths.append(p)

        # L1 distance of each class mean to its task prototype (:180-248)
        task_of_class = label_task_ids(torch.arange(means.shape[0]), ctx.task).numpy()
        classes = np.where(present)[0]
        dists = [np.abs(means[c] - protos[min(int(task_of_class[c]), protos.shape[0] - 1)]).mean()
                 for c in classes]
        if len(classes):
            fig, ax = plt.subplots(figsize=(6, 3))
            ax.bar([str(c) for c in classes], dists)
            ax.set_ylabel("L1 to task prototype")
            p = os.path.join(self.out_dir, f"proto_dist_task{task_id}.png")
            fig.savefig(p, dpi=100)
            plt.close(fig)
            paths.append(p)
        return paths
