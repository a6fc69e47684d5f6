"""SDR: prototype matching, contrastive separation, sparsity, distillation.

Port of ``bacs_tpu/methods/sdr.py`` (reference loss/sdr.py).  The JAX
method replaces the reference's data-dependent loops over the classes
present with fixed loops over the class count and presence masks; this
keeps them, so that every intermediate is JAX's:

- per-class running-mean prototypes in ``state.class_prototypes`` and
  ``class_proto_counts`` (``_update_class_prototypes``, reference
  sdr.py:79-158): the true per-class mean, a documented departure from the
  reference, which mixes feature dimensions when a class spans several
  images (``docs/PARITY.md``);
- feature clustering toward the prototypes with the reference's literal
  "divide the accumulator by the count of present classes at every present
  class" recurrence, plus the inverse pairwise distances of the class
  means (``_clustering_separation``, sdr.py:160-207);
- feature sparsification (``_feature_sparsification``, sdr.py:209-242);
- prototype distillation on the background pixels pseudo-labelled by the
  previous model (``_proto_distillation``, sdr.py:244-280);
- loss_kd times MiB's unbiased KD (K7, ``ukd_with_upsample``).

The objective is plain CE at task 0 (K1) and the unbiased CE at a task > 0
(K6), both means over the valid pixels.  The prototype terms work on the
[N, h, w, D] backbone features in plain PyTorch, as JAX computes them
outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from bacs_tpu_torch.methods.base import Method, ModelContext, StepAux
from bacs_tpu_torch.ops.interpolate import resize_nearest
from bacs_tpu_torch.ops.upsample_ce import upsampled_argmax_nearest

EPS = 1e-15


def _one_hot(labels: torch.Tensor, c: int) -> torch.Tensor:
    """f32 one-hot of integer labels; a label outside [0, c) gives a row of
    zeros (``jax.nn.one_hot``)."""
    return (torch.arange(c, device=labels.device) == labels.unsqueeze(-1)).float()


class SDRMethod(Method):
    needs_prev_model = True
    needs_class_prototypes = True

    def __init__(
        self,
        name: str = "SDR",
        lfc_sep_clust: float = 1e-3,
        loss_fc: float = 1e-3,
        loss_featspars: float = 1e-3,
        loss_de_prototypes: float = 0.01,
        loss_kd: float = 100.0,
        sequential_mode: bool = False,
        **kwargs,
    ):
        super().__init__(name=name, **kwargs)
        self.lfc_sep_clust = lfc_sep_clust
        self.loss_fc = loss_fc
        self.loss_featspars = loss_featspars
        self.loss_de_prototypes = loss_de_prototypes
        self.loss_kd = loss_kd
        self.sequential_mode = sequential_mode

    # ------------------------------------------------------------------

    def compute_loss(
        self,
        ctx: ModelContext,
        state,
        batch: Dict[str, torch.Tensor],
        train: bool,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, StepAux]:
        task = ctx.task
        image, mask = batch["image"], batch["label"]
        out = ctx.forward(state.model, image, train, generator)
        sem = out.sem_logits[..., : ctx.n_cur]
        if task.task_id > 0:
            loss = self.uce_with_upsample(ctx, out, mask)
        else:
            loss = self.ce_with_upsample(ctx, sem, out, mask)
        updates: Dict[str, Any] = {}
        if train and task.task_id > 0 and state.prev_model is not None:
            terms = self.distill_terms(ctx, state, out, image, mask)
            updates = {"class_prototypes": terms.pop("class_prototypes"),
                       "class_proto_counts": terms.pop("class_proto_counts")}
            for term in terms.values():
                loss = loss + term
        return loss, StepAux(sem_logits=sem, output=out, n_cur=ctx.n_cur,
                             state_updates=updates)

    def distill_terms(self, ctx: ModelContext, state, out, image, mask) -> Dict[str, Any]:
        """The task > 0 terms, each weighted, in the order the loss adds
        them, and the updated class prototypes and counts."""
        task = ctx.task
        feats = out.penultimate
        protos, counts = self._update_class_prototypes(state, feats, mask, task)
        old_out = ctx.forward_prev(state, image)
        return {
            "class_prototypes": protos,
            "class_proto_counts": counts,
            "sparsification": self._feature_sparsification(mask, feats, task),
            "clustering_separation": self._clustering_separation(mask, feats, protos, task),
            "proto_distillation": self._proto_distillation(ctx, old_out, feats, mask,
                                                           protos, task),
            "ukd": self.loss_kd * self.ukd_with_upsample(ctx, out, old_out, mask),
        }

    # ------------------------------------------------------------------

    @staticmethod
    def _class_masks(mask, hw, task):
        """(labels nearest-downsampled to ``hw`` [N, h, w], their one-hot over
        the current classes [N, h, w, C], zero at ignored pixels)."""
        labels_down = resize_nearest(mask, hw)
        valid = labels_down != task.ignore_index
        safe = torch.where(valid, labels_down, 0)
        return labels_down, _one_hot(safe, task.nb_current_classes) * valid.unsqueeze(-1)

    @torch.no_grad()
    def _update_class_prototypes(self, state, feats, mask, task):
        """The batch folded into the per-class running means (the
        background skipped at a task > 0 unless ``sequential_mode``,
        reference sdr.py:121-158); returns (prototypes [num_classes, D],
        counts [num_classes])."""
        f = feats.float()
        _, onehot = self._class_masks(mask, tuple(f.shape[1:3]), task)
        if not self.sequential_mode and task.task_id > 0:
            onehot[..., 0] = 0.0
        sums = torch.einsum("nhwc,nhwd->cd", onehot, f)
        n = onehot.sum(dim=(0, 1, 2))
        pad = task.num_classes - n.shape[0]
        sums = torch.nn.functional.pad(sums, (0, 0, 0, pad))
        n = torch.nn.functional.pad(n, (0, pad))
        counts, protos = state.class_proto_counts, state.class_prototypes
        new_counts = counts + n
        new_protos = torch.where(
            (n > 0)[:, None],
            (sums + counts[:, None] * protos) / torch.clamp(new_counts, min=1.0)[:, None],
            protos)
        return new_protos, new_counts

    def _clustering_separation(self, mask, feats, protos, task):
        """loss_fc times the clustering term (each present class's mean
        squared distance to its prototype, through the reference's
        accumulate-then-divide recurrence, sdr.py:180-186) plus
        lfc_sep_clust times the mean inverse distance between the present
        classes' means (reference sdr.py:160-207)."""
        c_cur = task.nb_current_classes
        f = feats.float()
        _, onehot = self._class_masks(mask, tuple(f.shape[1:3]), task)
        n_pix = onehot.sum(dim=(0, 1, 2))
        present = n_pix > 0
        sums = torch.einsum("nhwc,nhwd->cd", onehot, f)
        sq_sums = torch.einsum("nhwc,nhwd->cd", onehot, torch.square(f))
        p = protos[:c_cur]
        denom = torch.clamp(n_pix, min=1.0)[:, None]
        # E[(x - p)^2] = E[x^2] - 2 p E[x] + p^2 per dimension, mean over them
        mse_c = (sq_sums / denom - 2 * p * (sums / denom) + torch.square(p)).mean(dim=1)
        mse_c = torch.where(present, mse_c, 0.0)
        n_present = torch.clamp(present.sum(), min=1).float()
        acc = torch.zeros((), device=f.device)
        for c in range(c_cur):  # every class, absent ones leave acc as it is
            acc = torch.where(present[c], (acc + mse_c[c]) / n_present, acc)
        means = sums / denom
        diff = means[:, None, :] - means[None, :, :]
        dist = torch.sqrt(torch.square(diff).sum(dim=-1) + 1e-12)
        eye = torch.eye(c_cur, dtype=torch.bool, device=f.device)
        pair_ok = present[:, None] & present[None, :] & ~eye
        inv = torch.where(pair_ok, 1.0 / torch.clamp(dist, min=1e-12), 0.0)
        n_pairs = pair_ok.sum()
        sep = torch.where(n_pairs > 0, inv.sum() / torch.clamp(n_pairs, min=1), 0.0)
        return self.loss_fc * acc + self.lfc_sep_clust * sep

    def _feature_sparsification(self, mask, feats, task):
        """loss_featspars times the mean over pixels of Σ exp(x̂) / Σ x̂ of
        the features normalised by their group's largest value (reference
        sdr.py:209-242), the groups being the raw downsampled labels, the
        ignored pixels a group of their own; 0 when only background is
        present or the normalised features sum to at most 0 (the JAX
        method's docstring gives the reference's reasons)."""
        f = feats.float()
        labels_down, _ = self._class_masks(mask, tuple(f.shape[1:3]), task)
        c_cur = task.nb_current_classes
        grp = torch.where(labels_down == task.ignore_index, c_cur, labels_down).long()
        pix_max = f.amax(dim=-1)
        grp_max = torch.full((c_cur + 1,), -torch.inf, device=f.device).scatter_reduce(
            0, grp.reshape(-1), pix_max.reshape(-1), reduce="amax")
        features_norm = f / (grp_max[grp].unsqueeze(-1) + EPS)
        only_bg = (grp == 0).all()
        features_norm = torch.where(only_bg, 0.0, features_norm)
        total = features_norm.sum()
        shrink = torch.exp(features_norm).sum(dim=-1, keepdim=True)
        summed = features_norm.sum(dim=-1, keepdim=True)
        ratio = (shrink / (summed + EPS)).mean()
        return self.loss_featspars * torch.where(total > 0, ratio, 0.0)

    def _proto_distillation(self, ctx, old_out, feats, mask, protos, task):
        """loss_de_prototypes times the mean, over the old classes present,
        of the squared distance between the mean feature of the background
        pixels the previous model labels with that class and the class's
        prototype (reference sdr.py:244-280).  The previous model's labels
        are its full-resolution argmax nearest-downsampled; below label
        resolution only the picked rows and columns are interpolated
        (``upsampled_argmax_nearest``)."""
        f = feats.float()
        hw = tuple(f.shape[1:3])
        labels_down = resize_nearest(mask, hw)
        c_old = task.old_classes
        if self.sequential_mode:
            pseudo = labels_down * (labels_down < c_old)
        else:
            sem_old = old_out.sem_logits[..., :c_old]
            if self._fused_gate(ctx, sem_old, mask):
                old_down = upsampled_argmax_nearest(sem_old, tuple(mask.shape[1:3]), hw)
            else:
                old_down = resize_nearest(old_out.logits[..., :c_old].argmax(dim=-1), hw)
            pseudo = old_down * (labels_down == 0)
        onehot = _one_hot(pseudo, c_old)
        onehot[..., 0] = 0.0
        n = onehot.sum(dim=(0, 1, 2))
        present = n > 0
        cur_proto = torch.einsum("nhwc,nhwd->cd", onehot, f) / torch.clamp(n, min=1.0)[:, None]
        mse = torch.square(cur_proto - protos[:c_old].detach()).mean(dim=1)
        n_present = torch.clamp(present.sum(), min=1)
        return self.loss_de_prototypes * (torch.where(present, mse, 0.0).sum() / n_present)
