"""Method base: the forward helpers and the CE / BACS core of a step.

Port of ``bacs_tpu/methods/base.py``.  A ``Method`` is stateless:
``compute_loss`` runs the network on a batch and returns the scalar loss
and a ``StepAux`` with the state updates the train step applies
(prototypes and their counts, the buffer).  The network, its statistics,
the previous model, the prototypes and the buffer live in the
``TrainState``; what is static per task lives in the ``ModelContext``.

Ported: ``compute_base_loss`` (``methods/base.py:386-533``): the CE or
class-weighted CE through ``_fused_gate`` (``:255-274``) to K1 or K4, the
BACS seen-probability-weighted CE through the same gate to K3, the
prototype folds (``update_task_prototypes``, ``:129-163``, detached), the
frozen previous model's forward (``forward_prev``, under ``no_grad``) and
the seen detector's focal term; the unbiased CE of MiB and SDR through the
same gate to K6 (``uce_with_upsample``, ``:326``), their unbiased KD to K7
(``ukd_with_upsample``, ``:355-384``), MiB's and PLOP's plain CE over all
pixels to K1's sums (``ce_over_all_pixels``); and ``begin_task`` (a no-op
but for PLOP), ``end_task`` and ``_sweep_prototypes`` (``:539-587``).  The
JAX context's ``axis_name`` is the context's process ``group``: a train
step's prototype folds sum their batch sums and counts across its ranks
(``methods/base.py:154-155``).  Its ``spatial_mesh`` (GSPMD) is not
ported.

The JAX ``compute_base_loss`` folds the batch into a local copy of the
prototypes for the detector and ``prototype_updates`` folds it again for
the state; here the one fold serves both (the same values).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from bacs_tpu_torch.models.base import NetOutput
from bacs_tpu_torch.ops.interpolate import resize_nearest
from bacs_tpu_torch.ops import rng
from bacs_tpu_torch.ops.losses import (
    binary_focal_loss, cross_entropy, unbiased_cross_entropy,
    unbiased_knowledge_distillation, weighted_cross_entropy)
from bacs_tpu_torch.ops.upsample_ce import (
    upsampled_bacs_weighted_ce, upsampled_ce_sums, upsampled_cross_entropy,
    upsampled_uce_sums, upsampled_unbiased_kd, upsampled_weighted_cross_entropy)
from bacs_tpu_torch.parallel import all_reduce_
from bacs_tpu_torch.train.state import TaskInfo, frozen_copy


@dataclasses.dataclass
class StepAux:
    """What ``compute_loss`` returns besides the scalar loss.

    ``sem_logits`` are the pre-upsample logits of the active classes; the
    eval step's confusion kernel reads them.  ``logits`` (full resolution,
    active classes) is built only when read, from ``output``.
    ``state_updates`` are ``TrainState`` fields for the train step to set.
    """

    sem_logits: torch.Tensor
    output: NetOutput
    n_cur: int
    state_updates: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def logits(self) -> torch.Tensor:
        return self.output.logits[..., : self.n_cur]


@dataclasses.dataclass(frozen=True)
class ModelContext:
    """What is static per task.

    ``fused_ce`` is the config gate ``training.fused_ce`` of the upsample
    kernels; ``group`` the process group of a data-parallel step (the JAX
    ``axis_name``), None on one device and in the task-boundary passes.
    """

    task: TaskInfo
    fused_ce: bool = True
    group: Any = None

    def forward(self, model: nn.Module, x: torch.Tensor, train: bool,
                key: Optional[rng.Key] = None) -> NetOutput:
        model.train(train)
        return model(x, key=key)

    @torch.no_grad()
    def forward_prev(self, state, x: torch.Tensor) -> NetOutput:
        """The frozen previous-task model, eval mode, no gradient."""
        return state.prev_model(x)

    @property
    def n_cur(self) -> int:
        return self.task.nb_current_classes


def label_task_ids(labels: torch.Tensor, task: TaskInfo) -> torch.Tensor:
    """Each label's task index (reference: base_loss.py:98-107); rounding
    half to even, as ``jnp.rint``."""
    if task.increment <= 0:
        return torch.zeros_like(labels, dtype=torch.long)
    t = torch.round((labels.float() + 1.0 - task.initial_classes) / task.increment)
    return t.clamp(0, task.n_tasks - 1).long()


@torch.no_grad()
def update_task_prototypes(prototypes, counts, penultimate, labels, task: TaskInfo,
                           group=None):
    """Fold a batch into the running-mean per-task foreground prototypes:
    per task, the mean penultimate feature over the pixels whose
    nearest-downsampled label belongs to it (background and ignore
    excluded), the sums and counts summed across ``group``'s ranks.
    Returns (prototypes [T, D], counts [T]); no host read."""
    feats = penultimate.float()
    labels_down = resize_nearest(labels, tuple(feats.shape[1:3]))
    valid = (labels_down != 0) & (labels_down != task.ignore_index)
    t_onehot = F.one_hot(label_task_ids(labels_down, task), task.n_tasks).float()
    t_onehot = t_onehot * valid.unsqueeze(-1)
    sums = torch.einsum("nhwt,nhwd->td", t_onehot, feats)
    n_feats = t_onehot.sum(dim=(0, 1, 2))
    all_reduce_([sums, n_feats], group, mean=False)
    new_counts = counts + n_feats
    new_protos = torch.where(
        (n_feats > 0)[:, None],
        (sums + counts[:, None] * prototypes) / torch.clamp(new_counts, min=1.0)[:, None],
        prototypes,
    )
    return new_protos, new_counts


class BaseOut(NamedTuple):
    """What ``compute_base_loss`` returns: the loss, the network output,
    the previous model's output (or None), the seen-probabilities (or
    None), and the folded (prototypes, counts) (None when not folded)."""

    loss: torch.Tensor
    out: NetOutput
    old_out: Optional[NetOutput]
    seen_prob: Optional[torch.Tensor]
    protos: Optional[Tuple[torch.Tensor, torch.Tensor]]


def proto_updates(base: BaseOut, updates: Optional[Dict[str, Any]] = None):
    """``updates`` with the prototypes ``base`` folded, if it folded them."""
    updates = dict(updates or {})
    if base.protos is not None:
        updates["prototypes"], updates["proto_counts"] = base.protos
    return updates


class Method:
    """Base method (the fine-tuning CE core when used directly).

    Flags mirror the reference BaseLoss (reference: loss/base_loss.py:10-78).
    """

    needs_prev_model = False
    needs_buffer = False
    needs_class_prototypes = False

    def __init__(
        self,
        name: str = "base",
        ignore_index: int = 255,
        use_bg_detector: bool = False,
        track_prototypes: bool = False,
        seen_gamma: float = 2.0,
        seen_threshold: float = 0.5,
        seen_ukd: bool = True,
        seen_focal_alpha: Optional[float] = None,
        **_: Any,
    ):
        self.name = name
        self.ignore_index = ignore_index
        self.use_bg_detector = use_bg_detector
        self.track_prototypes = track_prototypes or use_bg_detector
        self.seen_gamma = seen_gamma
        self.seen_threshold = seen_threshold
        self.seen_ukd = seen_ukd
        self.seen_focal_alpha = seen_focal_alpha

    def compute_loss(
        self,
        ctx: ModelContext,
        state,
        batch: Dict[str, torch.Tensor],
        train: bool,
        key: Optional[rng.Key] = None,
    ) -> Tuple[torch.Tensor, StepAux]:
        base = self.compute_base_loss(ctx, state, batch["image"], batch["label"],
                                      train, key)
        return base.loss, StepAux(
            sem_logits=base.out.sem_logits[..., : ctx.n_cur],
            output=base.out,
            n_cur=ctx.n_cur,
            state_updates=proto_updates(base),
        )

    @staticmethod
    def _fused_gate(ctx: ModelContext, sem: torch.Tensor, labels: torch.Tensor) -> bool:
        """THE fused upsample+loss kernel gate, for every CE variant: the
        kernel when the head output is below label resolution, the
        composed loss on the full-resolution logits otherwise."""
        return sem.shape[1] < labels.shape[1] and ctx.fused_ce

    def ce_with_upsample(
        self,
        ctx: ModelContext,
        sem: torch.Tensor,
        out: NetOutput,
        labels: torch.Tensor,
        class_weights: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Mean plain (K1) or class-weighted (K4, torch weighted-mean
        semantics) CE of the upsampled logits through ``_fused_gate``.

        ``sem`` is the pre-upsample head output (active classes); ``out``
        is read for the full-resolution logits only on the composed path.
        """
        hw = tuple(labels.shape[1:3])
        if self._fused_gate(ctx, sem, labels):
            if class_weights is None:
                return upsampled_cross_entropy(sem.contiguous(), labels, hw,
                                               self.ignore_index)
            return upsampled_weighted_cross_entropy(sem.contiguous(), labels,
                                                    class_weights, hw, self.ignore_index)
        return cross_entropy(
            out.logits[..., : ctx.n_cur], labels,
            ignore_index=self.ignore_index, class_weights=class_weights,
        )

    def ce_over_all_pixels(self, ctx: ModelContext, out: NetOutput,
                           labels: torch.Tensor) -> torch.Tensor:
        """Plain CE summed over the valid pixels and divided by N H W (MiB's
        and PLOP's reduction), through ``_fused_gate``: K1's sums, or the
        composed loss on the full-resolution logits."""
        sem = out.sem_logits[..., : ctx.n_cur]
        if self._fused_gate(ctx, sem, labels):
            total, _ = upsampled_ce_sums(sem.contiguous(), labels, tuple(labels.shape[1:3]),
                                         self.ignore_index)
            return total / labels.numel()
        return cross_entropy(out.logits[..., : ctx.n_cur], labels, self.ignore_index,
                             reduction="none").mean()

    def uce_with_upsample(self, ctx: ModelContext, out: NetOutput, labels: torch.Tensor,
                          over_all_pixels: bool = False) -> torch.Tensor:
        """MiB's unbiased CE against ``ctx.task.old_classes`` through
        ``_fused_gate``: K6 on the pre-upsample logits, or the composed loss
        on the full-resolution ones.  The sum over the valid pixels divided
        by their count (SDR's reduction, ``bacs_tpu/methods/base.py:326``),
        or with ``over_all_pixels`` by N H W (MiB's)."""
        sem = out.sem_logits[..., : ctx.n_cur]
        old = ctx.task.old_classes
        if self._fused_gate(ctx, sem, labels):
            total, count = upsampled_uce_sums(sem.contiguous(), labels,
                                              tuple(labels.shape[1:3]), old, self.ignore_index)
        else:
            nll = unbiased_cross_entropy(out.logits[..., : ctx.n_cur], labels, old,
                                         self.ignore_index, reduction="none")
            total, count = nll.sum(), (labels != self.ignore_index).sum().float()
        if over_all_pixels:
            return total / labels.numel()
        return total / torch.clamp(count, min=1.0)

    def ukd_with_upsample(self, ctx: ModelContext, out: NetOutput, old_out: NetOutput,
                          labels: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
        """MiB's unbiased KD against the frozen previous model (its old
        classes), mean over ALL pixels, through ``_fused_gate``: K7 on the
        two pre-upsample logit tensors, or the composed loss on the
        full-resolution logits.  The teacher takes no gradient."""
        sem_new = out.sem_logits[..., : ctx.n_cur]
        old = ctx.task.old_classes
        if self._fused_gate(ctx, sem_new, labels):
            return upsampled_unbiased_kd(
                sem_new.contiguous(), old_out.sem_logits[..., :old].contiguous(),
                tuple(labels.shape[1:3]), alpha=alpha)
        return unbiased_knowledge_distillation(
            out.logits[..., : ctx.n_cur], old_out.logits[..., :old].detach(), alpha=alpha)

    def prototype_updates(self, ctx: ModelContext, state, penultimate: torch.Tensor,
                          labels: torch.Tensor, train: bool) -> Dict[str, Any]:
        """The batch folded into the per-task prototypes (train only, with
        ``track_prototypes``), as ``TrainState`` updates."""
        if not (train and self.track_prototypes):
            return {}
        protos, counts = update_task_prototypes(state.prototypes, state.proto_counts,
                                                penultimate, labels, ctx.task, ctx.group)
        return {"prototypes": protos, "proto_counts": counts}

    def compute_base_loss(
        self,
        ctx: ModelContext,
        state,
        image: torch.Tensor,
        labels: torch.Tensor,
        train: bool,
        key: Optional[rng.Key] = None,
        task_num: int = -1,
        class_weights: Optional[torch.Tensor] = None,
        use_weighted_ce: bool = False,
        need_old_out: bool = False,
        is_replay: bool = False,
        same_task: bool = False,
        proto_base: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> BaseOut:
        """The shared CE (+ seen detector) core (reference:
        loss/base_loss.py:172-253).  ``proto_base`` lets a replay batch fold
        on top of the main batch's prototypes."""
        task = ctx.task
        model = state.model
        out = ctx.forward(model, image, train, key)
        old_out = None
        if need_old_out and train and state.prev_model is not None:
            old_out = ctx.forward_prev(state, image)
        sem = out.sem_logits[..., : ctx.n_cur]

        # the reference folds the batch into the prototypes before the seen
        # detector reads them (base_loss.py:219-231)
        protos = None
        cur = proto_base or (state.prototypes, state.proto_counts)
        if train and self.track_prototypes:
            protos = cur = update_task_prototypes(*cur, out.penultimate, labels, task,
                                                  ctx.group)

        seen_prob = None
        if use_weighted_ce and train:
            if getattr(model, "seen_fg_network", None) is None:
                raise ValueError("the seen-weighted CE (bg_weighted_ce) needs the seen "
                                 "detector: training.bg_detector=true")
            with torch.no_grad():
                seen_prob = model.seen_probs(out.penultimate, cur[0], task.task_id + 1)
            if self._fused_gate(ctx, sem, labels):
                loss = upsampled_bacs_weighted_ce(
                    sem.contiguous(), labels, seen_prob.amax(dim=-1).contiguous(),
                    tuple(labels.shape[1:3]), task.old_classes, self.seen_gamma,
                    self.seen_threshold, self.seen_ukd, self.ignore_index,
                )
            else:
                loss = weighted_cross_entropy(
                    out.logits[..., : ctx.n_cur], labels, seen_prob,
                    old_classes=task.old_classes, gamma=self.seen_gamma,
                    threshold=self.seen_threshold, ukd=self.seen_ukd,
                    ignore_index=self.ignore_index,
                )
        else:
            loss = self.ce_with_upsample(ctx, sem, out, labels, class_weights)

        # seen/fg detector training (reference: base_loss.py:192-199,241-250):
        # non-replay batches only (unless same_task), gated on prototype
        # readiness (post-fold counts) and on a background pixel, weighted
        # by max(0, 1 - exp(epoch - max_epochs))
        if train and self.use_bg_detector and (same_task or not is_replay):
            ready = (cur[1][: task.task_id + 1] > 0).all().float()
            # a replayed task (ER's partition) is a device integer
            t_num = task.task_id if isinstance(task_num, int) and task_num == -1 else task_num
            seen_logits = model.seen_map_task(out.penultimate, cur[0], t_num,
                                              stop_grads=not task.first_task)
            fg_target = torch.where(labels == self.ignore_index, self.ignore_index,
                                    (labels != 0).long())
            seen_loss = binary_focal_loss(
                seen_logits[..., 0], fg_target, gamma=self.seen_gamma,
                alpha=self.seen_focal_alpha, ignore_index=self.ignore_index,
            )
            has_bg = (labels == 0).any().float()
            weight = max(0.0, 1.0 - math.exp(float(state.epoch) - float(task.max_epochs)))
            loss = loss + weight * ready * has_bg * seen_loss
        return BaseOut(loss, out, old_out, seen_prob, protos)

    # ------------------------------------------------------------------
    # task-boundary hooks, on the host

    def begin_task(self, state, ctx: ModelContext, data: Any):
        """Called before training task ``ctx.task.task_id``; ``data``
        iterates the task's train batches."""
        return state

    def end_task(self, state, ctx: ModelContext, data: Any):
        """Called after a task; ``data`` iterates the task's train batches
        (dicts of device tensors)."""
        if self.track_prototypes:
            state = self._sweep_prototypes(state, ctx, data)
        if self.needs_prev_model:
            state.prev_model = frozen_copy(state.model)
        return state

    @torch.no_grad()
    def _sweep_prototypes(self, state, ctx: ModelContext, data: Any):
        """If an active prototype has seen no pixel, fold the whole loader
        in eval mode (reference: loss/prototypes.py:92-125)."""
        if bool((state.proto_counts[: ctx.task.task_id + 1] > 0).all()):
            return state
        for batch in data:
            out = ctx.forward(state.model, batch["image"], False)
            state.prototypes, state.proto_counts = update_task_prototypes(
                state.prototypes, state.proto_counts, out.penultimate,
                batch["label"], ctx.task)
        return state
