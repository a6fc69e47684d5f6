"""BACS: prototypes, the seen detector and dark experience replay.

Port of ``bacs_tpu/methods/bacs.py``: ``BACSMethod`` extends
Experience Replay with

- the teacher distillation on background pixels gated by the seen
  detector (``_teacher_distill``, reference ``bacs_loss.py:258-294``);
- the alpha term (``_dark_logits``): MSE between the buffered sem logits and
  the current ones on replayed images, the channels beyond a slot's stored
  class count transplanted from the current model, and the background
  channel refreshed when ``ignore_rep_bg`` (reference ``:387-431``);
- the beta term (``_dark_pp``): the class-weighted CE (K4) of a second
  replayed batch, re-augmented, where only old foreground classes weigh
  (reference ``:342-385``);
- ``end_task``: the prototype sweep, the previous-model snapshot, then the
  reservoir filled in train mode, the backbone's statistics drifting twice
  per batch as in the reference (``:133-203``).

The buffer lives on the card, and both replay batches are drawn there
every step from the state's generator, with no host read.  ``mixup``,
``merged_replay``, ``use_cosine_dist`` and ``pseudo_label`` are off in every
shipped config and raise (ROADMAP.md queue 1 item 9).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bacs_tpu_torch.data.transforms import replay_augment
from bacs_tpu_torch.methods.base import ModelContext, StepAux, proto_updates
from bacs_tpu_torch.methods.er import ExperienceReplayMethod
from bacs_tpu_torch.ops.interpolate import resize_bilinear
from bacs_tpu_torch.ops.losses import cross_entropy
from bacs_tpu_torch.train import buffer as buffer_lib
from bacs_tpu_torch.train.state import frozen_copy

# images per chunk of the teacher distillation's full-resolution pass
DISTILL_CHUNK = 2


def random_autocontrast(x: torch.Tensor, generator: Optional[torch.Generator] = None,
                        p: float = 0.5) -> torch.Tensor:
    """Batch-level RandomAutocontrast on float images [N, H, W, C]
    (reference: bacs_loss.py:108-114): each image's channels stretched to
    [0, 1], applied to the whole batch with probability ``p``, decided on
    the device."""
    lo = x.amin(dim=(1, 2), keepdim=True)
    hi = x.amax(dim=(1, 2), keepdim=True)
    stretched = (x - lo) / torch.clamp(hi - lo, min=1e-8)
    apply = torch.rand((), generator=generator, device=x.device) < p
    return torch.where(apply, stretched, x)


def _distill_chunk(old_att, new_att, keep, lkd_shape):
    """Σ over (image, row, channel) of the distance over the width axis of
    the two squared, masked, upsampled embeddings of a chunk."""
    def norm(emb):
        emb = resize_bilinear(emb.float(), lkd_shape)
        return torch.square(torch.where(keep.unsqueeze(-1), emb, 0.0))

    diff = norm(old_att) - norm(new_att)
    return torch.sqrt(torch.square(diff).sum(dim=2) + 1e-12).sum()


class BACSMethod(ExperienceReplayMethod):
    needs_prev_model = True
    needs_buffer = True

    def __init__(
        self,
        name: str = "BACS",
        alpha: float = 0.8,
        beta: float = 0.2,
        buffer_size: int = 50,
        replay_minibatch_size: int = 32,
        dark_plus_plus: bool = True,
        use_cosine_dist: bool = False,
        same_task: bool = False,
        ignore_rep_bg: bool = True,
        bg_weighted_ce: bool = False,
        seen_gamma: float = 2.0,
        seen_threshold: float = 0.5,
        seen_ukd: bool = True,
        seen_focal_alpha: Optional[float] = None,
        lkd: float = 0.25,
        lkd_threshold: float = 0.5,
        pseudo_label: bool = False,
        mixup: bool = False,
        mixup_alpha: float = 1.0,
        mixup_threshold: int = 10,
        transplant_mode: str = "reference",
        merged_replay: bool = False,
        boundary_train_mode: bool = True,
        **kwargs,
    ):
        if transplant_mode not in ("reference", "per_sample"):
            raise ValueError(f"unknown transplant_mode {transplant_mode!r}")
        # pseudo-labeling only when weighted CE is off (reference: :60-61)
        for flag, on in (("mixup", mixup), ("merged_replay", merged_replay),
                         ("use_cosine_dist", use_cosine_dist),
                         ("pseudo_label", pseudo_label and not bg_weighted_ce)):
            if on:
                raise NotImplementedError(
                    f"BACS {flag} is ROADMAP.md queue 1 item 9 (off in every "
                    "shipped config)")
        super().__init__(
            name=name, alpha=alpha, buffer_size=buffer_size,
            replay_minibatch_size=replay_minibatch_size,
            bg_weighted_ce=bg_weighted_ce, same_task=same_task,
            seen_gamma=seen_gamma, seen_threshold=seen_threshold,
            seen_ukd=seen_ukd, seen_focal_alpha=seen_focal_alpha, **kwargs,
        )
        self.beta = beta
        self.dark_plus_plus = dark_plus_plus
        self.ignore_rep_bg = ignore_rep_bg
        self.lkd = lkd
        self.lkd_threshold = lkd_threshold
        self.transplant_mode = transplant_mode
        # True (the reference): the buffer is filled in train mode, so the
        # running statistics drift at every task end
        self.boundary_train_mode = boundary_train_mode

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
        use_der = task.task_id > 0
        need_distill = use_der and train and self.lkd > 0
        base = self.compute_base_loss(
            ctx, state, image, mask, train, generator,
            use_weighted_ce=self.bg_weighted_ce and use_der,
            need_old_out=need_distill,
        )
        loss = base.loss
        if need_distill and base.old_out is not None:
            loss = loss + self._teacher_distill(
                base.old_out.attentions[-1], base.out.attentions[-1],
                base.seen_prob, mask)
        updates = proto_updates(base)
        if train and use_der and state.buffer is not None and (
                self.alpha > 0 or self.beta > 0):
            replay_loss, updates = self._replay_der_loss(ctx, state, generator, updates)
            loss = loss + replay_loss
        return loss, StepAux(
            sem_logits=base.out.sem_logits[..., : ctx.n_cur],
            output=base.out,
            n_cur=ctx.n_cur,
            state_updates=updates,
        )

    # ------------------------------------------------------------------

    def _teacher_distill(self, old_att, new_att, seen_prob, mask):
        """(reference: bacs_loss.py:258-294).  Both embeddings (the ASPP
        output) are upsampled to the label size, zeroed outside the
        background pixels the seen detector marks as seen, and squared; the
        loss is lkd times the mean over (image, row, channel) of the norm
        over the width axis of their difference.

        At 512^2 batch 16 each upsampled embedding is 4.3 GB of f32, so the
        images go in chunks of ``DISTILL_CHUNK``, each recomputed in the
        backward (``torch.utils.checkpoint``): only the [n, 32, 32, 256]
        inputs are kept."""
        if self.lkd == 0:
            return 0.0
        keep = mask == 0
        if seen_prob is not None:
            keep = keep & (seen_prob.amax(dim=-1) > self.lkd_threshold)
        hw = tuple(mask.shape[1:3])
        total = 0.0
        for s in range(0, mask.shape[0], DISTILL_CHUNK):
            sl = slice(s, s + DISTILL_CHUNK)
            total = total + checkpoint(_distill_chunk, old_att[sl], new_att[sl],
                                       keep[sl], hw, use_reentrant=False)
        n_terms = mask.shape[0] * mask.shape[1] * new_att.shape[-1]
        return self.lkd * total / n_terms

    # ------------------------------------------------------------------

    def _dark_logits(self, ctx, state, generator):
        """alpha term (reference: bacs_loss.py:387-431)."""
        mem = buffer_lib.sample(state.buffer, self.replay_minibatch_size, generator)
        inputs = random_autocontrast(mem["images"], generator)
        out = ctx.forward(state.model, inputs, True, generator)
        return self._dark_from_sem(ctx, out.sem_logits[..., : ctx.n_cur], mem)

    def _grow_mask(self, ctx, n_cls: torch.Tensor) -> torch.Tensor:
        """[B, C] bool: the channels of each replayed item taken from the
        current model.

        ``per_sample``: every channel at or past the item's stored class
        count.  ``reference`` (the default, the published numbers): the
        reference's indexing quirk (bacs_loss.py:418-427): its loop over the
        unique class counts u[k] transplants channels >= u[k] into item
        ``inverse[k]``, the unique-inverse value at position k, so per unique
        count at most one item grows.  ``torch.unique`` would return a
        data-dependent size (a host read every step); this computes the
        fixed-size unique of ``jnp.unique(size=B)`` on the device: sort,
        mark the first occurrences, rank them."""
        c = torch.arange(ctx.n_cur, device=n_cls.device)
        if self.transplant_mode == "per_sample":
            return c[None, :] >= n_cls[:, None]
        bsz = n_cls.shape[0]
        fill = torch.iinfo(torch.int32).max
        srt, order = torch.sort(n_cls.long(), stable=True)
        first = torch.ones_like(srt, dtype=torch.bool)
        first[1:] = srt[1:] != srt[:-1]
        rank = torch.cumsum(first.long(), 0) - 1
        u = torch.full((bsz,), fill, dtype=torch.long, device=n_cls.device)
        u.scatter_(0, rank, srt)  # equal values: any write order gives u
        inv = torch.empty_like(rank).scatter_(0, order, rank)
        k = torch.arange(bsz, device=n_cls.device)
        ok = (k < first.sum()) & (u < ctx.n_cur)
        cmask = (c[None, :] >= u[:, None]) & ok[:, None]  # [k, C]
        sel = inv[:, None] == k[None, :]  # [k, item]
        return (sel.float().t() @ cmask.float()) > 0

    def _dark_from_sem(self, ctx, sem, mem):
        """The alpha term given the replay batch's sem logits."""
        transplant = sem.detach().float()
        grow = self._grow_mask(ctx, mem["n_classes"])[:, None, None, :]
        mem_logits = torch.where(grow, transplant, mem["logits"][..., : ctx.n_cur])
        if self.ignore_rep_bg:
            mem_logits[..., 0] = transplant[..., 0]
        return torch.square(mem_logits - sem.float()).mean()

    def _old_class_weights(self, ctx, device):
        """beta-term class weights: 1 for the old foreground classes, the
        background excluded with ``ignore_rep_bg`` (reference:
        bacs_loss.py:342-360)."""
        c = torch.arange(ctx.n_cur, device=device)
        start = 1 if self.ignore_rep_bg else 0
        return ((c >= start) & (c < ctx.task.old_classes)).float()

    def _dark_pp(self, ctx, state, generator, updates):
        """beta term (reference: bacs_loss.py:342-385): the buffered
        canonical crops get the train augmentation at every replay
        (base_datamodule.py:433-451), and the batch folds into the
        prototypes on top of the main batch's fold (base_loss.py:219-220)."""
        if not self.dark_plus_plus:
            return 0.0, updates
        mem = buffer_lib.sample(state.buffer, self.replay_minibatch_size, generator)
        images, labels = replay_augment(mem["images"], mem["labels"], generator)
        base = self.compute_base_loss(
            ctx, state, images, labels, True, generator,
            class_weights=self._old_class_weights(ctx, images.device),
            is_replay=True,
            proto_base=(updates.get("prototypes", state.prototypes),
                        updates.get("proto_counts", state.proto_counts)),
        )
        return base.loss, proto_updates(base, updates)

    def _replay_der_loss(self, ctx, state, generator, updates):
        """(reference: bacs_loss.py:433-463)."""
        total = 0.0
        if self.alpha != 0:
            total = total + self.alpha * self._dark_logits(ctx, state, generator)
        if self.beta != 0:
            pp, updates = self._dark_pp(ctx, state, generator, updates)
            total = total + self.beta * pp
        return total, updates

    # ------------------------------------------------------------------

    @torch.no_grad()
    def end_task(self, state, ctx: ModelContext, data: Any, generator=None):
        """Fill the reservoir with this task's data (reference:
        bacs_loss.py:133-203 ``on_train_end``), in the reference's order:
        the prototype sweep, the previous-model snapshot, then the fill.

        The fill runs the model in train mode (``boundary_train_mode``): the
        stored logits and importances use batch statistics, and the live
        model's running statistics drift while the snapshot keeps the
        pre-drift ones.  With the seen detector the reference probes the
        penultimate path a second time per batch, so the statistics of
        ``penultimate_stats_keys`` (the backbone) drift twice: a second
        forward here, whose other statistics are put back.  ``generator``
        draws the reservoir's uniforms (default: seeded 4321 + task id)."""
        task = ctx.task
        if self.track_prototypes:
            state = self._sweep_prototypes(state, ctx, data)
        state.prev_model = frozen_copy(state.model)
        if state.buffer is None or not (self.alpha > 0 or self.beta > 0):
            return state
        model = state.model
        if generator is None:
            generator = torch.Generator(state.buffer.images.device)
            generator.manual_seed(4321 + task.task_id)
        train_mode = self.boundary_train_mode
        keys = tuple(model.penultimate_stats_keys)
        w = torch.ones(ctx.n_cur, device=state.buffer.images.device)
        w[0] = 0.0
        for batch in data:
            image, labels = batch["image"], batch["label"]
            out = ctx.forward(model, image, train_mode, generator)
            nll = cross_entropy(out.logits[..., : ctx.n_cur], labels, self.ignore_index,
                                class_weights=w, reduction="none")
            losses = -nll.reshape(image.shape[0], -1).mean(dim=1)
            sem = F.pad(out.sem_logits[..., : ctx.n_cur].float(),
                        (0, task.num_classes - ctx.n_cur))
            if self.use_bg_detector and train_mode:
                kept = {k: b.clone() for k, b in model.named_buffers()
                        if not k.startswith(tuple(key + "." for key in keys))}
                ctx.forward(model, image, True, generator)
                for k, b in model.named_buffers():
                    if k in kept:
                        b.copy_(kept[k])
            buffer_lib.add_batch(state.buffer, image, sem, labels, losses,
                                 task_id=task.task_id, n_classes=ctx.n_cur,
                                 ignore_index=self.ignore_index, generator=generator)
        return state
