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

Four options, off in every shipped config: ``pseudo_label`` (the previous
model's argmax over the old classes relabels the background, reference
``:205-210``), ``use_cosine_dist`` (the alpha term as the mean of
``1 - cos`` over each image's flattened logits), ``mixup`` (the beta
term on co-occurrence blends of replayed images, reference
``buffer.py:275-303``) and ``merged_replay`` (both replay batches through
one forward; the statistics then come from the merged batch, a departure
from the reference that JAX makes on purpose).

The buffer lives on the card, and both replay batches are drawn there
every step, with no host read, from the step's key split as
``bacs_tpu/methods/bacs.py`` splits it (``ops/rng.py``: JAX's draws).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bacs_tpu_torch.data.transforms import replay_augment
from bacs_tpu_torch.methods.base import (
    ModelContext, StepAux, proto_updates, update_task_prototypes)
from bacs_tpu_torch.methods.er import ExperienceReplayMethod
from bacs_tpu_torch.models.base import NetOutput
from bacs_tpu_torch.ops import rng
from bacs_tpu_torch.ops.interpolate import resize_bilinear
from bacs_tpu_torch.ops.losses import cross_entropy
from bacs_tpu_torch.train import buffer as buffer_lib
from bacs_tpu_torch.train.state import frozen_copy

# images per chunk of the teacher distillation's full-resolution pass
DISTILL_CHUNK = 2


def random_autocontrast(x: torch.Tensor, key: Optional[rng.Key] = None,
                        p: float = 0.5) -> torch.Tensor:
    """Batch-level RandomAutocontrast on float images [N, H, W, C]
    (reference: bacs_loss.py:108-114): each image's channels stretched to
    [0, 1], applied to the whole batch with probability ``p``, decided on
    the device."""
    lo = x.amin(dim=(1, 2), keepdim=True)
    hi = x.amax(dim=(1, 2), keepdim=True)
    stretched = (x - lo) / torch.clamp(hi - lo, min=1e-8)
    apply = rng.bernoulli(rng.given(key), p, (), x.device)
    return torch.where(apply, stretched, x)


def beta_sample(a: float, n: int, key: rng.Key, device: torch.device) -> torch.Tensor:
    """[n] draws of Beta(a, a), ``jax.random.beta(key, a, a, (n,))`` bit
    for bit (``rng.beta``: on the host, then copied to ``device`` without
    waiting)."""
    return rng.beta(key, a, a, n, device)


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
        super().__init__(
            name=name, alpha=alpha, buffer_size=buffer_size,
            replay_minibatch_size=replay_minibatch_size,
            bg_weighted_ce=bg_weighted_ce, same_task=same_task,
            seen_gamma=seen_gamma, seen_threshold=seen_threshold,
            seen_ukd=seen_ukd, seen_focal_alpha=seen_focal_alpha, **kwargs,
        )
        self.beta = beta
        self.dark_plus_plus = dark_plus_plus
        self.use_cosine_dist = use_cosine_dist
        self.ignore_rep_bg = ignore_rep_bg
        self.lkd = lkd
        self.lkd_threshold = lkd_threshold
        # pseudo-labeling only when weighted CE is off (reference: :60-61)
        self.pseudo_label = pseudo_label and not bg_weighted_ce
        self.mixup = mixup
        self.mixup_alpha = mixup_alpha
        self.mixup_threshold = mixup_threshold
        self.transplant_mode = transplant_mode
        self.merged_replay = merged_replay
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
        key: Optional[rng.Key] = None,
    ) -> Tuple[torch.Tensor, StepAux]:
        task = ctx.task
        image, mask = batch["image"], batch["label"]
        use_der = task.task_id > 0
        r_main, r_replay = rng.split(rng.given(key), 3)[1:] if train else (key, None)
        if train and self.pseudo_label and state.prev_model is not None:
            mask = self._pseudo_labels(ctx, state, image, mask)
        need_distill = use_der and train and self.lkd > 0
        base = self.compute_base_loss(
            ctx, state, image, mask, train, r_main,
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
            replay_loss, updates = self._replay_der_loss(ctx, state, r_replay, updates)
            loss = loss + replay_loss
        return loss, StepAux(
            sem_logits=base.out.sem_logits[..., : ctx.n_cur],
            output=base.out,
            n_cur=ctx.n_cur,
            state_updates=updates,
        )

    @staticmethod
    def _pseudo_labels(ctx, state, image, mask):
        """``mask`` with every background label replaced by the previous
        model's argmax over the old classes (reference: bacs_loss.py:205-210)."""
        old = ctx.forward_prev(state, image).logits[..., : ctx.task.old_classes]
        return torch.where(mask == 0, old.argmax(dim=-1).to(mask.dtype), mask)

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

    def _dark_logits(self, ctx, state, key):
        """alpha term (reference: bacs_loss.py:387-431)."""
        r_sample, r_aug, r_fwd = rng.split(rng.given(key), 3)
        mem = buffer_lib.sample(state.buffer, self.replay_minibatch_size, r_sample)
        inputs = random_autocontrast(mem["images"], r_aug)
        out = ctx.forward(state.model, inputs, True, r_fwd)
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
        if self.use_cosine_dist:
            a = mem_logits.reshape(mem_logits.shape[0], -1)
            b = sem.float().reshape(sem.shape[0], -1)
            cos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1) + 1e-8)
            return (1.0 - cos).mean()
        return torch.square(mem_logits - sem.float()).mean()

    def _old_class_weights(self, ctx, device):
        """beta-term class weights: 1 for the old foreground classes, the
        background excluded with ``ignore_rep_bg`` (reference:
        bacs_loss.py:342-360)."""
        c = torch.arange(ctx.n_cur, device=device)
        start = 1 if self.ignore_rep_bg else 0
        return ((c >= start) & (c < ctx.task.old_classes)).float()

    def _dark_pp(self, ctx, state, key, updates):
        """beta term (reference: bacs_loss.py:342-385): the buffered
        canonical crops get the train augmentation at every replay
        (base_datamodule.py:433-451), and the batch folds into the
        prototypes on top of the main batch's fold (base_loss.py:219-220)."""
        if not self.dark_plus_plus:
            return 0.0, updates
        r_sample, r_fwd, r_mix = rng.split(rng.given(key), 3)
        mem = buffer_lib.sample(state.buffer, self.replay_minibatch_size, r_sample)
        weights = self._old_class_weights(ctx, mem["images"].device)
        if self.mixup:
            return self._dark_pp_mixup(ctx, state, r_fwd, r_mix, mem, weights), updates
        r_fwd, r_aug = rng.split(r_fwd)
        images, labels = replay_augment(mem["images"], mem["labels"], r_aug)
        base = self.compute_base_loss(
            ctx, state, images, labels, True, r_fwd,
            class_weights=weights,
            is_replay=True,
            proto_base=(updates.get("prototypes", state.prototypes),
                        updates.get("proto_counts", state.proto_counts)),
        )
        return base.loss, proto_updates(base, updates)

    def _dark_pp_mixup(self, ctx, state, r_fwd, r_mix, mem, weights):
        """The beta term on co-occurrence blends (reference: buffer.py:275-303
        ``_co_occurance_image_blend`` and bacs_loss.py:361-374): each
        replayed item's partner is the item of the batch that maximises its
        class co-occurrence score (the diagonal excluded); lambda is 0.9 where
        the two items' classes together exceed ``mixup_threshold``, else a
        Beta(``mixup_alpha``, ``mixup_alpha``) draw; the blend keeps the
        reference's literal ``lambda a + lambda b``; the loss mixes the
        per-pixel class-weighted CE against both label maps by lambda and
        1 - lambda.  No re-augmentation and no prototype fold.

        The co-occurrence matrix is JAX's ``einsum("ic,jd->cd")`` over the
        valid slots' classes (background and the ignore column cleared):
        the outer product of the class counts.  The scores are counts, so
        they are summed in float64, exactly at any buffer size."""
        buf = state.buffer
        fg = buf.label_mask.clone()
        fg[:, 0] = False
        fg[:, -1] = False
        held = (fg & buf.valid[:, None]).double()
        co = torch.einsum("ic,jd->cd", held, held)
        sets = fg[mem["indices"]].double()  # [B, C]
        sim = sets @ co @ sets.t()
        b = sets.shape[0]
        sim = sim.masked_fill(torch.eye(b, dtype=torch.bool, device=sim.device), -torch.inf)
        partner = sim.argmax(dim=1)
        n_merged = (sets.sum(dim=1) + sets[partner].sum(dim=1)).float()
        draw = beta_sample(self.mixup_alpha, b, r_mix, n_merged.device)
        lam = torch.where(n_merged > self.mixup_threshold, 0.9, draw)
        lam4 = lam[:, None, None, None]
        mixed = lam4 * mem["images"] + lam4 * mem["images"][partner]
        logits = ctx.forward(state.model, mixed, True, r_fwd).logits[..., : ctx.n_cur]
        ce_a = cross_entropy(logits, mem["labels"], self.ignore_index, class_weights=weights,
                             reduction="none")
        ce_b = cross_entropy(logits, mem["labels"][partner], self.ignore_index,
                             class_weights=weights, reduction="none")
        return (lam[:, None, None] * ce_a + (1 - lam)[:, None, None] * ce_b).mean()

    def _merged_replay_der_loss(self, ctx, state, key, updates):
        """Both replay batches through one forward (``loss.merged_replay``,
        JAX ``_merged_replay_der_loss``): the autocontrasted alpha sample and
        the re-augmented beta sample, concatenated.  The alpha term comes
        from the first half's sem logits, the beta term from the second
        half's through ``ce_with_upsample`` (K4), and only the beta half folds
        into the prototypes.  The batch statistics are the merged batch's,
        a departure from the reference's two forwards."""
        n = self.replay_minibatch_size
        r_alpha, r_beta = rng.split(rng.given(key))
        rs_a, r_aug_a, r_fwd = rng.split(r_alpha, 3)
        mem_dl = buffer_lib.sample(state.buffer, n, rs_a)
        inputs_dl = random_autocontrast(mem_dl["images"], r_aug_a)
        rs_b, r_aug_b = rng.split(r_beta)
        mem_pp = buffer_lib.sample(state.buffer, n, rs_b)
        imgs_pp, labs_pp = replay_augment(mem_pp["images"], mem_pp["labels"], r_aug_b)
        big = torch.cat([inputs_dl, imgs_pp.to(inputs_dl.dtype)])
        out = ctx.forward(state.model, big, True, r_fwd)
        sem = out.sem_logits[..., : ctx.n_cur]
        dark = self._dark_from_sem(ctx, sem[:n], mem_dl)
        half = NetOutput(out.sem_logits[n:], out.penultimate[n:], (), out.out_hw)
        pp = self.ce_with_upsample(ctx, sem[n:], half, labs_pp,
                                   self._old_class_weights(ctx, big.device))
        if self.track_prototypes:
            updates = dict(updates)
            updates["prototypes"], updates["proto_counts"] = update_task_prototypes(
                updates.get("prototypes", state.prototypes),
                updates.get("proto_counts", state.proto_counts),
                out.penultimate[n:], labs_pp, ctx.task, ctx.group)
        return self.alpha * dark + self.beta * pp, updates

    def _replay_der_loss(self, ctx, state, key, updates):
        """(reference: bacs_loss.py:433-463)."""
        if (self.merged_replay and self.alpha != 0 and self.beta != 0
                and self.dark_plus_plus and not self.mixup):
            return self._merged_replay_der_loss(ctx, state, key, updates)
        r_alpha, r_beta = rng.split(rng.given(key))
        total = 0.0
        if self.alpha != 0:
            total = total + self.alpha * self._dark_logits(ctx, state, r_alpha)
        if self.beta != 0:
            pp, updates = self._dark_pp(ctx, state, r_beta, updates)
            total = total + self.beta * pp
        return total, updates

    # ------------------------------------------------------------------

    @torch.no_grad()
    def end_task(self, state, ctx: ModelContext, data: Any, key=None):
        """Fill the reservoir with this task's data (reference:
        bacs_loss.py:133-203 ``on_train_end``), in the reference's order:
        the prototype sweep, the previous-model snapshot, then the fill.

        The fill runs the model in train mode (``boundary_train_mode``): the
        stored logits and importances use batch statistics, and the live
        model's running statistics drift while the snapshot keeps the
        pre-drift ones.  With the seen detector the reference probes the
        penultimate path a second time per batch, so the statistics of
        ``penultimate_stats_keys`` (the backbone) drift twice: a second
        forward here, whose other statistics are put back.  ``key``
        (default JAX's ``PRNGKey(4321 + task id)``) is split once per batch,
        and each batch's key in three: the fill's forward, the second
        forward and the reservoir's uniforms (``bacs_tpu/methods/
        bacs.py:476-477,522-524``)."""
        task = ctx.task
        if self.track_prototypes:
            state = self._sweep_prototypes(state, ctx, data)
        state.prev_model = frozen_copy(state.model)
        if state.buffer is None or not (self.alpha > 0 or self.beta > 0):
            return state
        model = state.model
        if key is None:
            key = rng.key(4321 + task.task_id)
        train_mode = self.boundary_train_mode
        keys = tuple(model.penultimate_stats_keys)
        w = torch.ones(ctx.n_cur, device=state.buffer.images.device)
        w[0] = 0.0
        for batch in data:
            image, labels = batch["image"], batch["label"]
            key, sub = rng.split(key)
            r1, r2, r_buf = rng.split(sub, 3)
            out = ctx.forward(model, image, train_mode, r1)
            nll = cross_entropy(out.logits[..., : ctx.n_cur], labels, self.ignore_index,
                                class_weights=w, reduction="none")
            losses = -nll.reshape(image.shape[0], -1).mean(dim=1)
            sem = F.pad(out.sem_logits[..., : ctx.n_cur].float(),
                        (0, task.num_classes - ctx.n_cur))
            if self.use_bg_detector and train_mode:
                kept = {k: b.clone() for k, b in model.named_buffers()
                        if not k.startswith(tuple(key + "." for key in keys))}
                ctx.forward(model, image, True, r2)
                for k, b in model.named_buffers():
                    if k in kept:
                        b.copy_(kept[k])
            buffer_lib.add_batch(state.buffer, image, sem, labels, losses,
                                 task_id=task.task_id, n_classes=ctx.n_cur,
                                 ignore_index=self.ignore_index, key=r_buf)
        return state
