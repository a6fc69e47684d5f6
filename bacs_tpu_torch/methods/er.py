"""Experience Replay with the device reservoir buffer.

Port of ``bacs_tpu/methods/er.py`` (reference loss/experience_replay.py):

- ``end_task`` puts the task's canonical crops into the buffer with their
  sem logits and an importance of minus the mean class-weighted NLL (the
  background weighs 0), the model in eval mode, stopping once
  ``buffer_size`` items were offered (reference er.py:112-151).
- At a task > 0 a training step adds alpha^2 times the class-weighted CE
  (K4) of a replayed batch, re-augmented, where only the old foreground
  classes weigh (reference er.py:244-272; alpha is applied twice, as the
  reference does, er.py:181,298).
- ``same_task`` (the default) keeps one partition of ``buffer_size`` slots
  per task, ``[t * size, (t + 1) * size)``, with fresh reservoir
  bookkeeping at each task; the replayed task is drawn from the softmax of
  the partitions' median importances (``partition_scores``; reference
  er.py:77-97), and "old" in the weights is relative to that task's end.

The main batch's loss is ``compute_base_loss``'s CE (K1; the seen-weighted
CE, K3, with ``bg_weighted_ce`` at a task > 0).  The replay partition, the
batch and the augmentation are drawn on the device from the step's
generator, with no host read.  ``BACSMethod`` inherits ``__init__`` and
``init_buffer`` and overrides the rest.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from bacs_tpu_torch.data.transforms import replay_augment
from bacs_tpu_torch.methods.base import Method, ModelContext, StepAux, proto_updates
from bacs_tpu_torch.ops.losses import cross_entropy
from bacs_tpu_torch.train import buffer as buffer_lib

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "uint8": torch.uint8}
_SLOT_FIELDS = ("images", "logits", "labels", "importance", "label_mask", "task_ids",
                "n_classes", "valid")


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis ignoring NaNs, as ``jnp.nanmedian``: for an
    even count the mean of the two middle values (``torch.nanmedian`` takes
    the lower one); NaN for a row of NaNs.  No host read."""
    srt = torch.sort(x, dim=-1).values  # NaNs last
    k = (~torch.isnan(x)).sum(dim=-1, keepdim=True)
    lo = torch.clamp((k - 1) // 2, min=0)
    hi = torch.clamp(k // 2, min=0).clamp(max=x.shape[-1] - 1)
    med = 0.5 * srt.gather(-1, lo) + 0.5 * srt.gather(-1, hi)
    return torch.where(k > 0, med, torch.nan).squeeze(-1)


def partition_scores(importance: torch.Tensor, valid: torch.Tensor, n_prev: int,
                     size: int) -> torch.Tensor:
    """[n_prev] probabilities of replaying each earlier task's partition:
    the median of minus the importance over its set slots (10.0 for an
    empty one, the reference's default), divided by the largest median
    (at least 1e-8), softmaxed (reference er.py:77-97)."""
    neg = torch.where(valid[: n_prev * size], -importance[: n_prev * size], torch.nan)
    med = nanmedian(neg.reshape(n_prev, size))
    med = torch.where(torch.isnan(med), 10.0, med)
    return torch.softmax(med / torch.clamp(med.max(), min=1e-8), dim=0)


class ExperienceReplayMethod(Method):
    needs_buffer = True

    def __init__(
        self,
        name: str = "Experience Replay",
        alpha: float = 1.0,
        buffer_size: int = 50,
        replay_minibatch_size: int = 32,
        bg_weighted_ce: bool = False,
        same_task: bool = True,
        buffer_dtype: str = "bfloat16",
        buffer_image_dtype: str | None = None,
        **kwargs,
    ):
        super().__init__(name=name, **kwargs)
        self.alpha = alpha
        self.buffer_size = buffer_size
        self.replay_minibatch_size = replay_minibatch_size
        self.bg_weighted_ce = bg_weighted_ce
        self.same_task = same_task
        # device storage of the buffered images and logits: bf16 halves the
        # f32 bytes; images may be stored as uint8 pixels (lossless for
        # canonical crops, half of bf16's bytes)
        self.buffer_dtype = _DTYPES[buffer_dtype]
        self.buffer_image_dtype = _DTYPES[buffer_image_dtype or buffer_dtype]

    def init_buffer(self, task: Any, image_hw: Tuple[int, int],
                    logit_hw: Tuple[int, int], device: torch.device | str = "cuda"):
        """The empty buffer on ``device`` (CUDA unless the caller asks for
        the CPU; raises without a card)."""
        n_slots = self.buffer_size * task.n_tasks if self.same_task else self.buffer_size
        return buffer_lib.init_buffer(
            n_slots, image_hw, logit_hw, task.num_classes,
            image_dtype=self.buffer_image_dtype, logit_dtype=self.buffer_dtype,
            device=device,
        )

    def _partition(self, task_id: int) -> Optional[Tuple[int, int]]:
        """(first slot, slots) of task ``task_id``'s partition, or None for
        one flat buffer."""
        if not self.same_task:
            return None
        return task_id * self.buffer_size, self.buffer_size

    # ------------------------------------------------------------------

    def compute_loss(
        self,
        ctx: ModelContext,
        state,
        batch: Dict[str, torch.Tensor],
        train: bool,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, StepAux]:
        use_er = ctx.task.task_id > 0
        base = self.compute_base_loss(
            ctx, state, batch["image"], batch["label"], train, generator,
            use_weighted_ce=self.bg_weighted_ce and use_er and train,
            same_task=self.same_task,
        )
        loss = base.loss
        if train and use_er and state.buffer is not None:
            loss = loss + self.alpha * self.alpha * self._replay_er_loss(ctx, state, generator)
        return loss, StepAux(
            sem_logits=base.out.sem_logits[..., : ctx.n_cur],
            output=base.out,
            n_cur=ctx.n_cur,
            state_updates=proto_updates(base),
        )

    def _sample_replay(self, state, generator: Optional[torch.Generator], task_id: int):
        """A replay batch and its task (a device int; -1 for a flat buffer):
        from task 2 on, a partition drawn by ``partition_scores``, then a
        uniform sample within it (reference er.py:77-97,305-344)."""
        buf = state.buffer
        n = self.replay_minibatch_size
        if not self.same_task:
            mem = buffer_lib.sample(buf, n, generator)
            mem["task_id"] = -1
            return mem
        if task_id > 1:
            scores = partition_scores(buf.importance, buf.valid, task_id, self.buffer_size)
            part = torch.multinomial(scores, 1, generator=generator)[0].int()
        else:
            part = torch.zeros((), dtype=torch.int32, device=buf.valid.device)
        mem = buffer_lib.sample(buf, n, generator, task_id=part)
        mem["task_id"] = part
        return mem

    def _replay_er_loss(self, ctx: ModelContext, state,
                        generator: Optional[torch.Generator]) -> torch.Tensor:
        """The class-weighted CE (K4) of a replayed batch, re-augmented
        (the buffer holds canonical crops), where the classes 1 .. end of
        the replayed task weigh 1 (reference er.py:244-272); the seen
        detector trains on the replayed task's head (``same_task``)."""
        task = ctx.task
        mem = self._sample_replay(state, generator, task.task_id)
        cls = torch.arange(task.nb_current_classes, device=mem["labels"].device)
        if self.same_task:
            end = task.initial_classes + task.increment * mem["task_id"]
        else:
            end = task.old_classes
        weights = ((cls >= 1) & (cls < end)).float()
        images, labels = replay_augment(mem["images"], mem["labels"], generator)
        return self.compute_base_loss(
            ctx, state, images, labels, True, generator, task_num=mem["task_id"],
            class_weights=weights, is_replay=True, same_task=self.same_task,
        ).loss

    # ------------------------------------------------------------------

    @torch.no_grad()
    def end_task(self, state, ctx: ModelContext, data: Any):
        """Offer the task's batches to the buffer, the model in eval mode,
        until ``buffer_size`` items were offered (reference er.py:112-151),
        then the base hooks.  The reservoir's uniforms come from a generator
        seeded 1234 + task id, as JAX seeds its key."""
        task = ctx.task
        if state.buffer is None:
            return super().end_task(state, ctx, data)
        buf = state.buffer
        part = self._partition(task.task_id)
        if part is not None:
            # fresh reservoir bookkeeping per partition (reference: each task
            # gets a new Buffer, er.py:36-56)
            buf.num_seen = 0
            buf.class_counts = torch.zeros_like(buf.class_counts)
        generator = torch.Generator(buf.images.device)
        generator.manual_seed(1234 + task.task_id)
        w = torch.ones(ctx.n_cur, device=buf.images.device)
        w[0] = 0.0
        seen = 0
        for batch in data:
            image, labels = batch["image"], batch["label"]
            out = ctx.forward(state.model, image, False)
            nll = cross_entropy(out.logits[..., : ctx.n_cur], labels, self.ignore_index,
                                class_weights=w, reduction="none")
            losses = -nll.reshape(image.shape[0], -1).mean(dim=1)
            sem = F.pad(out.sem_logits[..., : ctx.n_cur].float(),
                        (0, task.num_classes - ctx.n_cur))
            self._buffer_add(buf, image, sem, labels, losses, task, part, generator)
            seen += image.shape[0]
            if seen >= self.buffer_size:  # (reference er.py:149-150)
                break
        return super().end_task(state, ctx, data)

    def _buffer_add(self, buf, image, sem, labels, losses, task, part,
                    generator: Optional[torch.Generator] = None, uniforms=None):
        """Reservoir-add a batch, in place: into the whole buffer, or into
        the partition ``part`` = (first slot, slots), whose views take the
        writes while its reservoir count and class counts ride the buffer's
        (reset at each task's end)."""
        kw = dict(task_id=task.task_id, n_classes=task.nb_current_classes,
                  ignore_index=self.ignore_index, uniforms=uniforms, generator=generator)
        if part is None:
            return buffer_lib.add_batch(buf, image, sem, labels, losses, **kw)
        offset, size = part
        sub = buffer_lib.BufferState(
            **{f: getattr(buf, f)[offset: offset + size] for f in _SLOT_FIELDS},
            class_counts=buf.class_counts, num_seen=buf.num_seen)
        buffer_lib.add_batch(sub, image, sem, labels, losses, **kw)
        buf.class_counts, buf.num_seen = sub.class_counts, sub.num_seen
        return buf
