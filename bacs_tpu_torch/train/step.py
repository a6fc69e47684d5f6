"""Train and eval step factory, on one device or data-parallel over ranks.

Port of ``bacs_tpu/train/step.py`` (``_train_step_impl``,
``_eval_step_impl`` and ``make_steps``, ``:27-122,175-230``).  The JAX
steps are pure jitted functions over a donated state; here the network,
its ABN statistics and the optimizer are updated in place and the same
state object is returned.

- ``train_step(state, batch) -> (state, {"loss": ...})``: the network in
  train mode; the method's loss (given the step's key for its random
  draws: ``state.key`` split in two, one half carried in the state and
  the other the step's, as JAX splits ``state.rng``), its gradients, one
  optimizer update (clip, weight decay, SGD-nesterov at the scheduled
  rate), and the method's state updates
  (prototypes and their counts, the buffer).  The gradients stay in the
  parameters' ``.grad`` until the next step.  With gradient accumulation
  over k mini-steps (``train/optim.py``) a call is one mini-step: its
  gradients join their running mean and the update runs on every k-th
  call, while the running statistics and the method's state update on
  every call, as JAX's ``batch_stats`` do under ``optax.MultiSteps``.
- ``eval_step(state, conf_mat, batch) -> (conf_mat, loss)``: the network
  in eval mode, no gradients; the batch's confusion matrix is added to
  ``conf_mat`` in place.  Below label resolution it comes from the
  upsample+argmax+confusion kernel (``ops/upsample_confusion.py``), so the
  full-resolution logits never exist.
- ``put_batch(batch) -> batch``: the image (float NHWC) and label (int
  [N, H, W]) arrays as contiguous tensors on the step's device.

Data parallelism (the JAX ``shard_map`` over the ``data`` mesh axis) is
the context's process ``group`` (``parallel/``): each rank gets its
contiguous slice of the global batch, and the steps do what JAX's
collectives do.  The synchronized norms reduce their statistics across
the ranks (``parallel.synchronized``), the prototype folds sum theirs, and
each rank draws from its own key (``rng.train_step_keys``: the rank
folded into the step's key, as JAX folds it).  After the backward one
collective averages the gradients, the loss and the running statistics
(``step.py:45-50``): each rank's loss is the mean over its own shard, so
the loss is the mean of the shard means, not the global batch's mean
where shards hold different counts of ignored pixels.  A parameter the
loss did not reach counts as a zero gradient on every rank, so the
update that follows (clip after the average, as optax runs after
``pmean``; under accumulation each mini-step's average joins the running
mean) is the same everywhere.  The eval step sums the confusion matrices
and averages the loss.

On the card every step runs the hand-written kernels: in training the
train-ABN apply and, by method, the upsample+CE forward and backward (CE,
K1) or the BACS seen-weighted and class-weighted upsample+CE forward and
backward (BACS at task > 0, K3 and K4, ``ops/upsample_ce.py``) with the
previous model's eval ABN; in evaluation the eval ABN, the upsample+CE
forward and the confusion kernel.  GSPMD's spatial partitioning
(``make_gspmd_steps``) and ``_multi_step_impl`` (which only hides the
TPU host's dispatch cost) are not ported.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Tuple

import torch

from bacs_tpu_torch.methods.base import Method, ModelContext
from bacs_tpu_torch.ops.confusion import confusion_matrix
from bacs_tpu_torch.ops.upsample_confusion import upsampled_confusion
from bacs_tpu_torch.ops import rng
from bacs_tpu_torch.parallel import all_reduce_, rank, synchronized
from bacs_tpu_torch.train.optim import apply_updates, zero_missing_grads
from bacs_tpu_torch.train.state import TrainState


def running_stats(model: torch.nn.Module):
    """The network's running statistics (the JAX ``batch_stats``)."""
    return [b for name, b in model.named_buffers()
            if name.endswith(("running_mean", "running_var"))]


def _average_across_ranks(state: TrainState, loss: torch.Tensor, group) -> torch.Tensor:
    """Average the gradients (a missing one as zeros), the loss and the
    running statistics across ``group`` in one collective per dtype;
    returns the averaged loss."""
    params = zero_missing_grads(state.optimizer)
    loss = loss.detach().clone()
    all_reduce_([p.grad for p in params] + running_stats(state.model) + [loss], group)
    return loss


def _train_step_impl(
    ctx: ModelContext,
    method: Method,
    state: TrainState,
    batch: Dict[str, torch.Tensor],
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    group = ctx.group
    state.optimizer.zero_grad(set_to_none=True)
    state.key, step_key = rng.train_step_keys(rng.given(state.key),
                                              None if group is None else rank(group))
    with synchronized(group):
        loss, aux = method.compute_loss(ctx, state, batch, True, step_key)
        loss.backward()
    loss = loss.detach() if group is None else _average_across_ranks(state, loss, group)
    apply_updates(state.optimizer, state.scheduler)
    for field, value in aux.state_updates.items():
        setattr(state, field, value)
    state.step += 1
    state.epoch_step += 1
    return state, {"loss": loss}


@torch.no_grad()
def _eval_step_impl(
    ctx: ModelContext,
    method: Method,
    num_classes: int,
    state: TrainState,
    conf_mat: torch.Tensor,
    batch: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    loss, aux = method.compute_loss(ctx, state, batch, False)
    labels = batch["label"]
    label_hw = tuple(labels.shape[1:3])
    if tuple(aux.sem_logits.shape[1:3]) != label_hw and ctx.fused_ce:
        cm = upsampled_confusion(aux.sem_logits.contiguous(), labels, label_hw,
                                 num_classes)
    else:
        cm = confusion_matrix(aux.logits.argmax(dim=-1), labels, num_classes,
                              ignore_index=method.ignore_index)
    if ctx.group is not None:
        loss = loss.detach().clone()
        all_reduce_([cm], ctx.group, mean=False)
        all_reduce_([loss], ctx.group)
    conf_mat += cm
    return conf_mat, loss


def make_steps(
    ctx: ModelContext,
    method: Method,
    num_classes: int,
    device: str | torch.device = "cuda",
) -> Tuple[Callable, Callable, Callable]:
    """Build (train_step, eval_step, put_batch) for one task on ``device``,
    data-parallel over ``ctx.group`` when it is set.

    The optimizer lives in the ``TrainState`` (torch optimizers hold their
    parameters), so unlike the JAX factory this one takes no ``tx``; the
    JAX ``mesh`` is the context's group.  Asking for CUDA where torch sees
    none raises; nothing falls back to the CPU.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "make_steps(device='cuda') but torch sees no CUDA device; pass "
            "device='cpu' to train on the CPU"
        )

    def train_step(state, batch):
        return _train_step_impl(ctx, method, state, batch)

    def eval_step(state, conf_mat, batch):
        return _eval_step_impl(ctx, method, num_classes, state, conf_mat, batch)

    def put_batch(batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        return {
            "image": torch.as_tensor(batch["image"]).to(device).float().contiguous(),
            "label": torch.as_tensor(batch["label"]).to(device).contiguous(),
        }

    return train_step, eval_step, put_batch
