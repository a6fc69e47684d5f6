"""Train and eval step factory on one device.

Port of ``bacs_tpu/train/step.py`` (``_train_step_impl``,
``_eval_step_impl`` and ``make_steps`` without a mesh, ``:27-122``).  The
JAX steps are pure jitted functions over a donated state; here the network,
its ABN statistics and the optimizer are updated in place and the same
state object is returned.

- ``train_step(state, batch) -> (state, {"loss": ...})``: the network in
  train mode; the method's loss (given ``state.generator`` for its random
  draws), its gradients, one optimizer update (clip, weight decay,
  SGD-nesterov at the scheduled rate), and the method's state updates
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

On the card every step runs the hand-written kernels: in training the
train-ABN apply and, by method, the upsample+CE forward and backward (CE,
K1) or the BACS seen-weighted and class-weighted upsample+CE forward and
backward (BACS at task > 0, K3 and K4, ``ops/upsample_ce.py``) with the
previous model's eval ABN; in evaluation the eval ABN, the upsample+CE
forward and the confusion kernel.  Multi-device steps (the JAX mesh path,
``make_gspmd_steps``) are ROADMAP.md queue 1 item 10; ``_multi_step_impl``
only hides the TPU host's dispatch cost and is not ported.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

from bacs_tpu_torch.methods.base import Method, ModelContext
from bacs_tpu_torch.ops.confusion import confusion_matrix
from bacs_tpu_torch.ops.upsample_confusion import upsampled_confusion
from bacs_tpu_torch.train.optim import apply_updates
from bacs_tpu_torch.train.state import TrainState


def _train_step_impl(
    ctx: ModelContext,
    method: Method,
    state: TrainState,
    batch: Dict[str, torch.Tensor],
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    state.optimizer.zero_grad(set_to_none=True)
    loss, aux = method.compute_loss(ctx, state, batch, True, state.generator)
    loss.backward()
    apply_updates(state.optimizer, state.scheduler)
    for field, value in aux.state_updates.items():
        setattr(state, field, value)
    state.step += 1
    state.epoch_step += 1
    return state, {"loss": loss.detach()}


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
    conf_mat += cm
    return conf_mat, loss


def make_steps(
    ctx: ModelContext,
    method: Method,
    num_classes: int,
    mesh: Optional[Any] = None,
    device: str | torch.device = "cuda",
) -> Tuple[Callable, Callable, Callable]:
    """Build (train_step, eval_step, put_batch) for one task on ``device``.

    The optimizer lives in the ``TrainState`` (torch optimizers hold their
    parameters), so unlike the JAX factory this one takes no ``tx``.
    Asking for CUDA where torch sees none raises; nothing falls back to the
    CPU.
    """
    if mesh is not None:
        raise NotImplementedError("multi-device steps are ROADMAP.md queue 1 item 10")
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
