"""The train state and the static per-task class bookkeeping.

Port of ``bacs_tpu/train/state.py``.  ``TaskInfo`` is pure Python and is
copied as it is.  The JAX ``TrainState`` is one pytree carried through a
jitted step; in PyTorch the network holds its parameters and statistics
and the optimizer its moments, so the state is a plain dataclass of those
objects, the continual-learning tensors and the counters.  The JAX state's
``rng`` key becomes ``generator``, a ``torch.Generator`` on the state's
device that the train step hands to the method (dropout, replay draws);
the frozen previous model is a module (``prev_params`` and
``prev_batch_stats`` in JAX).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import torch
from torch import nn

from bacs_tpu_torch.train.buffer import BufferState


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0
    # batches consumed in the current epoch (mid-epoch resume granularity)
    epoch_step: int = 0
    generator: Optional[torch.Generator] = None
    # per-task foreground prototypes [n_tasks, D] and their feature counts
    # [n_tasks], f32 (reference: loss/prototypes.py:53-90)
    prototypes: Optional[torch.Tensor] = None
    proto_counts: Optional[torch.Tensor] = None
    # SDR's per-class prototypes [num_classes, D] and their feature counts
    # [num_classes], f32, for methods with ``needs_class_prototypes``
    # (reference: loss/sdr.py:79-118)
    class_prototypes: Optional[torch.Tensor] = None
    class_proto_counts: Optional[torch.Tensor] = None
    # the frozen previous-task model, in eval mode, outside the optimizer
    prev_model: Optional[nn.Module] = None
    buffer: Optional[BufferState] = None
    # the epoch within the task (the seen detector's weight schedule,
    # bacs_tpu/methods/base.py:526-531)
    epoch: int = 0
    # PLOP's per-class entropy thresholds [num_classes] f32 and the
    # entropy normaliser log(C_cur), a scalar f32 tensor, both on the
    # state's device, set by PlopMethod.begin_task
    plop_thresholds: Optional[torch.Tensor] = None
    plop_max_entropy: Optional[torch.Tensor] = None


def frozen_copy(model: nn.Module) -> nn.Module:
    """A copy of ``model`` in eval mode whose parameters take no gradient:
    the previous-task model (reference: model.clone(),
    base_network.py:37-50)."""
    prev = copy.deepcopy(model).eval()
    for p in prev.parameters():
        p.grad = None
        p.requires_grad_(False)
    return prev


@dataclasses.dataclass(frozen=True)
class TaskInfo:
    """Static per-task class bookkeeping (all Python ints).

    Mirrors BaseLoss._update_task (reference: loss/base_loss.py:80-107).
    """

    task_id: int = 0
    initial_classes: int = 0
    increment: int = 0
    num_classes: int = 0  # final total
    n_tasks: int = 1
    max_epochs: int = 1
    ignore_index: int = 255
    # domain-incremental mode: every task sees all classes
    domain_shift: bool = False

    @property
    def nb_current_classes(self) -> int:
        if self.domain_shift or self.increment == 0:
            return self.num_classes
        return self.initial_classes + self.increment * self.task_id

    @property
    def old_classes(self) -> int:
        if self.domain_shift:
            return self.num_classes
        if self.task_id == 0 or self.increment == 0:
            return 0
        return self.initial_classes + self.increment * (self.task_id - 1)

    @property
    def nb_new_classes(self) -> int:
        if self.domain_shift:
            return self.num_classes
        if self.task_id == 0 or self.increment == 0:
            return self.nb_current_classes
        return self.increment

    @property
    def first_task(self) -> bool:
        return self.task_id == 0

    @property
    def continual(self) -> bool:
        return self.increment > 0
