"""The train state and the static per-task class bookkeeping.

Port of ``bacs_tpu/train/state.py``.  ``TaskInfo`` is pure Python and is
copied as it is.  The JAX ``TrainState`` is one pytree carried through a
jitted step; in PyTorch the network holds its parameters and statistics
and the optimizer its moments, so the state is a plain dataclass of those
objects and the counters.  The continual-learning fields (prototypes,
previous model, replay buffer, PLOP thresholds) come with their methods
(ROADMAP.md queue 1 items 9 and 11).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0
    # batches consumed in the current epoch (mid-epoch resume granularity)
    epoch_step: int = 0


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
