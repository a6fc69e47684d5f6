"""Class-incremental scenario machinery (continuum-equivalent, in-repo).

The port's own copy of ``bacs_tpu/data/continual.py`` (numpy only):
``ContinualScenario``, ``shuffle_class_order`` and ``compute_class_sets``,
whose per-image class scan counts with ``np.bincount`` where the JAX
package calls its native ``class_presence`` (the same sets), and the
domain-incremental ``DomainScenario`` (Cityscapes cities).

What the JAX module re-implements, from the reference's `continuum`
library (reference: dataset/cityscape_dataset.py:110-215 `_filter_images`,
training/utils.py:225-261 `TransformLabel`):

- membership matrix [N, n_tasks]:
  overlap     — image has ≥1 pixel of a current-task class
  disjoint    — overlap AND every class in the image ∈ current ∪ old ∪ {0,255}
  sequential  — same membership as disjoint
- per-task label tables (a [256] lookup applied on device):
  train: sequential keeps old+current labels; disjoint/overlap keep only
  current (others → background 0); unknown classes → masking value
  eval "with_prev_tasks": classes of tasks 0..t labeled, future → 0
  (reference: dataloaders/base_datamodule.py:278-306)
- optional class-order shuffling: foreground classes are remapped to
  contiguous ids by order position (reference: base_datamodule.py:95-112).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class ContinualScenario:
    class_sets: List[np.ndarray]  # per-image unique original fg class ids
    initial_increment: int  # fg classes in task 0 (bg excluded)
    increment: int  # fg classes per later task
    num_classes: int  # total incl. background
    mode: str = "overlap"
    class_order: Optional[Sequence[int]] = None  # original fg ids, len C-1
    ignore_index: int = 255

    def __post_init__(self):
        n_fg = self.num_classes - 1
        if self.class_order is None:
            self.class_order = list(range(1, self.num_classes))
        assert len(self.class_order) == n_fg
        if self.increment > 0:
            assert (n_fg - self.initial_increment) % self.increment == 0
            self.n_tasks = 1 + (n_fg - self.initial_increment) // self.increment
        else:
            self.n_tasks = 1
        self._increments = [self.initial_increment] + [self.increment] * (
            self.n_tasks - 1
        )
        # original fg class id -> contiguous new id (order position + 1)
        self._new_id = {c: i + 1 for i, c in enumerate(self.class_order)}
        self._membership = self._build_membership()

    # ------------------------------------------------------------------

    def task_classes_original(self, task_id: int) -> List[int]:
        """Original dataset ids of the classes introduced at `task_id`."""
        start = sum(self._increments[:task_id])
        return list(self.class_order[start : start + self._increments[task_id]])

    def _build_membership(self) -> np.ndarray:
        t = np.zeros((len(self.class_sets), self.n_tasks), dtype=bool)
        acc = 0
        for task_id, inc in enumerate(self._increments):
            labels = set(self.class_order[acc : acc + inc])
            old = set(self.class_order[:acc])
            allowed = labels | old | {0, self.ignore_index}
            for i, classes in enumerate(self.class_sets):
                cs = set(int(c) for c in classes)
                has_current = bool(cs & labels)
                if self.mode == "overlap":
                    t[i, task_id] = has_current
                elif self.mode in ("disjoint", "sequential"):
                    t[i, task_id] = has_current and cs <= allowed
                else:
                    raise ValueError(f"Unknown mode={self.mode}")
            acc += inc
        return t

    def task_indices(self, task_id: int) -> np.ndarray:
        """Dataset indices belonging to task `task_id`'s train split."""
        return np.where(self._membership[:, task_id])[0]

    # ------------------------------------------------------------------

    def label_table(self, task_id: int, train: bool = True) -> np.ndarray:
        """[256] lookup: original label → training label for this task.

        train: visible = current task classes (+ old ones in sequential
        mode); everything else → 0; 255 stays 255.
        eval: visible = all classes of tasks 0..task_id ("with_prev_tasks"
        overlap eval scenario, reference base_datamodule.py:278-306).
        """
        table = np.zeros((256,), np.int32)
        table[self.ignore_index] = self.ignore_index
        if train and self.mode == "sequential":
            visible_tasks = range(task_id + 1)
        elif train:
            visible_tasks = [task_id]
        else:
            visible_tasks = range(task_id + 1)
        for t in visible_tasks:
            for orig in self.task_classes_original(t):
                table[orig] = self._new_id[orig]
        return table

    def n_classes_at(self, task_id: int) -> int:
        """Active class count (incl. bg) after task `task_id` starts."""
        return 1 + sum(self._increments[: task_id + 1])


def shuffle_class_order(num_classes: int, seed: int) -> List[int]:
    """Random fg class order (reference: base_datamodule.py:95-112)."""
    rng = np.random.RandomState(seed)
    order = np.arange(1, num_classes)
    rng.shuffle(order)
    return order.tolist()


def compute_class_sets(
    label_arrays,
    cache_path: Optional[str] = None,
) -> List[np.ndarray]:
    """Per-image unique class scan (reference: cityscape_dataset.py:201-215
    `_find_classes` — run through a Pool there; single pass + npz cache here).

    `label_arrays` is an iterable of label maps (np.ndarray) or callables
    returning them.
    """
    import os

    if cache_path is not None and os.path.exists(cache_path):
        data = np.load(cache_path, allow_pickle=True)
        return list(data["class_sets"])
    from bacs_tpu_torch.data import native

    sets = []
    for item in label_arrays:
        arr = np.asarray(item() if callable(item) else item)
        presence = native.class_presence(arr[None].astype(np.uint8))[0]
        ids = np.where(presence)[0]
        sets.append(ids[(ids != 0) & (ids != 255)].astype(np.int32))
    if cache_path is not None:
        os.makedirs(os.path.dirname(cache_path), exist_ok=True)
        np.savez_compressed(cache_path, class_sets=np.array(sets, dtype=object))
    return sets


class DomainScenario:
    """Domain-incremental scenario: tasks are domains (e.g. Cityscapes
    cities), every task carries the full label space.

    Redesign of the reference CityScapeDomainScenario
    (reference: dataloaders/cityscape_datamodule.py:270-348): per task,
    `n_domains_per_task` domains; train/val use an 80/20 shuffle split of
    each task's merged images (reference: ShuffleSplit per task).
    """

    def __init__(
        self,
        domain_ids,
        num_classes: int,
        n_domains_per_task: int = 1,
        val_fraction: float = 0.2,
        seed: int = 42,
    ):
        self.domain_ids = np.asarray(domain_ids)
        self.num_classes = num_classes
        domains = sorted(set(int(d) for d in self.domain_ids))
        self.domains = domains
        self.n_tasks = (len(domains) + n_domains_per_task - 1) // n_domains_per_task
        self.n_per_task = n_domains_per_task
        self.val_fraction = val_fraction
        self.seed = seed

    def _task_domains(self, task_id: int):
        lo = task_id * self.n_per_task
        return set(self.domains[lo : lo + self.n_per_task])

    def _split(self, task_id: int):
        doms = self._task_domains(task_id)
        idx = np.where(np.isin(self.domain_ids, list(doms)))[0]
        rng = np.random.RandomState(self.seed + task_id)
        perm = rng.permutation(idx)
        n_val = max(1, int(len(perm) * self.val_fraction))
        return perm[n_val:], perm[:n_val]

    def task_indices(self, task_id: int) -> np.ndarray:
        return self._split(task_id)[0]

    def val_indices(self, task_id: int) -> np.ndarray:
        return self._split(task_id)[1]

    def label_table(self, task_id: int, train: bool = True) -> np.ndarray:
        table = np.arange(256, dtype=np.int32)
        table[self.num_classes : 255] = 0
        table[255] = 255
        return table

    def n_classes_at(self, task_id: int) -> int:
        return self.num_classes
