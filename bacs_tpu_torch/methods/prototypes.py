"""Per-task prototype tracking with the CE objective.

Port of ``bacs_tpu/methods/prototypes.py`` (reference loss/prototypes.py):
the method switches ``track_prototypes`` on; the prototype folds are
``methods/base.py``'s (``update_task_prototypes`` in every training step,
``_sweep_prototypes`` at a task's end) and the loss is the base CE (K1).
"""

from __future__ import annotations

from bacs_tpu_torch.methods.base import Method


class PrototypesMethod(Method):
    def __init__(self, name: str = "Prototypes", **kwargs):
        kwargs["track_prototypes"] = True
        super().__init__(name=name, **kwargs)
