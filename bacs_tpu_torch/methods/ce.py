"""Fine-tuning cross-entropy baseline (port of ``bacs_tpu/methods/ce.py``)."""

from __future__ import annotations

from bacs_tpu_torch.methods.base import Method


class CrossEntropyMethod(Method):
    """Plain CE through the shared base core: the fine-tuning baseline."""

    def __init__(self, name: str = "CrossEntropy", **kwargs):
        super().__init__(name=name, **kwargs)
