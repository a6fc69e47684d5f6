"""Experience Replay: what BACS inherits of it.

Port of the parts of ``bacs_tpu/methods/er.py`` that ``BACSMethod`` uses:
``__init__`` and ``init_buffer`` (``:34-83``).  ER's own step
(``compute_loss``, ``_sample_replay``, ``_replay_er_loss``, ``:87-186``),
its per-task buffer partitions (``_partition``, ``_buffer_add``,
``:238-269``) and its eval-mode buffer population are ROADMAP.md queue 1
item 9 and raise or are absent.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from bacs_tpu_torch.methods.base import Method
from bacs_tpu_torch.train import buffer as buffer_lib

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "uint8": torch.uint8}


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

    def compute_loss(self, *args, **kwargs):
        raise NotImplementedError("the ER step is ROADMAP.md queue 1 item 9")

    def end_task(self, *args, **kwargs):
        raise NotImplementedError("ER's buffer population is ROADMAP.md queue 1 item 9")
