"""Method base: the forward helper and the cross-entropy core of a step.

Port of ``bacs_tpu/methods/base.py`` for the fine-tuning CE method.  A
``Method`` is stateless: ``compute_loss`` runs the network on a batch and
returns the scalar loss and a ``StepAux`` that the eval step reads.  The
network and its statistics live in the ``TrainState``; what is static per
task lives in the ``ModelContext``.

Ported: ``compute_loss``, the CE branch of ``compute_base_loss``
(``methods/base.py:386-488``), ``_fused_gate`` (``:255-274``) without the
spatial mesh, and ``ce_with_upsample`` (``:276``).  The seen detector and
the prototypes (BACS) are ROADMAP.md queue 1 item 9 and raise; the
class-weighted fused CE (kernel K4) is ROADMAP.md queue 2 and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from bacs_tpu_torch.models.base import NetOutput
from bacs_tpu_torch.ops.losses import cross_entropy
from bacs_tpu_torch.ops.upsample_ce import upsampled_cross_entropy
from bacs_tpu_torch.train.state import TaskInfo


@dataclasses.dataclass
class StepAux:
    """What ``compute_loss`` returns besides the scalar loss.

    ``sem_logits`` are the pre-upsample logits of the active classes; the
    eval step's confusion kernel reads them.  ``logits`` (full resolution,
    active classes) is built only when read, from ``output``.
    """

    sem_logits: torch.Tensor
    output: NetOutput
    n_cur: int

    @property
    def logits(self) -> torch.Tensor:
        return self.output.logits[..., : self.n_cur]


@dataclasses.dataclass(frozen=True)
class ModelContext:
    """What is static per task.

    ``fused_ce`` is the config gate ``training.fused_ce`` of the upsample
    kernels.  The JAX context's ``axis_name`` and ``spatial_mesh`` serve
    multi-device steps (ROADMAP.md queue 1 item 10) and are not ported.
    """

    task: TaskInfo
    fused_ce: bool = True

    def forward(self, model: nn.Module, x: torch.Tensor, train: bool) -> NetOutput:
        model.train(train)
        return model(x)

    @property
    def n_cur(self) -> int:
        return self.task.nb_current_classes


class Method:
    """Base method (the fine-tuning CE core when used directly)."""

    def __init__(
        self,
        name: str = "base",
        ignore_index: int = 255,
        use_bg_detector: bool = False,
        track_prototypes: bool = False,
        **_: Any,
    ):
        if use_bg_detector or track_prototypes:
            raise NotImplementedError(
                "the seen detector and prototypes are ROADMAP.md queue 1 item 9"
            )
        self.name = name
        self.ignore_index = ignore_index

    def compute_loss(
        self,
        ctx: ModelContext,
        state,
        batch: Dict[str, torch.Tensor],
        train: bool,
    ) -> Tuple[torch.Tensor, StepAux]:
        loss, out = self.compute_base_loss(
            ctx, state, batch["image"], batch["label"], train
        )
        return loss, StepAux(
            sem_logits=out.sem_logits[..., : ctx.n_cur],
            output=out,
            n_cur=ctx.n_cur,
        )

    @staticmethod
    def _fused_gate(ctx: ModelContext, sem: torch.Tensor, labels: torch.Tensor) -> bool:
        """The fused upsample+CE kernel gate: the kernel when the head
        output is below label resolution, the composed CE otherwise."""
        return sem.shape[1] < labels.shape[1] and ctx.fused_ce

    def ce_with_upsample(
        self,
        ctx: ModelContext,
        sem: torch.Tensor,
        out: NetOutput,
        labels: torch.Tensor,
        class_weights: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Mean CE of the upsampled logits through ``_fused_gate``.

        ``sem`` is the pre-upsample head output (active classes); ``out``
        is read for the full-resolution logits only on the composed path.
        """
        if self._fused_gate(ctx, sem, labels):
            if class_weights is not None:
                raise NotImplementedError(
                    "the class-weighted upsample+CE kernel (K4) is ROADMAP.md "
                    "queue 2"
                )
            return upsampled_cross_entropy(
                sem.contiguous(), labels, tuple(labels.shape[1:3]), self.ignore_index
            )
        return cross_entropy(
            out.logits[..., : ctx.n_cur], labels,
            ignore_index=self.ignore_index, class_weights=class_weights,
        )

    def compute_base_loss(
        self,
        ctx: ModelContext,
        state,
        image: torch.Tensor,
        labels: torch.Tensor,
        train: bool,
    ) -> Tuple[torch.Tensor, NetOutput]:
        """The CE core (``bacs_tpu/methods/base.py:386-488`` without the
        seen detector): (loss, network output)."""
        out = ctx.forward(state.model, image, train)
        sem = out.sem_logits[..., : ctx.n_cur]
        return self.ce_with_upsample(ctx, sem, out, labels), out
