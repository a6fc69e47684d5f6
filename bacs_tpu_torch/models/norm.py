"""ABN: batch norm fused with its activation, eval mode.

Port of ``bacs_tpu/models/norm.py`` (``ABN`` and ``make_norm``) for
inference.  Every eval-mode ABN runs through the K5 wrapper
(``ops/abn_core.py``, Triton on the card) with the activation as a slope:
leaky_relu -> its parameter, relu -> 0, identity -> 1.  ``pool=True`` (the
ResNet stem) follows the apply with a 3x3/2 max-pool padded by 1, padding
counting as -inf as in Flax.

Train mode (batch statistics, momentum, the renorm/ABR variant, the
in-place backward, cross-GPU sync) is ROADMAP.md queue 1 item 2 and raises
until it lands.  In eval mode renorm changes nothing (the JAX module skips
it when it uses running statistics), so the renorm norms build the same
layer as the plain ones.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from bacs_tpu_torch.ops.abn_core import fused_abn_eval


def activation_slope(activation: str, param: float) -> float:
    """The leaky slope that expresses ``activation``."""
    if activation == "leaky_relu":
        return float(param)
    if activation == "relu":
        return 0.0
    if activation == "identity":
        return 1.0
    raise ValueError(f"activation {activation!r} has no eval-mode ABN kernel")


def activate(x: torch.Tensor, activation: str, param: float) -> torch.Tensor:
    """The block-output activation (after a residual add), plain PyTorch."""
    slope = activation_slope(activation, param)
    return x if slope == 1.0 else F.leaky_relu(x, slope)


class ABN(nn.Module):
    """Activated batch norm on NCHW tensors in channels_last memory.

    Parameters and buffers carry the torch names (``weight``, ``bias``,
    ``running_mean``, ``running_var``) of the Flax ``scale``, ``bias``,
    ``mean`` and ``var``, all float32.
    """

    def __init__(
        self,
        features: int,
        eps: float = 1e-5,
        activation: str = "leaky_relu",
        activation_param: float = 0.01,
        pool: bool = False,
    ):
        super().__init__()
        self.features = features
        self.eps = eps
        self.activation = activation
        self.activation_param = activation_param
        self.pool = pool
        self.slope = activation_slope(activation, activation_param)
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "train-mode ABN is ROADMAP.md queue 1 item 2; call .eval()"
            )
        x = x.contiguous(memory_format=torch.channels_last)
        y = fused_abn_eval(
            x.permute(0, 2, 3, 1), self.running_mean, self.running_var,
            self.weight, self.bias, self.eps, self.slope,
        ).permute(0, 3, 1, 2)
        if self.pool:
            y = F.max_pool2d(y, kernel_size=3, stride=2, padding=1)
        return y

    def extra_repr(self) -> str:
        return (f"{self.features}, activation={self.activation}, "
                f"slope={self.slope}, pool={self.pool}")


_LEAKY_NORMS = ("iabn_sync", "abn_sync", "iabn", "abn",
                "iabr_sync", "abr_sync", "iabr", "abr")


def make_norm(norm: str):
    """Norm-layer factory from the reference's norm strings.

    Returns ``f(features, **overrides) -> ABN``.  The sync and renorm
    variants differ from the others only in training, not ported yet.
    """
    if norm == "bn":
        return functools.partial(ABN, activation="relu", activation_param=0.0)
    if norm in _LEAKY_NORMS:
        return functools.partial(ABN, activation="leaky_relu",
                                 activation_param=0.01)
    raise NotImplementedError(f"Selected Norm {norm} is not supported")
