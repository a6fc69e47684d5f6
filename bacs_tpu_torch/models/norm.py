"""ABN: batch norm fused with its activation.

Port of ``bacs_tpu/models/norm.py`` (``ABN`` and ``make_norm``).  The
activation is a slope: leaky_relu -> its parameter, relu -> 0, identity
-> 1.  ``pool=True`` (the ResNet stem) follows the apply with a 3x3/2
max-pool padded by 1, padding counting as -inf as in Flax.

- Eval mode: every layer runs the K5 wrapper ``fused_abn_eval``
  (``ops/abn_core.py``, Triton on the card) with the running statistics.
  Renorm changes nothing there (the JAX module skips it with running
  statistics), so the renorm norms build the same layer as the plain ones.
- Train mode: the fused branch of the JAX module (``norm.py:102-139``):
  ``fused_abn`` (in-place-ABN backward) on the batch statistics, then the
  torch-style running update with momentum and the n/(n-1) Bessel factor
  on the variance (``norm.py:65-72``).  The stem's fused ABN + max-pool
  kernel (``fused_stem``) stays off, as its JAX default is.  The non-fused
  branch, which the JAX module takes for ReLU (``bn``) and the renorm/ABR
  variants (``norm.py:141-185``), and cross-GPU statistics are ROADMAP.md
  queue 1 items 2 and 10; they raise.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from bacs_tpu_torch.ops.abn_core import fused_abn, fused_abn_eval


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
    ``mean`` and ``var``, all float32.  ``momentum`` is torch's:
    running = (1 - m) * running + m * batch.
    """

    def __init__(
        self,
        features: int,
        eps: float = 1e-5,
        momentum: float = 0.1,
        activation: str = "leaky_relu",
        activation_param: float = 0.01,
        renorm: bool = False,
        pool: bool = False,
    ):
        super().__init__()
        self.features = features
        self.eps = eps
        self.momentum = momentum
        self.activation = activation
        self.activation_param = activation_param
        self.renorm = renorm
        self.pool = pool
        self.slope = activation_slope(activation, activation_param)
        # the JAX module's fused branch: an invertible activation, no renorm
        self.fusable = not renorm and (
            activation == "identity"
            or (activation == "leaky_relu" and activation_param > 0))
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        if not self.training:
            y = fused_abn_eval(x, self.running_mean, self.running_var,
                               self.weight, self.bias, self.eps, self.slope)
        elif self.fusable:
            y, mean, var = fused_abn(x, self.weight, self.bias, self.eps, self.slope)
            n = x.numel() // self.features
            m = self.momentum
            with torch.no_grad():
                self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                self.running_var.mul_(1.0 - m).add_(var, alpha=m * n / max(n - 1, 1))
        else:
            raise NotImplementedError(
                f"train-mode ABN with activation {self.activation!r}"
                f"{' and renorm' if self.renorm else ''} takes the non-fused "
                "branch, ROADMAP.md queue 1 item 2"
            )
        y = y.permute(0, 3, 1, 2)
        if self.pool:
            y = F.max_pool2d(y, kernel_size=3, stride=2, padding=1)
        return y

    def extra_repr(self) -> str:
        return (f"{self.features}, activation={self.activation}, "
                f"slope={self.slope}, renorm={self.renorm}, pool={self.pool}")


_RENORMS = ("iabr_sync", "abr_sync", "iabr", "abr")
_LEAKY_NORMS = ("iabn_sync", "abn_sync", "iabn", "abn") + _RENORMS


def make_norm(norm: str):
    """Norm-layer factory from the reference's norm strings.

    Returns ``f(features, **overrides) -> ABN``.  The sync variants differ
    from the others only across GPUs (ROADMAP.md queue 1 item 10); ``bn``
    keeps the reference's momentum 3e-4 (``bacs_tpu/models/norm.py:205-213``).
    """
    if norm == "bn":
        return functools.partial(ABN, activation="relu", activation_param=0.0,
                                 momentum=0.0003)
    if norm in _LEAKY_NORMS:
        return functools.partial(ABN, activation="leaky_relu",
                                 activation_param=0.01,
                                 renorm=norm in _RENORMS)
    raise NotImplementedError(f"Selected Norm {norm} is not supported")
