"""BACS seen/unseen background detector.

Port of ``bacs_tpu/models/bg_detector.py``: a shared 3x3 conv -> batch norm
-> ReLU -> dropout trunk over the backbone features, and one "siamese
distance" head per task, |sigmoid(features) - sigmoid(prototype_t)| -> a
1 x 1 projection, upsampled x16 with aligned corners.  All task heads are
one ``head_kernel`` [T, D, 1] and one ``head_bias`` [T, 1] parameter, under
the Flax names.  The trunk takes and returns NCHW tensors (the backbone's),
the heads NHWC ones (``NetOutput.penultimate``).

The trunk's norm is Flax ``nn.BatchNorm(momentum=0.9)``
(``models/norm.py:BatchNorm``, shared with UNet).
Dropout draws its mask (``ops/rng.bernoulli``, the keep probability) from
the key Flax's ``nn.Dropout`` takes: the forward's key with the module path
``seen_fg_network/dropout`` and the scope's first draw folded in
(``rng.scope_key``), over the NHWC shape of the JAX trunk's output, so the
mask is JAX's, and the same on the card (``csrc/threefry.cu``) as on the
CPU.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from bacs_tpu_torch.models.norm import BatchNorm
from bacs_tpu_torch.models.resnet import conv
from bacs_tpu_torch.ops import rng
from bacs_tpu_torch.ops.interpolate import resize_bilinear
from bacs_tpu_torch.ops.losses import jax_abs


# the Flax module path of the trunk's nn.Dropout (bacs_tpu/models/bg_detector.py:53)
DROPOUT_SCOPE = ("seen_fg_network", "dropout")


class BgDetector(nn.Module):
    def __init__(self, in_channels: int, n_tasks: int, dropout_rate: float = 0.1,
                 upscale: int = 16):
        super().__init__()
        inter = in_channels // 4
        self.dropout_rate = dropout_rate
        self.upscale = upscale
        self.base_conv = conv(in_channels, inter, 3)
        self.base_bn = BatchNorm(inter)
        # LeCun normal over the Flax fan-in (D x T), as the JAX initializer
        self.head_kernel = nn.Parameter(
            torch.randn(n_tasks, inter, 1) * (inter * n_tasks) ** -0.5)
        self.head_bias = nn.Parameter(torch.zeros(n_tasks, 1))

    def trunk(self, x: torch.Tensor, key: Optional[rng.Key] = None) -> torch.Tensor:
        """The shared layers: [N, C, h, w] -> [N, C/4, h, w] f32; ``key`` is
        the forward's (JAX's ``rngs={"dropout": key}``)."""
        y = torch.relu(self.base_bn(self.base_conv(x)))
        if self.training and self.dropout_rate > 0:
            keep = 1.0 - self.dropout_rate
            k = rng.scope_key(rng.given(key), DROPOUT_SCOPE, 1)
            n, c, h, w = y.shape
            mask = rng.bernoulli(k, keep, (n, h, w, c), y.device).permute(0, 3, 1, 2)
            y = torch.where(mask, y / keep, 0.0)
        return y

    def _head(self, x: torch.Tensor, prototype: torch.Tensor, t: int) -> torch.Tensor:
        # JAX's |.| derivative at 0: a feature equal to the prototype
        dist = jax_abs(torch.sigmoid(x) - torch.sigmoid(prototype))
        return torch.einsum("nhwd,do->nhwo", dist, self.head_kernel[t]) + self.head_bias[t]

    def _upsample(self, out: torch.Tensor) -> torch.Tensor:
        hw = (out.shape[1] * self.upscale, out.shape[2] * self.upscale)
        return resize_bilinear(out, hw, align_corners=True)

    def seen_map_task(self, x: torch.Tensor, prototypes: torch.Tensor,
                      task_num: int, stop_grads: bool) -> torch.Tensor:
        """Seen-logit map [N, 16h, 16w, 1] against one task's prototype;
        ``stop_grads`` detaches the features and the prototype."""
        proto = prototypes[task_num]
        if stop_grads:
            x, proto = x.detach(), proto.detach()
        return self._upsample(self._head(x, proto, task_num))

    def seen_probs(self, x: torch.Tensor, prototypes: torch.Tensor,
                   n_tasks: int) -> torch.Tensor:
        """Sigmoid seen-probabilities for tasks [0, n_tasks): [N, 16h, 16w, T]."""
        out = torch.cat([self._head(x, prototypes[t], t) for t in range(n_tasks)], -1)
        return torch.sigmoid(self._upsample(out))
