"""BACS seen/unseen background detector.

Port of ``bacs_tpu/models/bg_detector.py``: a shared 3x3 conv -> batch norm
-> ReLU -> dropout trunk over the backbone features, and one "siamese
distance" head per task, |sigmoid(features) - sigmoid(prototype_t)| -> a
1 x 1 projection, upsampled x16 with aligned corners.  All task heads are
one ``head_kernel`` [T, D, 1] and one ``head_bias`` [T, 1] parameter, under
the Flax names.  The trunk takes and returns NCHW tensors (the backbone's),
the heads NHWC ones (``NetOutput.penultimate``).

The trunk's norm is Flax ``nn.BatchNorm(momentum=0.9)``, written out here
because it differs from ``torch.nn.BatchNorm2d``: statistics in float32
with var = E[x^2] - E[x]^2 (clipped at 0), and the running variance
updated with that biased batch variance, running = 0.9 running + 0.1 batch.
Dropout draws its mask from the generator the forward is given (the train
step's), as ``F.dropout`` cannot take one.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from bacs_tpu_torch.models.resnet import conv
from bacs_tpu_torch.ops.interpolate import resize_bilinear
from bacs_tpu_torch.ops.losses import jax_abs


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm`` (momentum 0.9, eps 1e-5) over NCHW, in f32."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


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

    def trunk(self, x: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The shared layers: [N, C, h, w] -> [N, C/4, h, w] f32."""
        y = torch.relu(self.base_bn(self.base_conv(x)))
        if self.training and self.dropout_rate > 0:
            keep = 1.0 - self.dropout_rate
            mask = torch.rand(y.shape, generator=generator, device=y.device) < keep
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
