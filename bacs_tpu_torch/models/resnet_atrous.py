"""SDR-style atrous ResNet backbone, NCHW in channels_last memory.

Port of ``bacs_tpu/models/resnet_atrous.py`` (``AtrousBottleneck``,
``ResNetAtrous``, ``create_resnet_atrous``): torchvision-style bottlenecks
(norm then ReLU after every convolution, ReLU after the residual add, the
stride on the 3x3 convolution), the last stage's atrous multipliers of
``ATROUS_NETS`` ([2, 2, 2] for ResNet-101/152, [1, 2, 1] for ResNet-50),
and five attention maps: the stem's output, then each stage's
(post-activation).  Output stride 16 gives stage strides [2, 2, 1] and
the last stage's rates x1; 8 gives [2, 1, 1], rate 2 in stage 3 and x2 in
the last.  Submodule names are the Flax module names (``layer3_block2``,
``downsample_bn``, ...), so a Flax variable path is a state_dict key
(``utils/flax_weights.py``).

The norm is injected: ``create_network`` gives the synchronized ``bn`` of
momentum 3e-4 (``models/norm.py``), whose train mode is the non-fused
branch; ``remat`` recomputes the chosen stages' blocks in the backward, as
``models/resnet.py``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from bacs_tpu_torch.models.norm import ABN
from bacs_tpu_torch.models.resnet import _remat_contexts, conv, stage_remat

# structure and last-stage atrous multipliers (reference: resnet_atrous.py:231-239)
ATROUS_NETS = {
    "resnet50": ([3, 4, 6, 3], [1, 2, 1]),
    "resnet101": ([3, 4, 23, 3], [2, 2, 2]),
    "resnet152": ([3, 8, 36, 3], [2, 2, 2]),
}


class AtrousBottleneck(nn.Module):
    """Torchvision-style bottleneck: stride on conv2, ReLU after the add."""

    def __init__(self, in_features: int, planes: int, stride: int = 1, atrous: int = 1,
                 norm: Callable[..., nn.Module] = ABN):
        super().__init__()
        out_ch = planes * 4
        self.conv1 = conv(in_features, planes, 1)
        self.bn1 = norm(planes)
        self.conv2 = conv(planes, planes, 3, stride, atrous)
        self.bn2 = norm(planes)
        self.conv3 = conv(planes, out_ch, 1)
        self.bn3 = norm(out_ch, activation="identity")
        self.needs_proj = stride != 1 or in_features != out_ch
        if self.needs_proj:
            self.downsample_conv = conv(in_features, out_ch, 1, stride)
            self.downsample_bn = norm(out_ch, activation="identity")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn1(self.conv1(x))
        y = self.bn2(self.conv2(y))
        y = self.bn3(self.conv3(y))
        residual = self.downsample_bn(self.downsample_conv(x)) if self.needs_proj else x
        return torch.relu(y + residual)


class ResNetAtrous(nn.Module):
    """Returns (features, [5 post-activation attention maps])."""

    out_channels = 2048

    def __init__(self, structure: Sequence[int] = (3, 4, 23, 3),
                 atrous: Sequence[int] = (2, 2, 2), output_stride: int = 16,
                 norm: Callable[..., nn.Module] = ABN, remat=False):
        super().__init__()
        if output_stride == 16:
            stride_list = [2, 2, 1]
        elif output_stride == 8:
            stride_list = [2, 1, 1]
        else:
            raise ValueError("output stride must be 8 or 16")
        rate = 16 // output_stride
        self.conv1 = conv(3, 64, 7, 2)
        self.bn1 = norm(64, pool=True)
        self.stages = []  # block names per stage
        self.remat_blocks = set()
        in_features = 64
        for s, (planes, n_blocks) in enumerate(zip((64, 128, 256, 512), structure)):
            if s == 3:
                rates = ([a * rate for a in atrous] * n_blocks)[:n_blocks]
            else:
                rates = [rate if s == 2 else 1] * n_blocks
            names = []
            for b in range(n_blocks):
                name = f"layer{s + 1}_block{b + 1}"
                stride = (1, *stride_list)[s] if b == 0 else 1
                self.add_module(name, AtrousBottleneck(in_features, planes, stride,
                                                       rates[b], norm))
                in_features = planes * 4
                names.append(name)
                if stage_remat(remat, s + 1):
                    self.remat_blocks.add(name)
            self.stages.append(names)

    def forward(self, x: torch.Tensor):
        x = self.bn1(self.conv1(x))
        attentions = [x]  # post-stem (reference: resnet_atrous.py:199)
        for names in self.stages:
            for name in names:
                block = getattr(self, name)
                if name in self.remat_blocks and self.training and torch.is_grad_enabled():
                    x = checkpoint(block, x, use_reentrant=False, context_fn=_remat_contexts)
                else:
                    x = block(x)
            attentions.append(x)
        return x, attentions


def create_resnet_atrous(name: str = "resnet101", norm: Callable[..., nn.Module] = ABN,
                         output_stride: int = 16, remat=False) -> ResNetAtrous:
    structure, atrous = ATROUS_NETS[name]
    return ResNetAtrous(structure, atrous, output_stride, norm, remat)
