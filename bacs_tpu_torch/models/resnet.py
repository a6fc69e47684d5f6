"""ABN ResNet backbones, NCHW in channels_last memory.

Port of ``bacs_tpu/models/resnet.py`` (``conv``, ``Bottleneck``,
``BasicBlock``, ``ResNet``, ``create_resnet``).  Submodule names are the Flax
module names (``conv1``, ``bn1``, ``mod2_block1``, ...), so a Flax variable
path is a torch state_dict key (``utils/flax_weights.py``).  The last block
of every stage also returns its pre-activation sum as an attention map.

``remat`` (the config's ``network.remat``) recomputes the blocks of the
chosen stages in the backward instead of keeping their activations, as
JAX's ``nn.remat`` per block (``bacs_tpu/models/resnet.py:187-193``):
``torch.utils.checkpoint`` per block, the recompute under
``models/norm.py:recomputing`` so that the running statistics update once.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from bacs_tpu_torch.models.norm import ABN, activate, recomputing


def stage_remat(remat, stage: int) -> bool:
    """Whether stage ``stage`` (1-indexed, 1 the highest resolution)
    recomputes its blocks: ``remat`` is false, true (every stage) or a
    tuple of stage ids (``bacs_tpu/models/resnet.py:28-36``)."""
    if isinstance(remat, (tuple, list)):
        return stage in tuple(remat)
    return bool(remat)


def _remat_contexts():
    return contextlib.nullcontext(), recomputing()


RESNET_STRUCTURES = {
    "resnet18": ([2, 2, 2, 2], False),
    "resnet34": ([3, 4, 6, 3], False),
    "resnet50": ([3, 4, 6, 3], True),
    "resnet101": ([3, 4, 23, 3], True),
    "resnet152": ([3, 8, 36, 3], True),
}


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in ``compute_dtype`` whatever dtype its
    parameters hold, as a Flax ``nn.Conv`` with ``dtype=`` does beside its
    ``param_dtype``.  The forward casts input, weight and bias to
    ``compute_dtype``; autograd casts the gradients back, so f32 master
    weights train with bf16 convolutions and receive f32 gradients.
    ``None`` computes in the weight's dtype.
    """

    compute_dtype = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


def conv(in_features, features, kernel, stride=1, dilation=1) -> Conv2d:
    """Bias-free conv with the JAX package's explicit symmetric padding."""
    pad = ((kernel - 1) // 2) * dilation
    return Conv2d(
        in_features, features, kernel, stride=stride, padding=pad,
        dilation=dilation, bias=False,
    )


class Bottleneck(nn.Module):
    """ABN bottleneck block; optionally also returns its pre-activation."""

    def __init__(
        self,
        in_features: int,
        channels: Tuple[int, int, int],
        stride: int = 1,
        dilation: int = 1,
        norm: Callable[..., nn.Module] = ABN,
        last: bool = False,
    ):
        super().__init__()
        c1, c2, c3 = channels
        self.last = last
        self.conv1 = conv(in_features, c1, 1)
        self.bn1 = norm(c1)
        self.conv2 = conv(c1, c2, 3, stride, dilation)
        self.bn2 = norm(c2)
        self.conv3 = conv(c2, c3, 1)
        # final norm has identity activation; activation applied after the add
        self.bn3 = norm(c3, activation="identity")
        self.needs_proj = stride != 1 or in_features != c3
        if self.needs_proj:
            self.proj_conv = conv(in_features, c3, 1, stride)
            self.proj_bn = norm(c3, activation="identity")

    def forward(self, x: torch.Tensor):
        y = self.bn1(self.conv1(x))
        y = self.bn2(self.conv2(y))
        y = self.bn3(self.conv3(y))
        residual = self.proj_bn(self.proj_conv(x)) if self.needs_proj else x
        pre_act = y + residual
        act = activate(pre_act, self.bn1.activation, self.bn1.activation_param)
        return (act, pre_act) if self.last else act


class BasicBlock(nn.Module):
    """Two-conv residual block (resnet18/34)."""

    def __init__(
        self,
        in_features: int,
        channels: Tuple[int, int],
        stride: int = 1,
        dilation: int = 1,
        norm: Callable[..., nn.Module] = ABN,
        last: bool = False,
    ):
        super().__init__()
        c1, c2 = channels
        self.last = last
        self.conv1 = conv(in_features, c1, 3, stride, dilation)
        self.bn1 = norm(c1)
        self.conv2 = conv(c1, c2, 3, 1, dilation)
        self.bn2 = norm(c2, activation="identity")
        self.needs_proj = stride != 1 or in_features != c2
        if self.needs_proj:
            self.proj_conv = conv(in_features, c2, 1, stride)
            self.proj_bn = norm(c2, activation="identity")

    def forward(self, x: torch.Tensor):
        y = self.bn1(self.conv1(x))
        y = self.bn2(self.conv2(y))
        residual = self.proj_bn(self.proj_conv(x)) if self.needs_proj else x
        pre_act = y + residual
        act = activate(pre_act, self.bn1.activation, self.bn1.activation_param)
        return (act, pre_act) if self.last else act


class ResNet(nn.Module):
    """4-stage ResNet returning (features, [4 attention maps]).

    Output stride 16 -> dilation [1,1,1,2]; 8 -> [1,1,2,4].
    """

    def __init__(
        self,
        structure: Sequence[int] = (3, 4, 23, 3),
        bottleneck: bool = True,
        output_stride: int = 16,
        norm: Callable[..., nn.Module] = ABN,
        remat=False,
    ):
        super().__init__()
        if output_stride == 16:
            dilation = [1, 1, 1, 2]
        elif output_stride == 8:
            dilation = [1, 1, 2, 4]
        else:
            raise ValueError("output stride must be 8 or 16")
        self.out_channels = 2048 if bottleneck else 512
        self.conv1 = conv(3, 64, 7, 2)
        self.bn1 = norm(64, pool=True)
        channels = (64, 64, 256) if bottleneck else (64, 64)
        block_cls = Bottleneck if bottleneck else BasicBlock
        in_features = 64
        self.block_names: List[str] = []
        self.remat_blocks = set()
        for mod_id, num in enumerate(structure):
            d = dilation[mod_id]
            for block_id in range(num):
                stride = 2 if d == 1 and block_id == 0 and mod_id > 0 else 1
                name = f"mod{mod_id + 2}_block{block_id + 1}"
                self.add_module(name, block_cls(
                    in_features, tuple(channels), stride=stride, dilation=d,
                    norm=norm, last=block_id == num - 1,
                ))
                self.block_names.append(name)
                if stage_remat(remat, mod_id + 1):
                    self.remat_blocks.add(name)
                in_features = channels[-1]
            channels = tuple(c * 2 for c in channels)

    def forward(self, x: torch.Tensor):
        x = self.bn1(self.conv1(x))
        attentions = []
        for name in self.block_names:
            block = getattr(self, name)
            if name in self.remat_blocks and self.training and torch.is_grad_enabled():
                out = checkpoint(block, x, use_reentrant=False,
                                 context_fn=_remat_contexts)
            else:
                out = block(x)
            if block.last:
                x, att = out
                attentions.append(att)
            else:
                x = out
        return x, attentions


def create_resnet(
    name: str = "resnet101",
    norm: Callable[..., nn.Module] = ABN,
    output_stride: int = 16,
    remat=False,
) -> ResNet:
    structure, bottleneck = RESNET_STRUCTURES[name]
    return ResNet(structure, bottleneck, output_stride, norm, remat)
