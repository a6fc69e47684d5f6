"""DeepLabV3 (ABN ResNet backbone + ASPP head).

Port of ``bacs_tpu/models/deeplab.py`` (``DeepLabHead``, ``DeepLabV3``).
Public methods take and return NHWC tensors like the JAX module; inside,
tensors are NCHW in channels_last memory, so the permutes at the edges are
views.  Eager PyTorch has no dead-code elimination, so nothing builds the
full-resolution ``logits`` (a 352 MB f32 tensor at 512^2, batch 16, VOC-21)
unless it is read: ``NetOutput.logits`` is computed on first access, the
train and eval steps read only ``sem_logits`` on the kernel path, and the
Predictor calls :meth:`DeepLabV3.sem_logits`.  With ``use_bg_detector``
the network carries the BACS background detector (``models/bg_detector.py``)
and its penultimate output is the detector trunk's.  ``remat`` chooses the
backbone stages recomputed in the backward (``models/resnet.py``).  With
``atrous_encoder`` the backbone is the SDR atrous ResNet
(``models/resnet_atrous.py``: five attention maps, six with the head's).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from bacs_tpu_torch.models.base import NetOutput
from bacs_tpu_torch.models.bg_detector import BgDetector
from bacs_tpu_torch.models.norm import ABN
from bacs_tpu_torch.models.resnet import Conv2d, conv, create_resnet
from bacs_tpu_torch.models.resnet_atrous import create_resnet_atrous
from bacs_tpu_torch.ops import rng


class DeepLabHead(nn.Module):
    """ASPP head: 4 parallel map convs (1x1 + three dilated 3x3) -> concat
    -> ABN -> 1x1 reduction, summed with a broadcast global-pooling branch,
    then a final ABN."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int = 256,
        hidden_channels: int = 256,
        out_stride: int = 16,
        norm: Callable[..., nn.Module] = ABN,
    ):
        super().__init__()
        dil = [6, 12, 18] if out_stride == 16 else [12, 24, 32]
        h = hidden_channels
        self.map_conv0 = conv(in_channels, h, 1)
        self.map_conv1 = conv(in_channels, h, 3, dilation=dil[0])
        self.map_conv2 = conv(in_channels, h, 3, dilation=dil[1])
        self.map_conv3 = conv(in_channels, h, 3, dilation=dil[2])
        self.map_bn = norm(h * 4)
        self.red_conv = conv(h * 4, out_channels, 1)
        self.global_pooling_conv = conv(in_channels, h, 1)
        self.global_pooling_bn = norm(h)
        self.pool_red_conv = conv(h, out_channels, 1)
        self.red_bn = norm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        maps = [self.map_conv0(x), self.map_conv1(x), self.map_conv2(x),
                self.map_conv3(x)]
        out = self.map_bn(torch.cat(maps, dim=1))
        out = self.red_conv(out)
        # global pooling branch (adaptive avg-pool to 1x1, broadcast back)
        pool = x.mean(dim=(2, 3), keepdim=True)
        pool = self.global_pooling_bn(self.global_pooling_conv(pool))
        pool = self.pool_red_conv(pool)
        return self.red_bn(out + pool)


class DeepLabV3(nn.Module):
    """DeepLabV3 with an ABN ResNet backbone; returns the NetOutput contract."""

    def __init__(
        self,
        num_classes: int,
        backbone_name: str = "resnet101",
        output_stride: int = 16,
        norm: Callable[..., nn.Module] = ABN,
        n_tasks: int = 1,
        use_bg_detector: bool = False,
        atrous_encoder: bool = False,
        out_in_planes: int = 256,
        remat=False,
    ):
        super().__init__()
        make_backbone = create_resnet_atrous if atrous_encoder else create_resnet
        self.backbone = make_backbone(backbone_name, norm, output_stride, remat)
        self.base_classifier = DeepLabHead(
            self.backbone.out_channels, out_in_planes,
            out_stride=output_stride, norm=norm,
        )
        self.classifier_head = Conv2d(out_in_planes, num_classes, 1)
        self.use_bg_detector = use_bg_detector
        if use_bg_detector:
            self.seen_fg_network = BgDetector(self.backbone.out_channels, n_tasks)

    def _head(self, x: torch.Tensor):
        backbone_out, attentions = self.backbone(x.permute(0, 3, 1, 2))
        feats = self.base_classifier(backbone_out)
        return backbone_out, attentions + [feats], self.classifier_head(feats)

    def sem_logits(self, x: torch.Tensor) -> torch.Tensor:
        """Pre-upsample logits [N, h, w, C] of an NHWC image batch."""
        return self._head(x)[2].permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, key: Optional[rng.Key] = None) -> NetOutput:
        """``key`` (JAX's dropout key of the apply) draws the detector's
        dropout mask in training."""
        backbone_out, attentions, sem = self._head(x)
        penultimate = backbone_out
        if self.use_bg_detector:
            penultimate = self.seen_fg_network.trunk(backbone_out, key)
        nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
        return NetOutput(
            sem_logits=nhwc(sem),
            penultimate=nhwc(penultimate),
            attentions=tuple(nhwc(a) for a in attentions),
            out_hw=tuple(x.shape[1:3]),
        )

    # --- BgDetector passthroughs, NHWC penultimate features ---

    def seen_map_task(self, penultimate, prototypes, task_num: int,
                      stop_grads: bool) -> torch.Tensor:
        """Seen-logit map against one task's prototype (detector training)."""
        return self.seen_fg_network.seen_map_task(penultimate, prototypes, task_num,
                                                  stop_grads)

    def seen_probs(self, penultimate, prototypes, n_tasks: int) -> torch.Tensor:
        """Sigmoid seen-probabilities against the first n_tasks prototypes."""
        return self.seen_fg_network.seen_probs(penultimate, prototypes, n_tasks)

    # the statistics that drift twice per buffer-population batch in the
    # reference (``bacs_tpu/models/deeplab.py:168-179``): the backbone's
    penultimate_stats_keys = ("backbone",)
