"""UNet, NCHW in channels_last memory.

Port of ``bacs_tpu/models/unet.py``: ``DoubleConv`` blocks (two 3x3
convolutions with bias, each followed by Flax's batch norm and ReLU), an
encoder of 2x2/2 max-pools, and a decoder that doubles the resolution by
a bilinear resize with aligned corners (``bilinear=True``) or a 2x2/2
transpose convolution (``up_tconv<i>``), then concatenates ``[skip, y]``
on channels.  Attention maps are the encoder outputs from the second
stage on; the penultimate output is the encoder bottom, or with
``use_bg_detector`` the detector trunk's over it, the detector upsampling
its seen maps by 2^(num_layers-1).  UNet predicts at the input's
resolution, so ``logits`` is ``sem_logits`` in float32, with no upsample.

Submodule names are the Flax module names (``inc``, ``down1``,
``up1.conv1``, ``up1.bn1``, ``up_tconv1``, ``classifier_head``,
``seen_fg_network``), so a Flax variable path is a state_dict key
(``utils/flax_weights.py``).  Convolutions compute in their
``compute_dtype`` (``models/resnet.py:Conv2d``), the norms in float32.
Public methods take and return NHWC tensors.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from bacs_tpu_torch.models.base import NetOutput
from bacs_tpu_torch.models.bg_detector import BgDetector
from bacs_tpu_torch.models.norm import BatchNorm
from bacs_tpu_torch.models.resnet import Conv2d
from bacs_tpu_torch.ops import rng
from bacs_tpu_torch.ops.interpolate import resize_bilinear


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` that computes in ``compute_dtype``, as
    :class:`~bacs_tpu_torch.models.resnet.Conv2d` does."""

    compute_dtype = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), bias, self.stride)


class DoubleConv(nn.Module):
    """(3x3 conv with bias -> batch norm -> ReLU) x 2; float32 out."""

    def __init__(self, in_channels: int, out_channels: int,
                 mid_channels: Optional[int] = None):
        super().__init__()
        mid = mid_channels or out_channels
        self.conv1 = Conv2d(in_channels, mid, 3, padding=1)
        self.bn1 = BatchNorm(mid)
        self.conv2 = Conv2d(mid, out_channels, 3, padding=1)
        self.bn2 = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(x)))


class UNet(nn.Module):
    """UNet of ``num_layers`` stages; returns the NetOutput contract."""

    def __init__(
        self,
        num_classes: int,
        n_channels: int = 3,
        bilinear: bool = True,
        num_layers: int = 5,
        n_tasks: int = 1,
        use_bg_detector: bool = False,
    ):
        super().__init__()
        self.bilinear = bool(bilinear)
        self.num_layers = int(num_layers)
        self.use_bg_detector = use_bg_detector
        self.inc = DoubleConv(n_channels, 64)
        widths = [64]  # the skips' channels
        feat = 64
        for i in range(self.num_layers - 1):
            is_last = i == self.num_layers - 2
            out_ch = feat if (is_last and self.bilinear) else feat * 2
            self.add_module(f"down{i + 1}", DoubleConv(widths[-1], out_ch))
            widths.append(out_ch)
            feat *= 2
        in_feat, y_ch = feat, widths[-1]
        for i in range(self.num_layers - 1):
            skip_ch = widths[-2 - i]
            last = i == self.num_layers - 2
            if self.bilinear:
                out_ch, mid = (32 if last else in_feat // 4), in_feat // 2
            else:
                self.add_module(f"up_tconv{i + 1}",
                                ConvTranspose2d(y_ch, y_ch // 2, 2, stride=2))
                y_ch //= 2
                out_ch, mid = (64 if last else in_feat // 2), None
            self.add_module(f"up{i + 1}", DoubleConv(skip_ch + y_ch, out_ch, mid))
            y_ch = out_ch
            in_feat //= 2
        self.classifier_head = Conv2d(y_ch, num_classes, 1)
        if use_bg_detector:
            # the encoder bottom sits at stride 2^(num_layers-1)
            self.seen_fg_network = BgDetector(
                self.encoder_output_dim, n_tasks,
                upscale=2 ** (self.num_layers - 1))

    @property
    def encoder_output_dim(self) -> int:
        feat = 64 * 2 ** (self.num_layers - 2)
        return feat if self.bilinear else feat * 2

    @property
    def penultimate_dim(self) -> int:
        if self.use_bg_detector:
            return self.encoder_output_dim // 4
        return self.encoder_output_dim

    @property
    def out_in_planes(self) -> int:
        return 32 if self.bilinear else 64

    @property
    def penultimate_stats_keys(self):
        """The statistics of the penultimate path, the encoder alone
        (``bacs_tpu/models/unet.py:69-76``): BACS's ``end_task`` lets them
        drift twice."""
        return ("inc",) + tuple(f"down{i + 1}" for i in range(self.num_layers - 1))

    def _run(self, x: torch.Tensor):
        skips: List[torch.Tensor] = [self.inc(x)]
        attentions = []
        for i in range(self.num_layers - 1):
            y = F.max_pool2d(skips[-1], 2, 2)
            y = getattr(self, f"down{i + 1}")(y)
            skips.append(y)
            if i > 0:
                attentions.append(y)
        bottom = y = skips[-1]
        for i in range(self.num_layers - 1):
            skip = skips[-2 - i]
            if self.bilinear:
                y = resize_bilinear(y.permute(0, 2, 3, 1), (y.shape[2] * 2, y.shape[3] * 2),
                                    align_corners=True).permute(0, 3, 1, 2)
            else:
                y = getattr(self, f"up_tconv{i + 1}")(y)
            y = torch.cat([skip.to(y.dtype), y], dim=1)
            y = getattr(self, f"up{i + 1}")(y)
        return bottom, attentions, self.classifier_head(y)

    def sem_logits(self, x: torch.Tensor) -> torch.Tensor:
        """Logits [N, H, W, C] of an NHWC image batch (the Predictor's)."""
        return self._run(x.permute(0, 3, 1, 2))[2].permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, key: Optional[rng.Key] = None) -> NetOutput:
        """``key`` (JAX's dropout key of the apply) draws the detector's
        dropout mask in training."""
        bottom, attentions, sem = self._run(x.permute(0, 3, 1, 2))
        penultimate = bottom
        if self.use_bg_detector:
            penultimate = self.seen_fg_network.trunk(bottom, key)
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
        return self.seen_fg_network.seen_map_task(penultimate, prototypes, task_num,
                                                  stop_grads)

    def seen_probs(self, penultimate, prototypes, n_tasks: int) -> torch.Tensor:
        return self.seen_fg_network.seen_probs(penultimate, prototypes, n_tasks)
