"""TranSeg: an ABN ResNet backbone and a transformer mask decoder with class
tokens.

Port of ``bacs_tpu/models/transeg.py`` (``TransformerHead``, ``TranSeg``):
backbone -> 1 x 1 feature embedding -> + a learned 2-D positional embedding
-> the class tokens appended after the patches -> decoder blocks
(``models/layers.py``) -> LayerNorm -> L2-normalised patch . class products
-> a LayerNorm over the classes (``mask_norm``).

The class tokens and ``mask_norm``'s parameters are allocated at the final
class count.  ``active_classes`` (a static field of the Flax module, which
the JAX Trainer rebuilds per task) is an attribute here, which the Trainer
sets at every task, on the previous model too: only the first
``active_classes`` tokens join the sequence, and the inactive channels of
``sem_logits`` are filled with ``NEG_INF``, so every network emits
full-width logits.  The token growth at a task boundary is
``train/learner.py:transformer_init``.

Public methods take and return NHWC tensors, as ``models/deeplab.py``
does: ``forward(x, generator) -> NetOutput``, ``sem_logits(x)`` (the
Predictor's), ``seen_map_task`` and ``seen_probs``.  The attentions are the
backbone's stage maps and then ``image_feats``, the decoder's patch tokens
[B, h, w, D], which BACS distils.  The head computes in float32 after its
bf16 feature embedding (the f32 ``pos_embed`` promotes the residual
stream), so ``sem_logits`` are float32 under mixed precision, as in JAX.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from bacs_tpu_torch.models.base import NetOutput
from bacs_tpu_torch.models.bg_detector import BgDetector
from bacs_tpu_torch.models.layers import Block
from bacs_tpu_torch.models.norm import ABN
from bacs_tpu_torch.models.resnet import Conv2d, create_resnet

NEG_INF = -1e9  # the fill of inactive class channels


class TransformerHead(nn.Module):
    """(reference: networks/transeg.py:85-175)"""

    def __init__(
        self,
        in_channels: int,
        crop_size: int,
        num_classes: int,
        active_classes: Optional[int] = None,
        hidden_dim: int = 256,
        nhead: int = 2,
        num_decoder_layers: int = 2,
        dim_feedforward: int = 2048,
    ):
        super().__init__()
        d, patches = hidden_dim, crop_size // 16
        self.num_classes = num_classes
        self.active_classes = active_classes or num_classes
        self.num_decoder_layers = num_decoder_layers
        self.feature_embedding = Conv2d(in_channels, d, 1)
        # initial values as Flax draws them (train/loop.py:init_weights
        # redraws them from the run's seed)
        self.pos_embed = nn.Parameter(torch.randn(1, patches, patches, d))
        self.class_tokens = nn.Parameter(
            nn.init.trunc_normal_(torch.empty(num_classes, d), std=0.02, a=-0.04, b=0.04))
        for i in range(num_decoder_layers):
            self.add_module(f"block{i}", Block(d, nhead, dim_feedforward))
        self.decoder_norm = nn.LayerNorm(d, eps=1e-5)
        self.proj_patch = nn.Parameter(torch.randn(d, d) * d ** -0.5)
        self.proj_classes = nn.Parameter(torch.randn(d, d) * d ** -0.5)
        self.mask_norm_scale = nn.Parameter(torch.ones(num_classes))
        self.mask_norm_bias = nn.Parameter(torch.zeros(num_classes))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """[B, C, h, w] backbone features -> (masks [B, h, w, active] f32,
        image_feats [B, h, w, D] f32)."""
        n_cls = self.active_classes
        x = self.feature_embedding(x).permute(0, 2, 3, 1)  # NHWC
        b, h, w, d = x.shape
        x = (x + self.pos_embed[:, :h, :w]).reshape(b, h * w, d)
        tokens = self.class_tokens[:n_cls].expand(b, n_cls, d).to(x.dtype)
        x = torch.cat([x, tokens], dim=1)
        for i in range(self.num_decoder_layers):
            x = getattr(self, f"block{i}")(x, generator)
        x = self.decoder_norm(x.float())
        patch_tokens, cls_feat = x[:, :-n_cls], x[:, -n_cls:]
        image_feats = patch_tokens.reshape(b, h, w, d)
        p = patch_tokens @ self.proj_patch
        c = cls_feat @ self.proj_classes
        # p / (|p| + 1e-8) (transeg.py:88-89), not F.normalize's clamp
        p = p / (torch.linalg.vector_norm(p, dim=-1, keepdim=True) + 1e-8)
        c = c / (torch.linalg.vector_norm(c, dim=-1, keepdim=True) + 1e-8)
        masks = torch.einsum("bnd,bmd->bnm", p, c)  # [b, hw, n_cls]
        # LayerNorm over the active classes on the full-size parameters
        mu = masks.mean(dim=-1, keepdim=True)
        var = masks.var(dim=-1, keepdim=True, unbiased=False)
        masks = (masks - mu) * torch.rsqrt(var + 1e-5)
        masks = masks * self.mask_norm_scale[:n_cls] + self.mask_norm_bias[:n_cls]
        return masks.reshape(b, h, w, n_cls), image_feats


class TranSeg(nn.Module):
    """TranSeg with an ABN ResNet backbone; returns the NetOutput contract."""

    def __init__(
        self,
        num_classes: int,
        crop_size: int = 512,
        active_classes: Optional[int] = None,
        backbone_name: str = "resnet101",
        output_stride: int = 16,
        norm: Callable[..., nn.Module] = ABN,
        hidden_dim: int = 256,
        nhead: int = 2,
        num_decoder_layers: int = 2,
        dim_feedforward: int = 2048,
        n_tasks: int = 1,
        use_bg_detector: bool = False,
        remat=False,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = create_resnet(backbone_name, norm, output_stride, remat)
        self.base_classifier = TransformerHead(
            self.backbone.out_channels, crop_size, num_classes, active_classes,
            hidden_dim, nhead, num_decoder_layers, dim_feedforward)
        self.use_bg_detector = use_bg_detector
        if use_bg_detector:
            self.seen_fg_network = BgDetector(self.backbone.out_channels, n_tasks)

    @property
    def active_classes(self) -> int:
        return self.base_classifier.active_classes

    @active_classes.setter
    def active_classes(self, n: int) -> None:
        self.base_classifier.active_classes = int(n)

    def _run(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        backbone_out, attentions = self.backbone(x.permute(0, 3, 1, 2))
        masks, image_feats = self.base_classifier(backbone_out, generator)
        pad = self.num_classes - masks.shape[-1]
        if pad:
            masks = torch.cat([masks, masks.new_full(masks.shape[:3] + (pad,), NEG_INF)], -1)
        return backbone_out, attentions, image_feats, masks

    def sem_logits(self, x: torch.Tensor) -> torch.Tensor:
        """Pre-upsample logits [N, h, w, C] f32 of an NHWC image batch, the
        inactive channels ``NEG_INF``."""
        return self._run(x)[3]

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> NetOutput:
        """``generator`` draws the detector's dropout mask in training (and
        the head's stochastic depth, at rate 0 as shipped)."""
        backbone_out, attentions, image_feats, sem = self._run(x, generator)
        penultimate = backbone_out
        if self.use_bg_detector:
            penultimate = self.seen_fg_network.trunk(backbone_out, generator)
        nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
        return NetOutput(
            sem_logits=sem,
            penultimate=nhwc(penultimate),
            attentions=tuple(nhwc(a) for a in attentions) + (image_feats,),
            out_hw=tuple(x.shape[1:3]),
        )

    # --- BgDetector passthroughs, NHWC penultimate features ---

    def seen_map_task(self, penultimate, prototypes, task_num: int,
                      stop_grads: bool) -> torch.Tensor:
        return self.seen_fg_network.seen_map_task(penultimate, prototypes, task_num,
                                                  stop_grads)

    def seen_probs(self, penultimate, prototypes, n_tasks: int) -> torch.Tensor:
        return self.seen_fg_network.seen_probs(penultimate, prototypes, n_tasks)

    # the statistics that drift twice per buffer-population batch: the
    # backbone's (bacs_tpu/models/transeg.py:149-154)
    penultimate_stats_keys = ("backbone",)
