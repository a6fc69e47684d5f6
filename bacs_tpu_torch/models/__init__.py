"""Network zoo of the port: DeepLabV3 and TranSeg on an ABN ResNet or
(DeepLabV3) the SDR atrous ResNet, and UNet, each with the BACS background
detector.

``create_network`` mirrors the JAX package's registry
(``bacs_tpu/models/__init__.py``).
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from bacs_tpu_torch.models.base import NetOutput  # noqa: F401
from bacs_tpu_torch.models.bg_detector import BgDetector  # noqa: F401
from bacs_tpu_torch.models.deeplab import DeepLabHead, DeepLabV3  # noqa: F401
from bacs_tpu_torch.models.layers import Attention, Block, Linear  # noqa: F401
from bacs_tpu_torch.models.norm import ABN, BatchNorm, make_norm  # noqa: F401
from bacs_tpu_torch.models.resnet import Conv2d, ResNet, create_resnet  # noqa: F401
from bacs_tpu_torch.models.resnet_atrous import ResNetAtrous, create_resnet_atrous  # noqa: F401
from bacs_tpu_torch.models.transeg import TranSeg, TransformerHead  # noqa: F401
from bacs_tpu_torch.models.unet import ConvTranspose2d, UNet  # noqa: F401


def create_network(
    name: str,
    num_classes: int,
    n_tasks: int = 1,
    use_bg_detector: bool = False,
    active_classes: int | None = None,
    norm: str = "iabn_sync",
    crop_size: int = 512,
    dtype: torch.dtype = torch.float32,
    param_dtype: torch.dtype | None = None,
    **kwargs: Any,
) -> nn.Module:
    """Build a network from a reference-style target name, on the CPU.

    Convolutions compute in ``dtype``, as the Flax modules do with
    ``dtype=``, and hold their weights in ``param_dtype`` (default:
    ``dtype``).  The Predictor stores bf16 weights; training keeps f32
    master weights (``param_dtype=torch.float32``) and each convolution
    casts its input and weights to bf16 in its forward
    (``models/resnet.py:Conv2d``), its gradients arriving back in f32.  Norm
    parameters and statistics stay float32, and the norms compute in f32
    on activations of the convolutions' dtype.  Weights are in
    channels_last memory.  ``n_tasks`` is the background detector's head
    count with ``use_bg_detector``.  ``kwargs`` takes the network config's
    keys, as ``bacs_tpu/models/__init__.py:39-110``: for DeepLabV3 and
    TranSeg ``backbone``, ``output_stride``, the ABN gate ``fused_stem``
    (default false: the stem's fused ABN + max-pool, K12) and ``remat``
    (false, true or a list of 1-indexed ResNet stages whose blocks are
    recomputed in the backward); for DeepLabV3 ``atrous_encoder``; for
    TranSeg the ``transformer`` dict (``hidden_dim`` 256, ``nhead`` 2,
    ``num_decoder_layers`` 2, ``dim_feedforward`` 2048 by default), with
    ``crop_size`` (the positional embedding's extent) and
    ``active_classes`` (the class tokens in use; default all); for UNet
    ``n_channels``, ``bilinear`` and ``num_layers`` (default 5);
    ``fused_abn`` (default true; false trains every ABN through the
    non-fused branch).  The atrous encoder replaces ``norm`` by the
    synchronized ``bn`` of momentum 3e-4 on the whole model
    (``bacs_tpu/models/__init__.py:56-63``).
    """
    short = name.rsplit(".", 1)[-1].lower()
    atrous = bool(kwargs.get("atrous_encoder"))
    remat = kwargs.get("remat", False)
    remat = (tuple(int(s) for s in remat) if isinstance(remat, (list, tuple))
             else bool(remat))
    norm_kw = dict(fused_stem=bool(kwargs.get("fused_stem", False)),
                   fused=bool(kwargs.get("fused_abn", True)))
    abn = (make_norm("bn", sync=True, **norm_kw) if atrous
           else make_norm(norm, **norm_kw))
    if short in ("deeplabv3", "deeplab", "deep_lab"):
        model = DeepLabV3(
            num_classes=num_classes,
            backbone_name=kwargs.get("backbone", "resnet101"),
            output_stride=kwargs.get("output_stride", 16),
            norm=abn,
            n_tasks=n_tasks,
            use_bg_detector=use_bg_detector,
            atrous_encoder=atrous,
            remat=remat,
        )
    elif short == "unet":
        model = UNet(
            num_classes=num_classes,
            n_channels=int(kwargs.get("n_channels", 3)),
            bilinear=bool(kwargs.get("bilinear", True)),
            num_layers=int(kwargs.get("num_layers", 5)),
            n_tasks=n_tasks,
            use_bg_detector=use_bg_detector,
        )
    elif short in ("transeg", "deep_lab_transformer"):
        tr = kwargs.get("transformer") or {}
        model = TranSeg(
            num_classes=num_classes,
            crop_size=int(crop_size),
            active_classes=active_classes,
            backbone_name=kwargs.get("backbone", "resnet101"),
            output_stride=kwargs.get("output_stride", 16),
            norm=abn,
            hidden_dim=int(tr.get("hidden_dim", 256)),
            nhead=int(tr.get("nhead", 2)),
            num_decoder_layers=int(tr.get("num_decoder_layers", 2)),
            dim_feedforward=int(tr.get("dim_feedforward", 2048)),
            n_tasks=n_tasks,
            use_bg_detector=use_bg_detector,
            remat=remat,
        )
    else:
        raise ValueError(f"unknown network {name!r}")
    for m in model.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d, Linear)):
            m.compute_dtype = dtype
            m.to(dtype=param_dtype or dtype, memory_format=torch.channels_last)
    return model
