"""Network zoo of the port: DeepLabV3 on an ABN ResNet and UNet, each with
the BACS background detector.

``create_network`` mirrors the JAX package's registry
(``bacs_tpu/models/__init__.py``).  TranSeg is ROADMAP.md queue 1 item 12
and raises until it lands.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from bacs_tpu_torch.models.base import NetOutput  # noqa: F401
from bacs_tpu_torch.models.bg_detector import BgDetector  # noqa: F401
from bacs_tpu_torch.models.deeplab import DeepLabHead, DeepLabV3  # noqa: F401
from bacs_tpu_torch.models.norm import ABN, BatchNorm, make_norm  # noqa: F401
from bacs_tpu_torch.models.resnet import Conv2d, ResNet, create_resnet  # noqa: F401
from bacs_tpu_torch.models.unet import ConvTranspose2d, UNet  # noqa: F401


def create_network(
    name: str,
    num_classes: int,
    n_tasks: int = 1,
    use_bg_detector: bool = False,
    norm: str = "iabn_sync",
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
    keys, as ``bacs_tpu/models/__init__.py:39-90``: for DeepLabV3
    ``backbone``, ``output_stride``, ``atrous_encoder``, the ABN gate
    ``fused_stem`` (default false: the stem's fused ABN + max-pool, K12)
    and ``remat`` (false, true or a list of 1-indexed ResNet stages whose
    blocks are recomputed in the backward); for UNet ``n_channels``,
    ``bilinear`` and ``num_layers`` (default 5).  ``fused_abn=false`` (the
    non-fused train ABN) is ROADMAP.md queue 1 item 2 and raises.
    """
    short = name.rsplit(".", 1)[-1].lower()
    if not kwargs.get("fused_abn", True):
        raise NotImplementedError(
            "network.fused_abn=false (the non-fused train-mode ABN) is "
            "ROADMAP.md queue 1 item 2; only the fused ABN is ported"
        )
    remat = kwargs.get("remat", False)
    remat = (tuple(int(s) for s in remat) if isinstance(remat, (list, tuple))
             else bool(remat))
    if short in ("deeplabv3", "deeplab", "deep_lab"):
        model = DeepLabV3(
            num_classes=num_classes,
            backbone_name=kwargs.get("backbone", "resnet101"),
            output_stride=kwargs.get("output_stride", 16),
            norm=make_norm(norm, fused_stem=bool(kwargs.get("fused_stem", False))),
            n_tasks=n_tasks,
            use_bg_detector=use_bg_detector,
            atrous_encoder=bool(kwargs.get("atrous_encoder")),
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
    else:
        raise NotImplementedError(
            f"network {name!r} is ROADMAP.md queue 1 item 12; DeepLabV3 and "
            "UNet are ported"
        )
    for m in model.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d)):
            m.compute_dtype = dtype
            m.to(dtype=param_dtype or dtype, memory_format=torch.channels_last)
    return model
