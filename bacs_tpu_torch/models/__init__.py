"""Network zoo of the port: DeepLabV3 on an ABN ResNet, with the BACS
background detector.

``create_network`` mirrors the JAX package's registry
(``bacs_tpu/models/__init__.py``).  UNet and TranSeg are ROADMAP.md queue 1
item 12 and raise until they land.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from bacs_tpu_torch.models.base import NetOutput  # noqa: F401
from bacs_tpu_torch.models.bg_detector import BgDetector  # noqa: F401
from bacs_tpu_torch.models.deeplab import DeepLabHead, DeepLabV3  # noqa: F401
from bacs_tpu_torch.models.norm import ABN, make_norm  # noqa: F401
from bacs_tpu_torch.models.resnet import Conv2d, ResNet, create_resnet  # noqa: F401


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
    (``models/resnet.py:Conv2d``), its gradients arriving back in f32.  ABN
    parameters and statistics stay float32, and the ABN functions compute
    in f32 on activations of the convolutions' dtype.  Weights are in
    channels_last memory.  ``n_tasks`` is the background detector's head
    count with ``use_bg_detector``.  ``kwargs`` takes the network config's
    ``backbone``, ``output_stride`` and ``atrous_encoder``.
    """
    short = name.rsplit(".", 1)[-1].lower()
    if short not in ("deeplabv3", "deeplab", "deep_lab"):
        raise NotImplementedError(
            f"network {name!r} is ROADMAP.md queue 1 item 12; only DeepLabV3 "
            "is ported"
        )
    model = DeepLabV3(
        num_classes=num_classes,
        backbone_name=kwargs.get("backbone", "resnet101"),
        output_stride=kwargs.get("output_stride", 16),
        norm=make_norm(norm),
        n_tasks=n_tasks,
        use_bg_detector=use_bg_detector,
        atrous_encoder=bool(kwargs.get("atrous_encoder")),
    )
    for m in model.modules():
        if isinstance(m, Conv2d):
            m.compute_dtype = dtype
            m.to(dtype=param_dtype or dtype, memory_format=torch.channels_last)
    return model
