"""Visualisation and observability callbacks (port of ``bacs_tpu/viz/``)."""

from bacs_tpu_torch.viz.media import MediaLogger, voc_colormap  # noqa: F401
from bacs_tpu_torch.viz.drift import DriftProbe  # noqa: F401
from bacs_tpu_torch.viz.prototypes_viz import PrototypeLogger  # noqa: F401
