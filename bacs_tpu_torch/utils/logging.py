"""Metric logging to stdout.

Port of ``bacs_tpu/utils/logging.py``: the same lines, ``[<seconds>s]
<message>``, with metrics as one JSON object per call in the reference's
metric namespace.  Neither machine the port runs on has Weights & Biases,
so a config's ``wandb`` block is not read.  In a data-parallel run only
rank 0 logs (``enabled``).
"""

from __future__ import annotations

import json
import time
from typing import Dict


class Logger:
    def __init__(self, enabled: bool = True):
        self._t0 = time.time()
        self.enabled = enabled

    def info(self, msg: str):
        if not self.enabled:
            return
        dt = time.time() - self._t0
        print(f"[{dt:8.1f}s] {msg}", flush=True)

    def log_metrics(self, metrics: Dict[str, float]):
        compact = {
            k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in metrics.items()
            if "/IoU-" not in k or "/IoU-Old" in k or "/IoU-New" in k
        }
        self.info(json.dumps(compact))
