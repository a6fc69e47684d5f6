"""Metric logging to stdout.

Port of ``bacs_tpu/utils/logging.py``: the same lines, ``[<seconds>s]
<message>``, with metrics as one JSON object per call in the reference's
metric namespace.  Neither machine the port runs on has Weights & Biases,
so a config's ``wandb`` block is not read; one process logs (multi-GPU
runs are ROADMAP.md queue 1 item 10).
"""

from __future__ import annotations

import json
import time
from typing import Dict


class Logger:
    def __init__(self):
        self._t0 = time.time()

    def info(self, msg: str):
        dt = time.time() - self._t0
        print(f"[{dt:8.1f}s] {msg}", flush=True)

    def log_metrics(self, metrics: Dict[str, float]):
        compact = {
            k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in metrics.items()
            if "/IoU-" not in k or "/IoU-Old" in k or "/IoU-New" in k
        }
        self.info(json.dumps(compact))
