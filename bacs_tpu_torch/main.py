"""The port's command line: train a continual protocol from a ``conf/`` tree.

    python -m bacs_tpu_torch.main --config-path conf/bacs \
        --config-name bacs_plus_config training=der_15_1_bg loss=bacs_plus_bg \
        +network.fused_stem=true [overrides]

The same config trees and override grammar as ``main.py`` (group swaps,
``a.b=v``, ``+a.b=v``, ``~a.b``; ``config/core.py``), the same metric keys
on stdout, and the final mIoU printed and returned.  It trains on the card
(``--device cuda``, the default; it raises where torch sees none) unless
asked for the CPU with ``--device cpu``.  ``training.n_devices`` (or the
reference's ``n_gpus``) above 1 trains data-parallel: one spawned rank per
card (NCCL; fewer cards than asked warns and uses those there are), or
with ``--device cpu`` that many gloo ranks (``parallel/``); rank 0 prints.
``main.py``'s compilation cache is XLA's and has no counterpart here.
"""

from __future__ import annotations

import argparse
import os
import sys


def parse_args(argv):
    parser = argparse.ArgumentParser(description="BACS trainer (PyTorch)")
    parser.add_argument("--config-path", default="conf/joint_debug")
    parser.add_argument("--config-name", default="config")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; cuda raises without a card")
    parser.add_argument("overrides", nargs="*", help="key=value overrides")
    return parser.parse_args(argv)


def _train_rank(group, device, config) -> float:
    from bacs_tpu_torch.train.loop import Trainer

    return Trainer(config, device=device, group=group).fit()


def train(config, device: str = "cuda") -> float:
    """Train ``config`` on ``device``; the final mIoU (rank 0's)."""
    import torch.distributed as dist

    from bacs_tpu_torch import parallel
    from bacs_tpu_torch.train.loop import Trainer, available_devices, requested_devices

    n = min(requested_devices(config), available_devices(device))
    if n > 1 and not dist.is_initialized() and "WORLD_SIZE" not in os.environ:
        return parallel.spawn(_train_rank, n, (config,), device=device)[0]
    return Trainer(config, device=device).fit()


def main(argv=None) -> float:
    args = parse_args(argv if argv is not None else sys.argv[1:])
    from bacs_tpu_torch.config import load_config

    config = load_config(args.config_path, args.config_name, args.overrides)
    miou = train(config, args.device)
    print(f"final mIoU: {miou:.4f}")
    return miou


if __name__ == "__main__":
    main()
