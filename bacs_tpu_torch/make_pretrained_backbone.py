"""Produce a warm-start backbone in the reference's release format.

Port of ``scripts/make_pretrained_backbone.py``.  The reference always
trains from an ImageNet-pretrained ``iabn_sync`` checkpoint (reference:
networks/resnet.py:432-488, deeplab_v3.py:36-49); the analogue without
egress is a JOINT pre-run on the rich synthetic distribution at a DIFFERENT
seed (different images, same visual world: the transfer setting ImageNet
plays for VOC), whose backbone is exported in the exact
``resnet101_iabn_sync.pth.tar`` release layout, so the warm start runs the
whole pretrained path: release file -> ``load_backbone_into`` -> the network.

    python -m bacs_tpu_torch.make_pretrained_backbone \\
        --out build/backbones/rn50_rich.pth.tar --epochs 8

It trains on the card unless asked for the CPU (``--device cpu``), and
prints one JSON line (``out``, ``backbone``, ``joint_miou``, ``n_tensors``,
``seconds``).  Then train from it (any entry point):

    python -m bacs_tpu_torch.protocol_compare --protocol 15-1-flagship \\
        --methods ce,bacs_plus \\
        --override +network.backbone_weights_path=build/backbones/rn50_rich.pth.tar
"""

from __future__ import annotations

import argparse
import json
import os
import time


def parse_args(argv):
    ap = argparse.ArgumentParser(description="joint pre-run -> release backbone")
    ap.add_argument("--out", required=True)
    ap.add_argument("--backbone", default="resnet50")
    ap.add_argument("--crop", type=int, default=256)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--n-train", type=int, default=1536)
    ap.add_argument("--n-classes", type=int, default=21)
    ap.add_argument("--seed", type=int, default=7,
                    help="MUST differ from the protocol seed (42): the "
                         "pre-run sees different images")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda raises without a card")
    return ap.parse_args(argv)


def overrides(args) -> list:
    """The pre-run's overrides of ``conf/joint_debug``."""
    return [
        "network=deep_lab",
        f"network.backbone={args.backbone}",
        f"dataset.dataset.num_classes={args.n_classes}",
        f"dataset.dataset.crop_size={args.crop}",
        f"dataset.dataset.n_train={args.n_train}",
        f"dataset.dataset.n_val={max(64, args.n_train // 8)}",
        "+dataset.dataset.style=rich",
        "+dataset.dataset.cache_decoded=device",
        f"training.epochs={args.epochs}",
        f"training.batch_size={args.batch}",
        f"training.seed={args.seed}",
        "training.debug=false",
        "optimizer.lr=0.03",
    ]


def main(argv=None) -> dict:
    args = parse_args(argv)
    from bacs_tpu_torch.config import load_config
    from bacs_tpu_torch.train.loop import Trainer
    from bacs_tpu_torch.utils.torch_weights import export_backbone_release, model_variables

    config = load_config("conf/joint_debug", "config", overrides(args))
    t0 = time.time()
    trainer = Trainer(config, device=args.device)
    miou = trainer.fit()
    trainer.datamodule.close()
    out = os.path.expanduser(args.out)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    n = export_backbone_release(model_variables(trainer.state.model), out)
    result = dict(out=args.out, backbone=args.backbone, joint_miou=round(float(miou), 4),
                  n_tensors=n, seconds=round(time.time() - t0, 1))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
