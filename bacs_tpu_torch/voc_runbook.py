"""Real-VOC runbook: validate every artifact, then print (or run) the
reference recipe's 15-1 BACS command on the port.

Port of ``scripts/voc_runbook.py``.  The path from raw artifacts to a
continual run has four stages, each validated on its own, so a broken setup
fails at the *first* bad artifact with an actionable message, not 20
minutes into training:

  1. data      VOC2012 tree + SegmentationClassAug masks + train_aug.txt
               (the layout the reference's downloader produces,
               reference: dataset/voc.py:92-113)
  2. backbone  pretrained ResNet-101 checkpoint in the PLOP iabn_sync
               release format — {"state_dict": {"module.<k>": tensor}} with
               classifier.fc.* entries to drop
               (reference: networks/resnet.py:432-488 create_resnet)
  3. convert   load the checkpoint into the port's DeepLabV3 ``nn.Module``
               and count the converted tensors (``utils/torch_weights.py``)
  4. train     the 15-1 overlap BACS command on the port's command line
               (reference recipe: conf/bacs/training/der_15_1.yaml — batch
               12, 30 epochs/task, SGD nesterov lr .01 → lr_next 1e-3, poly
               0.9, crop 512)

Usage:
    python -m bacs_tpu_torch.voc_runbook --root ~/data/voc \
        --backbone-ckpt ~/data/resnet101_iabn_sync.pth.tar
    python -m bacs_tpu_torch.voc_runbook --root ~/data/voc --stage data
    python -m bacs_tpu_torch.voc_runbook ... --smoke  # a 6-sample debug fit on the card

Exit code 0 = every requested stage passed.  The folder tree decodes through
the native batch decoder where it builds (``data/native_decode.py``).
"""

from __future__ import annotations

import argparse
import os
import sys

# Published sizes of the real artifacts (informational: synthetic layouts
# from ``python -m bacs_tpu_torch.data.layouts voc`` pass validation with a
# size warning).
REAL_TRAIN_AUG = 10582
REAL_VAL = 1449


class StageError(RuntimeError):
    pass


def _ok(msg: str) -> None:
    print(f"  [ok] {msg}")


def _warn(msg: str) -> None:
    print(f"  [warn] {msg}")


def check_data(root: str) -> dict:
    """Stage 1: the on-disk VOC tree (reference: dataset/voc.py:92-147)."""
    root = os.path.expanduser(root)
    voc = os.path.join(root, "VOCdevkit", "VOC2012")
    if not os.path.isdir(voc):
        raise StageError(
            f"{voc} not found. Download VOCtrainval_11-May-2012.tar and "
            "extract under the root, e.g.\n"
            "    tar -xf VOCtrainval_11-May-2012.tar -C <root>\n"
            "or run: python -c \"from bacs_tpu_torch.data.download import "
            "download_voc; download_voc('<root>')\" (needs egress)"
        )
    jpeg = os.path.join(voc, "JPEGImages")
    if not os.path.isdir(jpeg):
        raise StageError(f"{jpeg} missing from the extracted tarball")
    aug_masks = os.path.join(voc, "SegmentationClassAug")
    if not os.path.isdir(aug_masks):
        raise StageError(
            f"{aug_masks} not found. The 15-1 protocol trains on the "
            "augmented (SBD) masks: download SegmentationClassAug.zip "
            "(the reference fetches it from dropbox, dataset/voc.py:96-99) "
            "and unzip it into the VOC2012 directory"
        )
    # train_aug.txt may live at either location (reference drops it at the
    # voc root, dataset/voc.py:100-105; some mirrors ship it in ImageSets)
    lists = [
        os.path.join(voc, "ImageSets", "Segmentation", "train_aug.txt"),
        os.path.join(voc, "train_aug.txt"),
    ]
    list_file = next((p for p in lists if os.path.exists(p)), None)
    if list_file is None:
        raise StageError(
            f"train_aug.txt not found at either of {lists}. Download "
            "train_aug.txt (reference: dataset/voc.py:100-105) next to the "
            "SegmentationClassAug masks"
        )
    val_file = os.path.join(voc, "ImageSets", "Segmentation", "val.txt")
    if not os.path.exists(val_file):
        raise StageError(f"{val_file} missing from the extracted tarball")

    def _names(path):
        with open(path) as f:
            return [
                os.path.splitext(os.path.basename(l.split()[0]))[0]
                for l in f if l.strip()
            ]

    train_names = _names(list_file)
    val_names = _names(val_file)
    missing = [
        n for n in train_names[:50] + train_names[-50:]
        if not os.path.exists(os.path.join(jpeg, n + ".jpg"))
        or not os.path.exists(os.path.join(aug_masks, n + ".png"))
    ]
    if missing:
        raise StageError(
            f"{len(missing)} of 100 sampled train_aug entries missing a "
            f".jpg/.png pair, e.g. {missing[:3]}"
        )
    _ok(f"layout complete: {len(train_names)} train_aug / "
        f"{len(val_names)} val entries")
    if len(train_names) != REAL_TRAIN_AUG or len(val_names) != REAL_VAL:
        _warn(
            f"sizes differ from the published VOC-aug "
            f"({REAL_TRAIN_AUG}/{REAL_VAL}) — fine for a synthetic layout, "
            "wrong for a real reproduction"
        )
    # decode + label-range spot check through the real source class
    import numpy as np

    from bacs_tpu_torch.data.datasets import make_voc_source

    src = make_voc_source(root, "train", 512)
    for i in (0, len(src) // 2, len(src) - 1):
        img, lbl = src.load(i)
        u = np.unique(lbl)
        bad = u[(u > 20) & (u != 255)]
        if bad.size:
            raise StageError(
                f"mask {src.label_paths[i]} has labels {bad.tolist()} "
                "outside [0,20]+255 — masks are not VOC-indexed (did the "
                "palette get flattened to RGB?)"
            )
    _ok("decode + label-range spot check passed (3 samples)")
    return {"train": len(train_names), "val": len(val_names)}


def check_backbone(ckpt: str) -> dict:
    """Stage 2: the PLOP iabn_sync checkpoint format
    (reference: networks/resnet.py:432-488)."""
    ckpt = os.path.expanduser(ckpt)
    if not os.path.isfile(ckpt):
        raise StageError(
            f"{ckpt} not found. Download the PLOP release backbone:\n"
            "    curl -L -o resnet101_iabn_sync.pth.tar https://github.com/"
            "arthurdouillard/CVPR2021_PLOP/releases/download/v1.0/"
            "resnet101_iabn_sync.pth.tar"
        )
    import torch

    raw = torch.load(ckpt, map_location="cpu", weights_only=False)
    if not (isinstance(raw, dict) and isinstance(raw.get("state_dict"), dict)):
        raise StageError(
            "checkpoint is not {'state_dict': ...} — not the PLOP "
            "iabn_sync release format (a plain torchvision .pth needs "
            "norm=bn, not iabn_sync)"
        )
    sd = raw["state_dict"]
    n_module = sum(k.startswith("module.") for k in sd)
    if n_module < len(sd) // 2:
        _warn(f"only {n_module}/{len(sd)} keys carry the DataParallel "
              "'module.' prefix (the real release prefixes all)")
    fc = [k for k in sd if "classifier.fc" in k]
    stems = [k for k in sd if k.replace("module.", "").startswith("mod1.")]
    if not stems:
        raise StageError(
            "no mod1.* keys — not the inplace_abn ResNet naming scheme "
            "(mod1..mod5; reference: networks/resnet.py:305-420)"
        )
    _ok(f"{len(sd)} tensors, {len(fc)} classifier.fc entries to drop, "
        "inplace_abn naming confirmed")
    return {"n_tensors": len(sd), "n_fc": len(fc)}


def check_convert(ckpt: str, backbone: str = "resnet101") -> dict:
    """Stage 3: conversion coverage into the port's DeepLabV3."""
    from bacs_tpu_torch.models import create_network
    from bacs_tpu_torch.utils.torch_weights import load_backbone_into, model_variables

    net = create_network("deeplab", num_classes=21, n_tasks=1, backbone=backbone,
                         norm="iabn_sync")
    variables = model_variables(net)
    n_bb = sum(_count_leaves(variables[k].get("backbone", {}))
               for k in ("params", "batch_stats"))
    n = load_backbone_into(net, os.path.expanduser(ckpt))
    if n < int(0.9 * n_bb):
        raise StageError(
            f"only {n}/{n_bb} backbone tensors converted — checkpoint "
            f"does not match a {backbone} (wrong arch or corrupted file)"
        )
    _ok(f"converted {n}/{n_bb} backbone tensors into the port's "
        f"DeepLabV3-{backbone}")
    return {"converted": n, "expected": n_bb}


def _count_leaves(tree) -> int:
    return sum(_count_leaves(v) if isinstance(v, dict) else 1 for v in tree.values())


def train_command(root: str, ckpt: str | None, smoke: bool) -> list:
    cmd = [
        sys.executable, "-m", "bacs_tpu_torch.main",
        "--config-path", "conf/bacs", "--config-name", "bacs_plus_config",
        f"dataset.dataset.root={root}",
        "training.mode=overlap",
        "+training.n_devices=1",
    ]
    if ckpt:
        cmd.append(f"+network.backbone_weights_path={ckpt}")
    if smoke:
        # `+`: conf/bacs's training group has no `debug` key, and the JAX
        # runbook's `training.debug=true` is refused by its config loader
        cmd += ["+training.debug=true", "training.epochs=1"]
    return cmd


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    ap.add_argument("--root", default="~/data/voc")
    ap.add_argument("--backbone-ckpt", default=None,
                    help="resnet101_iabn_sync.pth.tar path (PLOP release)")
    ap.add_argument("--backbone", default="resnet101")
    ap.add_argument("--stage", default="all",
                    choices=("all", "data", "backbone", "convert"))
    ap.add_argument("--smoke", action="store_true",
                    help="actually run the 6-sample debug fit (on the card) at the end")
    args = ap.parse_args(argv)

    try:
        if args.stage in ("all", "data"):
            print("[1/4] data")
            check_data(args.root)
        if args.backbone_ckpt and args.stage in ("all", "backbone"):
            print("[2/4] backbone checkpoint")
            check_backbone(args.backbone_ckpt)
        if args.backbone_ckpt and args.stage in ("all", "convert"):
            print("[3/4] release file → port conversion")
            check_convert(args.backbone_ckpt, args.backbone)
        if args.stage != "all":
            return 0
        print("[4/4] train command")
        cmd = train_command(args.root, args.backbone_ckpt, args.smoke)
        print("  " + " ".join(cmd))
        if args.smoke:
            import subprocess

            # from the checkout's root, where conf/ lies
            return subprocess.call(cmd, cwd=os.path.dirname(
                os.path.dirname(os.path.abspath(__file__))))
        print("(pass --smoke to execute a 6-sample debug fit now)")
        return 0
    except StageError as e:
        print(f"  [FAIL] {e}")
        return 1


if __name__ == "__main__":
    sys.exit(main())
