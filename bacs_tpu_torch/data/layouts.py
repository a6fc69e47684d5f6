"""Write a synthetic dataset in the real VOC, ADE20K or Cityscapes layout.

The port's counterpart of ``scripts/gen_voc_layout.py``,
``scripts/gen_ade_layout.py`` and ``scripts/gen_cityscapes_layout.py``:
the same trees, arguments and seeds, from the port's ``SyntheticSource``
(bit-equal to the JAX package's), so the files are byte for byte the
scripts' (``tests/test_torch_folder_sources.py``) and a machine without
JAX can write them.  The folder sources and the shipped conf trees then
read them as they read the real sets.

- ``voc``: ``VOCdevkit/VOC2012/{JPEGImages, SegmentationClass,
  SegmentationClassAug, ImageSets/Segmentation}``: JPEGs (quality 92) of
  varied sizes, palette PNG masks, ``train_aug.txt``, ``train.txt``,
  ``val.txt`` (reference: dataset/voc.py:92-147).
- ``ade``: ``ADEChallengeData2016/{images, annotations}/{training,
  validation}``: JPEGs and single-channel label PNGs, 151 classes.
- ``cityscapes``: ``leftImg8bit/<split>/<city>/<city>_<i>_000019_
  leftImg8bit.png`` and ``gtFine/.../..._gtFine_labelIds.png`` with the raw
  Cityscapes ids (the loader's id -> train id remap is exercised), one
  source seed per city.

    python -m bacs_tpu_torch.data.layouts voc --root DIR [--n-train 64]
        [--n-val 16] [--size 320] [--num-classes 21] [--seed 0]
    python -m bacs_tpu_torch.data.layouts ade --root DIR [--n-train 32]
        [--n-val 8] [--size 96] [--num-classes 151] [--seed 0]
    python -m bacs_tpu_torch.data.layouts cityscapes --root DIR [--cities 3]
        [--per-city 8] [--val-cities 1] [--val-per-city 4] [--size 128]
        [--seed 0]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from bacs_tpu_torch.data.datasets import CITYSCAPES_ID_TO_TRAINID, SyntheticSource
from bacs_tpu_torch.viz.media import voc_colormap

TRAIN_CITIES = ("aachen", "bochum", "cologne", "dusseldorf", "erfurt",
                "hamburg", "hanover", "jena")
VAL_CITIES = ("frankfurt", "lindau", "munster")


def generate_voc(root: str, n_train: int = 64, n_val: int = 16, size: int = 320,
                 num_classes: int = 21, seed: int = 0, vary_sizes: bool = True) -> str:
    """Write the VOC layout under ``root``; returns the VOC2012 directory."""
    from PIL import Image

    voc = os.path.join(os.path.expanduser(root), "VOCdevkit", "VOC2012")
    jpeg = os.path.join(voc, "JPEGImages")
    seg = os.path.join(voc, "SegmentationClass")
    seg_aug = os.path.join(voc, "SegmentationClassAug")
    sets = os.path.join(voc, "ImageSets", "Segmentation")
    for d in (jpeg, seg, seg_aug, sets):
        os.makedirs(d, exist_ok=True)

    pal = voc_colormap().flatten().tolist()
    rng = np.random.RandomState(seed)
    src_train = SyntheticSource(n_train, size, num_classes, seed=seed + 1)
    src_val = SyntheticSource(n_val, size, num_classes, seed=seed + 2)

    def write(src, i, name, mask_dirs):
        img, lbl = src.load(i)
        if vary_sizes:
            # real VOC images vary (~500x375): the decode's aspect-preserving
            # resize and centre crop are exercised
            w = int(rng.randint(size, int(size * 1.6)))
            h = int(rng.randint(size, int(size * 1.6)))
            im = Image.fromarray(img).resize((w, h), Image.BILINEAR)
            lb = Image.fromarray(lbl).resize((w, h), Image.NEAREST)
        else:
            im, lb = Image.fromarray(img), Image.fromarray(lbl)
        im.save(os.path.join(jpeg, f"{name}.jpg"), quality=92)
        lb = lb.convert("P")
        lb.putpalette(pal)
        for d in mask_dirs:
            lb.save(os.path.join(d, f"{name}.png"))
        return name

    train_names = [write(src_train, i, f"synth_tr_{i:05d}", [seg_aug])
                   for i in range(n_train)]
    val_names = [write(src_val, i, f"synth_va_{i:05d}", [seg, seg_aug])
                 for i in range(n_val)]
    for name, names in (("train_aug.txt", train_names), ("val.txt", val_names),
                        ("train.txt", train_names)):
        with open(os.path.join(sets, name), "w") as f:
            f.write("\n".join(names) + "\n")
    return voc


def generate_ade(root: str, n_train: int = 32, n_val: int = 8, size: int = 96,
                 num_classes: int = 151, seed: int = 0) -> str:
    """Write the ADE20K layout under ``root``; returns the
    ADEChallengeData2016 directory."""
    from PIL import Image

    base = os.path.join(os.path.expanduser(root), "ADEChallengeData2016")

    def write_split(sub, n, seed_off):
        img_dir = os.path.join(base, "images", sub)
        ann_dir = os.path.join(base, "annotations", sub)
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(ann_dir, exist_ok=True)
        src = SyntheticSource(n, size, num_classes, seed=seed + seed_off)
        for i in range(n):
            img, lbl = src.load(i)
            stem = f"ADE_{sub[:5]}_{i:08d}"
            Image.fromarray(img).save(os.path.join(img_dir, f"{stem}.jpg"), quality=92)
            Image.fromarray(lbl).save(os.path.join(ann_dir, f"{stem}.png"))

    write_split("training", n_train, seed_off=1)
    write_split("validation", n_val, seed_off=2)
    return base


def generate_cityscapes(root: str, cities: int = 3, per_city: int = 8,
                        val_cities: int = 1, val_per_city: int = 4, size: int = 128,
                        seed: int = 0) -> str:
    """Write the Cityscapes layout under ``root``; returns ``root``."""
    from PIL import Image

    if cities > len(TRAIN_CITIES) or val_cities > len(VAL_CITIES):
        raise ValueError(
            f"at most {len(TRAIN_CITIES)} train / {len(VAL_CITIES)} val "
            f"cities available, got {cities}/{val_cities}")
    root = os.path.expanduser(root)
    # the loader's id -> train id map inverted, so the PNGs carry raw ids;
    # train id 0 (background) -> id 0 ("unlabeled", which the loader's
    # remap_default folds back to 0)
    trainid_to_id = np.zeros(256, np.uint8)
    for raw_id, train_id in CITYSCAPES_ID_TO_TRAINID.items():
        trainid_to_id[train_id] = raw_id
    n_classes = len(CITYSCAPES_ID_TO_TRAINID) + 1  # 19 + background

    def write_split(split, city_names, per, seed_off):
        for ci, city in enumerate(city_names):
            img_dir = os.path.join(root, "leftImg8bit", split, city)
            ann_dir = os.path.join(root, "gtFine", split, city)
            os.makedirs(img_dir, exist_ok=True)
            os.makedirs(ann_dir, exist_ok=True)
            src = SyntheticSource(per, size, n_classes, seed=seed + seed_off + ci)
            for i in range(per):
                img, lbl = src.load(i)
                stem = f"{city}_{i:06d}_000019"
                Image.fromarray(img).save(os.path.join(img_dir, f"{stem}_leftImg8bit.png"))
                raw = trainid_to_id[np.asarray(lbl, np.uint8)]
                Image.fromarray(raw).save(
                    os.path.join(ann_dir, f"{stem}_gtFine_labelIds.png"))

    write_split("train", TRAIN_CITIES[:cities], per_city, seed_off=1)
    write_split("val", VAL_CITIES[:val_cities], val_per_city, seed_off=100)
    return root


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="layout", required=True)
    voc = sub.add_parser("voc")
    voc.add_argument("--n-train", type=int, default=64)
    voc.add_argument("--n-val", type=int, default=16)
    voc.add_argument("--size", type=int, default=320)
    voc.add_argument("--num-classes", type=int, default=21)
    ade = sub.add_parser("ade")
    ade.add_argument("--n-train", type=int, default=32)
    ade.add_argument("--n-val", type=int, default=8)
    ade.add_argument("--size", type=int, default=96)
    ade.add_argument("--num-classes", type=int, default=151)
    cs = sub.add_parser("cityscapes")
    cs.add_argument("--cities", type=int, default=3)
    cs.add_argument("--per-city", type=int, default=8)
    cs.add_argument("--val-cities", type=int, default=1)
    cs.add_argument("--val-per-city", type=int, default=4)
    cs.add_argument("--size", type=int, default=128)
    for p in (voc, ade, cs):
        p.add_argument("--root", required=True)
        p.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])
    if args.layout == "voc":
        out = generate_voc(args.root, args.n_train, args.n_val, args.size,
                           args.num_classes, args.seed)
    elif args.layout == "ade":
        out = generate_ade(args.root, args.n_train, args.n_val, args.size,
                           args.num_classes, args.seed)
    else:
        out = generate_cityscapes(args.root, args.cities, args.per_city, args.val_cities,
                                  args.val_per_city, args.size, args.seed)
    print(f"wrote a synthetic {args.layout} layout at {out}")
    return out


if __name__ == "__main__":
    main()
