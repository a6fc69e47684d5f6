"""The port's inference command line: serve a training run's checkpoint.

    python -m bacs_tpu_torch.predict --config-path conf/bacs \
        --config-name bacs_plus_config --checkpoint <ckpt_dir> \
        --images img1.jpg img2.jpg --out masks/ [overrides]

The counterpart of ``predict.py``: the same flags, plus ``--device``
(``cuda``, the default, raises where torch sees no card; ``cpu`` serves on
the CPU).  It restores the newest checkpoint under ``--checkpoint``
(``serve.Predictor.from_checkpoint``), resizes each image to the crop,
and writes one VOC-coloured ``<name>_mask.png`` per image to ``--out``.
``--n-devices`` splits each batch over that many cards, one replica a
card.  ``--export PATH`` writes the inference function at batch 8 with
``torch.export`` (``serve.Predictor.export``) on the serving device; a
process that loads it imports ``bacs_tpu_torch.serve`` first, and
``Predictor.run_exported(PATH, variables, images)`` serves it.
"""

from __future__ import annotations

import argparse
import sys


def parse_args(argv):
    parser = argparse.ArgumentParser(description="BACS inference (PyTorch)")
    parser.add_argument("--config-path", default="conf/joint_debug")
    parser.add_argument("--config-name", default="config")
    parser.add_argument("--checkpoint", required=True, help="ckpt_dir of a run")
    parser.add_argument("--images", nargs="*", default=[])
    parser.add_argument("--out", default="predictions")
    parser.add_argument("--export", default=None,
                        help="write the inference function with torch.export to this path")
    parser.add_argument("--conf-dtype", default="float16",
                        choices=("float16", "uint8", "none"),
                        help="confidence wire format (uint8 = 1/255 steps on the "
                             "device; none = masks only)")
    parser.add_argument("--pack-masks", action="store_true",
                        help="bit-pack the masks to ceil(log2(classes)) bits a pixel "
                             "on the device")
    parser.add_argument("--n-devices", type=int, default=None,
                        help="cards to split each batch over, one replica a card")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; cuda raises without a card")
    parser.add_argument("overrides", nargs="*", help="key=value overrides")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])
    from bacs_tpu_torch.config import load_config
    from bacs_tpu_torch.serve import Predictor

    config = load_config(args.config_path, args.config_name, args.overrides)
    predictor = Predictor.from_checkpoint(
        args.checkpoint, config, device=args.device,
        conf_dtype=args.conf_dtype, pack_masks=args.pack_masks, n_devices=args.n_devices)
    if args.export:
        print(f"exported inference fn to {predictor.export(args.export)}")
    masks = predictor.predict_files(args.images, out_dir=args.out) if args.images else []
    if args.images:
        print(f"wrote {len(args.images)} masks to {args.out}/")
    return masks


if __name__ == "__main__":
    main()
