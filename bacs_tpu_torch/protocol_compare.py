"""Run the continual-learning protocols of ``docs/RESULTS.md`` with the port.

    python -m bacs_tpu_torch.protocol_compare --protocol 15-1-flagship \
        --methods er [--device cpu] [--override training.ckpt_dir=build/ckpt]

The port's counterpart of ``scripts/protocol_compare.py``: the same
protocols, the same methods and their config overrides on
``conf/continual_debug``, the same command-line flags (plus ``--device``),
and the same output: one JSON line per method (``final_miou``,
``oldest_task_miou``, ``task0_miou``, ``avg_iou_per_dataset``,
``seconds``), then a markdown table.  Each leg is the port's ``Trainer``
on the card (``--device cuda``, the default; it raises where torch sees no
card) unless asked for the CPU.  The protocols pinned to UNet ("3task",
"15-1", "10-1", "15-5", "19-1" without ``--network deeplab``) raise as
``models.create_network`` does: UNet is ROADMAP.md queue 1 item 12.
"""

from __future__ import annotations

import argparse
import json
import time

METHOD_LOSS = {
    "ce": "crossentropy",
    "mib": "mib",
    "plop": "plop",
    "er": "er",
    "bacs": "bacs",
    # the shipped paper hyperparameters (conf/experiments/loss/bacs_plus.yaml:
    # alpha 0.8, beta 0.5, bg_weighted_ce) in place of the protocol's 0.5
    "bacs_plus": "bacs",
    "sdr": "sdr",
    "icarl": "icarl",
}

PROTOCOLS = {
    "3task": dict(
        n_classes=6, initial=3, increment=1, crop=32, epochs=8,
        n_train=48, n_val=16, layers=3, lr=0.05, lr_next=0.01,
        buffer=24, batch=8,
        default_methods=("ce", "mib", "plop", "er", "bacs", "sdr"),
    ),
    "15-1": dict(
        n_classes=21, initial=15, increment=1, crop=48, epochs=6,
        n_train=160, n_val=32, layers=4, lr=0.05, lr_next=0.01,
        buffer=60, batch=8,
        default_methods=("ce", "bacs"),
    ),
    # the rest of the reference's VOC scenario grid at 15-1's UNet scale
    "10-1": dict(
        n_classes=21, initial=10, increment=1, crop=48, epochs=6,
        n_train=160, n_val=32, layers=4, lr=0.05, lr_next=0.01,
        buffer=60, batch=8,
        default_methods=("ce", "bacs"),
    ),
    "15-5": dict(
        n_classes=21, initial=15, increment=5, crop=48, epochs=6,
        n_train=160, n_val=32, layers=4, lr=0.05, lr_next=0.01,
        buffer=60, batch=8,
        default_methods=("ce", "bacs"),
    ),
    "19-1": dict(
        n_classes=21, initial=19, increment=1, crop=48, epochs=6,
        n_train=160, n_val=32, layers=4, lr=0.05, lr_next=0.01,
        buffer=60, batch=8,
        default_methods=("ce", "bacs"),
    ),
    # 15-1 at flagship scale: DeepLabV3-RN50 from scratch, crop 256, the
    # `rich` synthetic source resident on the device
    "15-1-flagship": dict(
        n_classes=21, initial=15, increment=1, crop=256, epochs=12,
        n_train=1536, n_val=192, layers=4, lr=0.03, lr_next=0.003,
        buffer=100, batch=16, replay=12,
        net="deeplab", backbone="resnet50", style="rich", cache="device",
        default_methods=("ce", "mib", "bacs"),
    ),
    # the reference recipe's footprint: RN101, crop 512, batch 12, buffer
    # 300 / replay 12, lr_next 1e-3, 6 epochs
    "15-1-paper": dict(
        n_classes=21, initial=15, increment=1, crop=512, epochs=6,
        n_train=1024, n_val=96, layers=4, lr=0.02, lr_next=0.001,
        buffer=300, batch=12, replay=12,
        net="deeplab", backbone="resnet101", style="rich", cache="device",
        u8_buffer=True, remat=True, mixed_precision=True,
        default_methods=("ce", "bacs_plus"),
    ),
    # ADE20K 100-50's shape: two tasks at ADE's 151 classes
    "ade-100-50": dict(
        n_classes=151, initial=100, increment=50, crop=64, epochs=30,
        n_train=1024, n_val=128, layers=4, lr=0.05, lr_next=0.01,
        buffer=256, batch=8, replay=12, style="rich", cache="device",
        default_methods=("ce", "bacs"),
    ),
}


def method_overrides(protocol: dict, method: str, seed: int, network: str = "unet",
                     backbone: str = "resnet50", crop: int = 0,
                     extra_overrides: tuple = ()) -> list:
    """The overrides of ``conf/continual_debug`` for one leg, in the order
    ``scripts/protocol_compare.py:run_method`` builds them."""
    p = protocol
    net_overrides = ([f"network.num_layers={p['layers']}"] if network == "unet"
                     else ["network=deep_lab", f"network.backbone={backbone}"])
    overrides = [
        f"loss={METHOD_LOSS[method]}",
        f"dataset.dataset.num_classes={p['n_classes']}",
        f"dataset.dataset.crop_size={crop or p['crop']}",
        f"dataset.dataset.n_train={p['n_train']}",
        f"dataset.dataset.n_val={p['n_val']}",
        *net_overrides,
        f"training.initial_increment={p['initial']}",
        f"training.increment={p['increment']}",
        f"training.epochs={p['epochs']}",
        f"training.batch_size={p['batch']}",
        f"training.seed={seed}",
        f"training.lr_next={p['lr_next']}",
        f"optimizer.lr={p['lr']}",
        "training.debug=false",  # protocol runs use the full synthetic set
    ]
    if p.get("style"):
        overrides.append(f"+dataset.dataset.style={p['style']}")
    if p.get("cache"):
        overrides.append(f"+dataset.dataset.cache_decoded={p['cache']}")
    if p.get("remat"):
        overrides.append("network.remat=true")
    if p.get("mixed_precision"):
        overrides.append("+training.mixed_precision=true")
    if method in ("bacs", "bacs_plus"):
        plus = method == "bacs_plus"
        overrides += [
            "training.bg_detector=true",
            f"loss.buffer_size={p['buffer']}",
            f"loss.alpha={0.8 if plus else 0.5}",
            "loss.beta=0.5",
        ]
        if plus:  # conf/experiments/loss/bacs_plus.yaml
            overrides.append("+loss.bg_weighted_ce=true")
        if p.get("replay"):
            overrides.append(f"loss.replay_minibatch_size={p['replay']}")
        if p.get("u8_buffer"):
            overrides.append("+loss.buffer_image_dtype=uint8")
    elif method == "er":
        overrides += [f"loss.buffer_size={p['buffer']}"]
        if p.get("replay"):
            overrides.append(f"loss.replay_minibatch_size={p['replay']}")
        if p.get("u8_buffer"):
            overrides.append("+loss.buffer_image_dtype=uint8")
    return overrides + list(extra_overrides)


def run_method(protocol: dict, method: str, seed: int, network: str = "unet",
               backbone: str = "resnet50", crop: int = 0, extra_overrides: tuple = (),
               device: str = "cuda") -> dict:
    """Train one leg on ``device`` and return its JSON record."""
    from bacs_tpu_torch.config import load_config
    from bacs_tpu_torch.train.loop import Trainer

    overrides = method_overrides(protocol, method, seed, network, backbone, crop,
                                 extra_overrides)
    config = load_config("conf/continual_debug", "config", overrides)
    t0 = time.time()
    trainer = Trainer(config, device=device)
    final = trainer.fit()
    for t, sec in enumerate(trainer.task_seconds):
        trainer.logger.info(f"{method} task {t}: " + ", ".join(
            f"{k} {v:.2f} s" for k, v in sec.items()))
    trainer.logger.info(f"{method}: Trainer.throughput {trainer.throughput:.2f} img/s")
    rows = trainer.per_step_metric._per_step["mIoU"]
    oldest_end = float(rows[-1][0]) if rows and rows[-1] else float("nan")
    avg_iou = [round(float(v), 3) for v in trainer.per_step_metric.get_avg_iou()]
    return dict(
        method=method,
        final_miou=round(float(final), 3),
        oldest_task_miou=round(oldest_end, 3),
        # task 0's test mIoU right after training it
        task0_miou=round(float(rows[0][0]), 3) if rows and rows[0] else float("nan"),
        avg_iou_per_dataset=avg_iou,
        seconds=round(time.time() - t0, 1),
    )


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--protocol", choices=sorted(PROTOCOLS), default="3task")
    ap.add_argument("--methods", default=None,
                    help="comma list (default: the protocol's full set)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--network", choices=("unet", "deeplab"), default=None,
                    help="default: the protocol's own network (unet unless the "
                         "protocol pins one, e.g. 15-1-flagship)")
    ap.add_argument("--backbone", default=None,
                    help="DeepLab backbone (with --network deeplab)")
    ap.add_argument("--epochs", type=int, default=0,
                    help="override the protocol's epochs/task")
    ap.add_argument("--crop", type=int, default=0,
                    help="override the protocol's crop (deeplab needs /16)")
    ap.add_argument("--cache", default=None, choices=("device", "ram", "disk", "none"),
                    help="override the protocol's dataset decode cache (none = drop "
                         "the key: per-batch host decode)")
    ap.add_argument("--mode", default=None, choices=("overlap", "disjoint", "sequential"),
                    help="scenario membership mode (default: the config's, overlap)")
    ap.add_argument("--override", action="append", default=[],
                    help="extra override(s) appended to every leg, e.g. "
                         "--override training.ckpt_dir=build/ckpt")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda raises without a card")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    args = parse_args(argv)
    p = dict(PROTOCOLS[args.protocol])
    if args.epochs:
        p["epochs"] = args.epochs
    if args.cache:
        p["cache"] = None if args.cache == "none" else args.cache
    network = args.network or p.get("net", "unet")
    backbone = args.backbone or p.get("backbone", "resnet50")
    methods = args.methods.split(",") if args.methods else list(p["default_methods"])
    extra = list(args.override)
    if args.mode:
        extra.append(f"training.mode={args.mode}")
    results = []
    for m in methods:
        r = run_method(p, m, args.seed, network=network, backbone=backbone,
                       crop=args.crop, extra_overrides=tuple(extra), device=args.device)
        results.append(r)
        print(json.dumps(r), flush=True)

    tag = "" if network == "unet" else f", deeplab/{backbone}"
    if args.mode:
        tag += f", {args.mode}"
    print(f"\n## {args.protocol} protocol (seed {args.seed}{tag})\n")
    print("| Method | final mIoU | oldest-task mIoU at end | Avg-IoU per dataset |")
    print("|--------|-----------:|------------------------:|---------|")
    for r in results:
        avg = " / ".join(f"{v:.2f}" for v in r["avg_iou_per_dataset"])
        print(f"| {r['method']} | {r['final_miou']:.3f} | "
              f"{r['oldest_task_miou']:.3f} | {avg} |")
    return results


if __name__ == "__main__":
    main()
