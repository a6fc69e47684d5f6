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
card) unless asked for the CPU.  A leg is a function of its seed, and the
seed names JAX's run: the port draws JAX's initial weights and keys for it
(``utils/flax_init.py``, ``ops/rng.py``), its kernels use no float atomics
and the Trainer runs cuDNN's deterministic algorithms, so two card runs of
a seed give the same weights bit for bit, and a card run, a CPU run and
``scripts/protocol_compare.py``'s run of a seed see the same initial
weights, crops, dropout masks and replay picks.  ``--seeds 42-57`` runs each method over a range of seeds;
``--digest`` adds to each record its seed, the unrounded final mIoU and a
SHA-256 of the final weights, for paired and repeat comparisons;
``--pair A B`` pairs two such outputs by (method, seed) and prints each
seed's two final mIoUs, their difference A - B and, per method, the
Wilcoxon signed-rank p-value of the differences; either output may also be
``scripts/protocol_compare.py``'s (JAX's records carry no seed and a
final mIoU rounded to 3 decimals: each takes the seed of the ``## ...
(seed N`` line after it), so a port leg pairs with JAX's leg of the same
seed, the same experiment in two implementations.  The protocols "3task", "15-1", "10-1",
"15-5" and "19-1" train a UNet (``models/unet.py``) unless ``--network
deeplab`` is given; its logits are at label resolution, so their legs
launch no upsample kernel.
"""

from __future__ import annotations

import argparse
import hashlib
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


def weights_digest(model) -> str:
    """SHA-256 of a model's state dict: every tensor's name and bytes, in
    order."""
    import torch

    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def run_method(protocol: dict, method: str, seed: int, network: str = "unet",
               backbone: str = "resnet50", crop: int = 0, extra_overrides: tuple = (),
               device: str = "cuda", digest: bool = False) -> dict:
    """Train one leg on ``device`` and return its JSON record (with
    ``digest``, also its seed, the unrounded final mIoU and the final
    weights' SHA-256)."""
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
    extra = {}
    if digest:
        extra = dict(seed=seed, final_miou_exact=float(final),
                     weights_sha256=weights_digest(trainer.state.model))
    return dict(
        method=method,
        final_miou=round(float(final), 3),
        oldest_task_miou=round(oldest_end, 3),
        # task 0's test mIoU right after training it
        task0_miou=round(float(rows[0][0]), 3) if rows and rows[0] else float("nan"),
        avg_iou_per_dataset=avg_iou,
        seconds=round(time.time() - t0, 1),
        **extra,
    )


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--protocol", choices=sorted(PROTOCOLS), default="3task")
    ap.add_argument("--methods", default=None,
                    help="comma list (default: the protocol's full set)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--seeds", default=None,
                    help="a range A-B (or a comma list) of seeds: every method at "
                         "every seed, in place of --seed")
    ap.add_argument("--digest", action="store_true",
                    help="add the seed, the unrounded final mIoU and the final "
                         "weights' SHA-256 to each record")
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
    ap.add_argument("--pair", nargs=2, metavar=("A", "B"), default=None,
                    help="pair the --digest records of two outputs (JSON lines; a "
                         "record with tf32 false pairs as its method + ' tf32 off'; "
                         "scripts/protocol_compare.py's lines too) and print the "
                         "paired study; trains nothing")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda raises without a card")
    return ap.parse_args(argv)


def parse_seeds(text: str) -> list:
    """"42-57" -> [42, ..., 57]; "1,5,9" -> [1, 5, 9]."""
    if "-" in text:
        lo, hi = (int(v) for v in text.split("-"))
        return list(range(lo, hi + 1))
    return [int(v) for v in text.split(",")]


def read_records(path: str) -> list:
    """The --digest records among an output's lines, and the records of
    ``scripts/protocol_compare.py`` (no seed, ``final_miou`` to 3 decimals),
    each given the seed of the next ``## <protocol> protocol (seed N``
    line and its ``final_miou`` as ``final_miou_exact``."""
    out, pending = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("{") and "final_miou_exact" in line:
                out.append(json.loads(line))
            elif line.startswith("{") and '"final_miou"' in line:
                r = json.loads(line)
                pending.append(dict(r, final_miou_exact=r["final_miou"], rounded=True))
            elif line.startswith("## ") and "(seed " in line and pending:
                seed = int(line.split("(seed ")[1].split(",")[0].split(")")[0])
                out += [dict(r, seed=seed) for r in pending]
                pending = []
    return out


def paired(card: list, cpu: list) -> dict:
    """Per method: the seeds both sides hold, each side's final mIoU, the
    differences first - second (card - CPU, or port - JAX), their mean and
    the two-sided Wilcoxon signed-rank p-value (1.0 where every difference
    is 0).  Where either side's record is rounded (JAX's runner prints 3
    decimals), both values are compared at 3 decimals."""
    from scipy.stats import wilcoxon

    def label(r):
        return r["method"] + ("" if r.get("tf32", True) else " tf32 off")

    def value(r, rounded):
        return round(r["final_miou_exact"], 3) if rounded else r["final_miou_exact"]

    cpu_by = {(r["method"], r["seed"]): r for r in cpu}
    out = {}
    for name in dict.fromkeys(label(r) for r in card):
        pairs = [(r, cpu_by[(r["method"], r["seed"])]) for r in card
                 if label(r) == name and (r["method"], r["seed"]) in cpu_by]
        rows = []
        for r, c in pairs:
            rounded = r.get("rounded", False) or c.get("rounded", False)
            rows.append((r["seed"], value(r, rounded), value(c, rounded)))
        diffs = [a - b for _, a, b in rows]
        p = 1.0 if not any(diffs) else float(wilcoxon(diffs).pvalue)
        out[name] = dict(rows=rows, mean_card=sum(a for _, a, _ in rows) / len(rows),
                         mean_cpu=sum(b for _, _, b in rows) / len(rows),
                         mean_diff=sum(diffs) / len(diffs), wilcoxon_p=p)
    return out


def main(argv=None) -> list:
    args = parse_args(argv)
    if args.pair:
        study = paired(read_records(args.pair[0]), read_records(args.pair[1]))
        first, second = args.pair
        for name, s in study.items():
            print(f"\n## {name}: A ({first}) mean {s['mean_card']:.4f}, B ({second}) mean "
                  f"{s['mean_cpu']:.4f}, mean difference {s['mean_diff']:+.4f}, Wilcoxon "
                  f"p {s['wilcoxon_p']:.3g} ({len(s['rows'])} seeds)\n")
            print("| seed | A | B | A - B |")
            print("|-----:|--:|--:|------:|")
            for seed, a, b in s["rows"]:
                print(f"| {seed} | {a:.4f} | {b:.4f} | {a - b:+.4f} |")
        print(json.dumps(study))
        return [study]
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
    for seed in parse_seeds(args.seeds) if args.seeds else [args.seed]:
        for m in methods:
            r = run_method(p, m, seed, network=network, backbone=backbone,
                           crop=args.crop, extra_overrides=tuple(extra),
                           device=args.device, digest=args.digest)
            results.append(r)
            print(json.dumps(r), flush=True)

    tag = "" if network == "unet" else f", deeplab/{backbone}"
    if args.mode:
        tag += f", {args.mode}"
    print(f"\n## {args.protocol} protocol (seed {args.seeds or args.seed}{tag})\n")
    print("| Method | final mIoU | oldest-task mIoU at end | Avg-IoU per dataset |")
    print("|--------|-----------:|------------------------:|---------|")
    for r in results:
        avg = " / ".join(f"{v:.2f}" for v in r["avg_iou_per_dataset"])
        print(f"| {r['method']} | {r['final_miou']:.3f} | "
              f"{r['oldest_task_miou']:.3f} | {avg} |")
    return results


if __name__ == "__main__":
    main()
