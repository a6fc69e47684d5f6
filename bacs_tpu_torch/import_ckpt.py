"""Import a reference PyTorch-Lightning checkpoint into a run of the port.

    python -m bacs_tpu_torch.import_ckpt --ckpt step_0/final.ckpt \
        --config-path conf/bacs --config-name bacs_plus_config \
        --out <ckpt_dir> [--task-id 0] [--populate-buffer] [--device cuda] \
        [overrides]

The counterpart of ``scripts/import_reference_ckpt.py``.  A checkpoint the
reference's per-task loop wrote (``<ckpt_dir>/step_<t>/final.ckpt``,
reference: training/trainer.py:404) becomes the port's ``final``
checkpoint of task t (``utils/checkpoint.py``), so that

- ``python -m bacs_tpu_torch.main ... training.ckpt_dir=<out>`` resumes the
  continual run at task t + 1 with the imported weights, and
- ``python -m bacs_tpu_torch.predict --checkpoint <out> ...`` serves them.

The whole network is converted (backbone, ASPP / transformer / UNet
decoder, classifier heads, the detector) by ``utils/torch_weights.py``.
Per-task ``classifier_head.<t>`` heads are concatenated into the padded
head; their count gives t unless ``--task-id`` says otherwise.  What the
reference checkpoint does not hold starts fresh: the optimizer (a resumed
task builds a fresh one anyway), the replay buffer and the prototypes.
``--populate-buffer`` runs the method's ``end_task`` over the task's
unaugmented train stream with the imported weights, which fills the buffer
and the prototypes and freezes the previous model as if task t had just
finished here; without it, a method that needs the previous model gets a
frozen copy of the imported one.
"""

from __future__ import annotations

import argparse
import re
import sys

import numpy as np


def _strip_module_prefix(sd):
    """A Lightning checkpoint prefixes every key with the module's attribute
    name (``network.``, reference: training/model.py:34)."""
    if any(k.startswith("network.") for k in sd):
        sd = {k[len("network."):]: v for k, v in sd.items() if k.startswith("network.")}
    return sd


def _merge_multihead(sd, prefix="classifier_head"):
    """Per-task ModuleList head convs concatenated into one
    ``<prefix>.weight``/``.bias`` (reference: base_network.py:108-113 joins
    the heads' outputs over channels); returns (sd, count of heads or
    None)."""
    rows = {}
    for k in list(sd):
        m = re.fullmatch(rf"{re.escape(prefix)}\.(\d+)\.(weight|bias)", k)
        if m:
            rows.setdefault(int(m.group(1)), {})[m.group(2)] = sd.pop(k)
    if rows:
        idxs = sorted(rows)
        sd[f"{prefix}.weight"] = np.concatenate([rows[i]["weight"] for i in idxs], axis=0)
        sd[f"{prefix}.bias"] = np.concatenate([rows[i]["bias"] for i in idxs], axis=0)
    return sd, (max(rows) + 1 if rows else None)


def import_reference_checkpoint(ckpt_path: str, config, out_dir: str,
                                task_id: int | None = None, populate_buffer: bool = False,
                                device: str = "cuda", datamodule=None):
    """Returns (state, task_id, tensors loaded, tensors in the file, path);
    writes ``<out_dir>/step_<task_id>/final``."""
    from bacs_tpu_torch.methods.base import ModelContext
    from bacs_tpu_torch.train.loop import Trainer
    from bacs_tpu_torch.train.state import frozen_copy
    from bacs_tpu_torch.utils.checkpoint import save_task_checkpoint
    from bacs_tpu_torch.utils.flax_weights import load_flax_variables
    from bacs_tpu_torch.utils.torch_weights import (
        convert_reference, load_torch_state_dict, model_variables)

    trainer = Trainer(config, datamodule=datamodule, device=device)
    sd = _strip_module_prefix(load_torch_state_dict(ckpt_path))
    sd, n_heads = _merge_multihead(sd)
    if task_id is None:
        task_id = n_heads - 1 if n_heads is not None else 0
        if n_heads is None and trainer.continual:
            trainer.logger.info(
                "WARNING: single-head checkpoint, so the task id cannot be inferred "
                "from the head count; assuming --task-id 0.  Pass --task-id for "
                "SingleHead continual runs.")
    trainer.datamodule.set_task_id(task_id)
    task = trainer._task_info(task_id)
    state = trainer._init_state(task)
    target = str(config.get("network", {}).get("_target_", "networks.DeepLabV3"))
    params, stats, loaded = convert_reference(sd, model_variables(state.model), target)
    load_flax_variables(state.model, params, stats)
    total = len([k for k in sd if not k.endswith("num_batches_tracked")])

    trainer.state = state
    trainer._set_active_classes(task)
    method = trainer.method
    if populate_buffer:
        # the reference's own post-resume story: on_train_end re-populates
        # the buffer and clones the previous model (loss/bacs_loss.py:133-203)
        # a loader, not a one-pass stream: with the prototypes still empty
        # the sweep passes over the data before the fill does
        state = method.end_task(state, ModelContext(task, fused_ce=trainer.fused_ce),
                                trainer.datamodule.train_loader(0, augment=False))
    elif method.needs_prev_model:
        # a `final` checkpoint means task t completed: the next task's
        # teacher is this model (reference: model.clone() at on_train_end)
        state.prev_model = frozen_copy(state.model)
    path = save_task_checkpoint(out_dir, task_id, state, "final")
    return state, task_id, loaded, total, path


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Convert a reference Lightning checkpoint to a run of the port")
    parser.add_argument("--ckpt", required=True, help="reference .ckpt (Lightning or a "
                        "bare state_dict)")
    parser.add_argument("--config-path", default="conf/joint_debug")
    parser.add_argument("--config-name", default="config")
    parser.add_argument("--out", required=True, help="checkpoint dir to create")
    parser.add_argument("--task-id", type=int, default=None,
                        help="the task the checkpoint completed (default: from the "
                             "count of per-task heads)")
    parser.add_argument("--populate-buffer", action="store_true",
                        help="run the method's end_task over the train stream to fill "
                             "the replay buffer, the prototypes and the teacher")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; cuda raises without a card")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])

    from bacs_tpu_torch.config import load_config

    config = load_config(args.config_path, args.config_name, args.overrides)
    _, task_id, loaded, total, path = import_reference_checkpoint(
        args.ckpt, config, args.out, task_id=args.task_id,
        populate_buffer=args.populate_buffer, device=args.device)
    print(f"imported {loaded}/{total} tensors from {args.ckpt} as completed task "
          f"{task_id}: {path}")
    where = f"--config-path {args.config_path} --config-name {args.config_name}"
    print(f"resume:  python -m bacs_tpu_torch.main {where} training.ckpt_dir={args.out}")
    print(f"serve:   python -m bacs_tpu_torch.predict {where} --checkpoint {args.out} ...")
    return task_id, loaded, total, path


if __name__ == "__main__":
    main()
