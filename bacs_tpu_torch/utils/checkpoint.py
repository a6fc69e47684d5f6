"""Checkpoint and resume: the whole train state, in the per-task layout.

Port of ``bacs_tpu/utils/checkpoint.py`` with ``torch.save`` in place of
orbax.  A checkpoint holds everything a resumed run needs to continue as
if uninterrupted: the network's parameters and statistics, the optimizer's
moments and the schedule's position (with gradient accumulation also the
mean gradient of the mini-steps so far and their count, which the
optimizer's ``state_dict`` holds, ``train/optim.py``), the counters, the state's generator,
the per-task prototypes, SDR's per-class prototypes, the frozen previous model, the replay buffer and
PLOP's thresholds.  The layout and the resume choice are the JAX
package's: ``<ckpt_dir>/step_<task>/<slot>``, mid-task saves alternating
between the slots ``last0`` and ``last1`` and ``final`` after a task's
``end_task``; the newest task wins, and within it ``final`` wins over the
newest mid-task slot (reference: trainer.py:133-179).  Each file is
written under a temporary name and renamed, so a crash mid-save leaves
the previous file whole.  Saving is synchronous (the JAX package's
asynchronous writer hides a TPU host's transfer).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import re
import shutil
import time
from typing import Any, Dict, Iterator, List, Optional

import torch

from bacs_tpu_torch.train.buffer import BufferState
from bacs_tpu_torch.train.state import TrainState, frozen_copy

_TENSORS = ("prototypes", "proto_counts", "class_prototypes", "class_proto_counts",
            "plop_thresholds", "plop_max_entropy")


def _ckpt_root(ckpt_dir: str) -> str:
    return os.path.abspath(os.path.expanduser(ckpt_dir))


def state_to_dict(state: TrainState) -> Dict[str, Any]:
    """Everything of ``state`` that a resume restores."""
    out: Dict[str, Any] = {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "scheduler": state.scheduler.state_dict(),
        "step": state.step, "epoch_step": state.epoch_step, "epoch": state.epoch,
        "generator": None if state.generator is None else state.generator.get_state(),
        "prev_model": None if state.prev_model is None else state.prev_model.state_dict(),
        # the fields themselves: asdict would deep-copy the buffer's tensors
        "buffer": None if state.buffer is None else {
            f.name: getattr(state.buffer, f.name) for f in dataclasses.fields(state.buffer)},
    }
    out.update({k: getattr(state, k) for k in _TENSORS})
    return out


def save_task_checkpoint(ckpt_dir: str, task_id: int, state: TrainState,
                         step: str = "final") -> str:
    """Save under ``<ckpt_dir>/step_<task_id>/<step>``."""
    step_dir = os.path.join(_ckpt_root(ckpt_dir), f"step_{task_id}")
    os.makedirs(step_dir, exist_ok=True)
    path = os.path.join(step_dir, str(step))
    tmp = os.path.join(step_dir, f".{step}.tmp")
    torch.save(state_to_dict(state), tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[tuple[int, str]]:
    """Newest (task_id, path); 'final' checkpoints of finished tasks win over
    mid-task saves, mirroring the reference's `[!f]*.ckpt` resume scan."""
    root = _ckpt_root(ckpt_dir)
    if not os.path.isdir(root):
        return None
    tasks = sorted(
        (int(m.group(1)) for d in os.listdir(root)
         if (m := re.fullmatch(r"step_(\d+)", d))),
        reverse=True,
    )
    for t in tasks:
        step_dir = os.path.join(root, f"step_{t}")
        steps = [s for s in os.listdir(step_dir) if not s.startswith(".")]
        if not steps:
            continue
        # a completed task has both `final` and mid-task saves; `final` must
        # win or resume re-runs end_task on top of the restored buffer
        if "final" in steps:
            return t, os.path.join(step_dir, "final")
        newest = max(steps, key=lambda d: os.path.getmtime(os.path.join(step_dir, d)))
        return t, os.path.join(step_dir, newest)
    return None


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load a checkpoint into ``state`` (a freshly built state of the same
    structure, on its device) and return it.  A structure mismatch raises.
    The generator's state is restored where the checkpoint's device type
    is the state's; otherwise ``state``'s own generator is kept."""
    device = next(state.model.parameters()).device
    saved = torch.load(path, map_location=device, weights_only=False)
    state.model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.scheduler.load_state_dict(saved["scheduler"])
    state.step, state.epoch_step, state.epoch = (
        saved["step"], saved["epoch_step"], saved["epoch"])
    if saved["generator"] is not None:
        generator = torch.Generator(device)
        rng = saved["generator"].cpu()
        # a checkpoint of another device type (the card's state restored on
        # the CPU, as serving does) cannot continue its draws here: the
        # template's seeded generator stays
        if rng.numel() == generator.get_state().numel():
            generator.set_state(rng)
            state.generator = generator
    if saved["prev_model"] is not None:
        if state.prev_model is None:
            state.prev_model = frozen_copy(state.model)
        state.prev_model.load_state_dict(saved["prev_model"])
    if saved["buffer"] is not None:
        if state.buffer is None:
            raise ValueError(f"{path} holds a replay buffer the run has no place for")
        state.buffer = BufferState(**saved["buffer"])
    for k in _TENSORS:
        setattr(state, k, saved.get(k))
    return state


class Interrupted(Exception):
    """Raised by a save under ``resume_check_saves`` to stop the run."""


@contextlib.contextmanager
def resume_check_saves(stop_task: Optional[int] = None,
                       record: Optional[List[tuple]] = None) -> Iterator[None]:
    """Saves for a stop-and-resume check.  Within the block every
    ``save_task_checkpoint`` also deletes the earlier tasks' checkpoints (a
    resume reads only the newest task's, and a full-size state is GiBs),
    appends ``(task_id, slot, seconds, bytes)`` to ``record``, and with
    ``stop_task`` raises ``Interrupted`` after that task's first mid-task
    save: a run stopped there and resumed should end as the whole run."""
    global save_task_checkpoint
    save = save_task_checkpoint

    def saving(ckpt_dir: str, task_id: int, state: TrainState, step: str = "final") -> str:
        t0 = time.perf_counter()
        path = save(ckpt_dir, task_id, state, step)
        if record is not None:
            record.append((task_id, step, time.perf_counter() - t0, os.path.getsize(path)))
        root = _ckpt_root(ckpt_dir)
        for d in os.listdir(root):
            if (m := re.fullmatch(r"step_(\d+)", d)) and int(m.group(1)) < task_id:
                shutil.rmtree(os.path.join(root, d))
        if task_id == stop_task and step != "final":
            raise Interrupted(path)
        return path

    save_task_checkpoint = saving
    try:
        yield
    finally:
        save_task_checkpoint = save
