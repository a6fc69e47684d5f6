"""Checkpoint and resume: the whole train state, in the per-task layout.

Port of ``bacs_tpu/utils/checkpoint.py`` with ``torch.save`` in place of
orbax.  A checkpoint holds everything a resumed run needs to continue as
if uninterrupted: the network's parameters and statistics, the optimizer's
moments and the schedule's position (with gradient accumulation also the
mean gradient of the mini-steps so far and their count, which the
optimizer's ``state_dict`` holds, ``train/optim.py``), the counters, the state's key,
the per-task prototypes, SDR's per-class prototypes, the frozen previous model, the replay buffer and
PLOP's thresholds.  The layout and the resume choice are the JAX
package's: ``<ckpt_dir>/step_<task>/<slot>``, mid-task saves alternating
between the slots ``last0`` and ``last1`` and ``final`` after a task's
``end_task``; the newest task wins, and within it ``final`` wins over the
newest mid-task slot (reference: trainer.py:133-179).  Each file is
written under a temporary name and renamed, so a crash mid-save leaves
the previous file whole.

Mid-task saves are asynchronous, as the JAX package's ``block=False``
(``AsyncSaver``): the step loop pays for a snapshot of the state into
pinned host buffers, copied on a side stream, and one writer thread
``torch.save``s it while training goes on.  A blocking save waits for the
pending one first.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

import torch

from bacs_tpu_torch.ops import rng
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
        "key": None if state.key is None else list(state.key),
        "prev_model": None if state.prev_model is None else state.prev_model.state_dict(),
        # the fields themselves: asdict would deep-copy the buffer's tensors
        "buffer": None if state.buffer is None else {
            f.name: getattr(state.buffer, f.name) for f in dataclasses.fields(state.buffer)},
    }
    out.update({k: getattr(state, k) for k in _TENSORS})
    return out


def _write(obj: Any, path: str) -> None:
    """``torch.save`` under a temporary name, then rename."""
    head, tail = os.path.split(path)
    tmp = os.path.join(head, f".{tail}.tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


class AsyncSaver:
    """Asynchronous checkpoint writes, at most one in flight (the port's
    ``orbax.checkpoint.AsyncCheckpointer``).

    ``save`` snapshots the state and returns: every tensor is copied into a
    host buffer kept from save to save (pinned, for the card's tensors,
    copied on a side stream that first waits for the current stream; the
    current stream then waits for the copy, so no later step changes a
    tensor before it is read); the key, the counters and the
    optimizer's and schedule's other values are taken at the call.  A
    writer thread waits for the copy and writes the snapshot.  ``wait``
    blocks until the write has reached the disk and re-raises the writer's
    exception.  ``blocked_seconds`` is the last ``save``'s time in the
    caller, ``write_seconds`` its writer's (the copy's wait included)."""

    def __init__(self):
        self._host: Dict[tuple, torch.Tensor] = {}
        self._stream = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.blocked_seconds = 0.0
        self.write_seconds = 0.0

    def _buffer(self, key: tuple, t: torch.Tensor) -> torch.Tensor:
        buf = self._host.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
            self._host[key] = buf
        return buf

    def _snapshot(self, obj: Any, key: tuple = ()) -> Any:
        """``obj`` with every tensor copied into its host buffer (under the
        caller's stream context) and every container rebuilt."""
        if torch.is_tensor(obj):
            return self._buffer(key, obj).copy_(obj.detach(), non_blocking=obj.is_cuda)
        if isinstance(obj, dict):  # an OrderedDict keeps its attributes
            out = type(obj)((k, self._snapshot(v, key + (k,))) for k, v in obj.items())
            if hasattr(obj, "__dict__"):
                out.__dict__.update(obj.__dict__)
            return out
        if isinstance(obj, (list, tuple)):
            return type(obj)(self._snapshot(v, key + (i,)) for i, v in enumerate(obj))
        return obj

    def save(self, state: TrainState, path: str) -> None:
        t0 = time.perf_counter()
        self.wait()
        tree = state_to_dict(state)
        device = next(state.model.parameters()).device
        copied = None
        if device.type == "cuda":
            current = torch.cuda.current_stream(device)
            if self._stream is None:
                self._stream = torch.cuda.Stream(device)
            self._stream.wait_stream(current)
            with torch.cuda.stream(self._stream):
                snapshot = self._snapshot(tree)
                copied = torch.cuda.Event()
                copied.record(self._stream)
            current.wait_stream(self._stream)
        else:
            snapshot = self._snapshot(tree)

        def write():
            t1 = time.perf_counter()
            try:
                if copied is not None:
                    copied.synchronize()
                _write(snapshot, path)
            except BaseException as e:  # re-raised by the next wait()
                self._error = e
            self.write_seconds = time.perf_counter() - t1

        self._thread = threading.Thread(target=write, name="checkpoint-writer", daemon=True)
        self._thread.start()
        self.blocked_seconds = time.perf_counter() - t0

    def wait(self) -> None:
        """Block until the pending write is on the disk; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error


def save_task_checkpoint(ckpt_dir: str, task_id: int, state: TrainState,
                         step: str = "final", saver: Optional[AsyncSaver] = None,
                         block: bool = True) -> str:
    """Save under ``<ckpt_dir>/step_<task_id>/<step>``: through ``saver``
    without waiting for the write where ``block`` is false (the JAX
    package's ``block=False``), else now, after ``saver``'s pending write."""
    step_dir = os.path.join(_ckpt_root(ckpt_dir), f"step_{task_id}")
    os.makedirs(step_dir, exist_ok=True)
    path = os.path.join(step_dir, str(step))
    if not block:
        if saver is None:
            raise ValueError("an asynchronous save (block=False) needs an AsyncSaver")
        saver.save(state, path)
        return path
    if saver is not None:
        saver.wait()
    _write(state_to_dict(state), path)
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
    The key (the state's carried key, JAX's ``state.rng``) and the step
    counter restore as they are, on any device, so a resumed run takes the
    uninterrupted run's draws.  A checkpoint that holds the seed's key (the
    format before the key was carried from step to step) restores that key
    and continues its chain from there; one that holds a
    ``torch.Generator``'s state in place of a key (the format before the
    port's draws were counter-based) restores with ``state``'s own key."""
    device = next(state.model.parameters()).device
    saved = torch.load(path, map_location=device, weights_only=False)
    state.model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.scheduler.load_state_dict(saved["scheduler"])
    state.step, state.epoch_step, state.epoch = (
        saved["step"], saved["epoch_step"], saved["epoch"])
    if saved.get("key") is not None:
        state.key = rng.as_key(saved["key"])
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
    ``save_task_checkpoint`` deletes the earlier tasks' checkpoints (a
    resume reads only the newest task's, and a full-size state is GiBs) and
    appends ``(task_id, slot, seconds the caller was blocked, bytes, the
    writer's seconds or None)`` to ``record`` (an asynchronous save's once
    its write is on the disk, at the next save or the block's end); with
    ``stop_task`` it raises ``Interrupted`` after that task's first mid-task
    save, once its file is on the disk: a run stopped there and resumed
    should end as the whole run."""
    global save_task_checkpoint
    save = save_task_checkpoint
    pending: List[tuple] = []

    def settle():
        while pending:
            saver, task_id, step, blocked, path = pending.pop()
            saver.wait()
            if record is not None:
                record.append((task_id, step, blocked, os.path.getsize(path),
                               saver.write_seconds))

    def saving(ckpt_dir: str, task_id: int, state: TrainState, step: str = "final",
               saver: Optional[AsyncSaver] = None, block: bool = True) -> str:
        t0 = time.perf_counter()
        settle()  # the save would wait for it too
        path = save(ckpt_dir, task_id, state, step, saver, block)
        blocked = time.perf_counter() - t0
        if not block:
            pending.append((saver, task_id, step, blocked, path))
        elif record is not None:
            record.append((task_id, step, blocked, os.path.getsize(path), None))
        root = _ckpt_root(ckpt_dir)
        for d in os.listdir(root):  # written: a task's final save blocks
            if (m := re.fullmatch(r"step_(\d+)", d)) and int(m.group(1)) < task_id:
                shutil.rmtree(os.path.join(root, d))
        if task_id == stop_task and step != "final":
            settle()
            raise Interrupted(path)
        return path

    save_task_checkpoint = saving
    try:
        yield
    finally:
        save_task_checkpoint = save
        settle()
