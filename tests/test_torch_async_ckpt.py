"""Asynchronous checkpoint saves (``utils/checkpoint.py:AsyncSaver``) on
the CPU.

A BACS state on DeepLabV3-ResNet-18 with the seen detector, after one SGD
step (momentum set), with a previous model, prototypes and a filled
replay buffer.  A file written by an asynchronous save equals, tensor for
tensor, a synchronous save of the same state, also when every tensor of
the state is changed in place right after the call returns; two saves in a
row leave both slots whole and reuse the host buffers; a writer's error is
raised at the next wait (and by the Trainer's run), never swallowed.  The
stop-and-resume tests of ``tests/test_torch_loop.py`` and
``tests/test_torch_accumulate.py`` run through the asynchronous mid-task
saves unchanged.
"""

import os

import numpy as np
import pytest
import torch

from bacs_tpu_torch.ops import rng
from bacs_tpu_torch.config import load_config
from bacs_tpu_torch.methods import create_method
from bacs_tpu_torch.models import create_network
from bacs_tpu_torch.train import loop, optim
from bacs_tpu_torch.train.state import TaskInfo, TrainState, frozen_copy
from bacs_tpu_torch.utils import checkpoint
from torch_port_helpers import _one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROP = 32
TASK = TaskInfo(task_id=0, initial_classes=16, increment=1, num_classes=21, n_tasks=6)


def bacs_state(seed=0):
    torch.manual_seed(seed)
    model = create_network("deeplab", 21, n_tasks=6, use_bg_detector=True,
                           backbone="resnet18")
    opt, sched = optim.make_optimizer(
        {"_target_": "torch.optim.SGD", "lr": 0.01, "momentum": 0.9, "nesterov": True,
         "weight_decay": 1e-4}, model.parameters(), optim.poly_schedule(0.01, 10))
    loss = model.train()(torch.randn(2, CROP, CROP, 3)).sem_logits.square().mean()
    loss.backward()
    optim.apply_updates(opt, sched)
    method = create_method("loss.BACSLoss", buffer_size=4, replay_minibatch_size=2)
    buf = method.init_buffer(TASK, (CROP, CROP), (2, 2), device="cpu")
    buf.images.normal_()
    buf.logits.normal_()
    buf.valid.fill_(True)
    buf.num_seen = 4
    return TrainState(model, opt, sched, step=3, epoch_step=1,
                      key=rng.key(seed),
                      prototypes=torch.randn(6, 128), proto_counts=torch.arange(6.0),
                      prev_model=frozen_copy(model), buffer=buf)


def change_in_place(state):
    """Every tensor of the state changed where it lies, and the counters
    and the key moved on."""
    with torch.no_grad():
        for t in list(state.model.state_dict().values()) + [
                state.prototypes, state.proto_counts, state.buffer.images,
                state.buffer.logits, state.buffer.importance]:
            if t.dtype != torch.bool:
                t.add_(1)
        for s in state.optimizer.state.values():
            s["momentum_buffer"].mul_(2)
    state.step += 5
    state.key = rng.fold_in(state.key, 99)


def assert_same(got, ref, where=""):
    assert type(got) is type(ref), where
    if torch.is_tensor(ref):
        assert got.dtype == ref.dtype and torch.equal(got.cpu(), ref.cpu()), where
    elif isinstance(ref, dict):
        assert list(got) == list(ref), where
        for k in ref:
            assert_same(got[k], ref[k], f"{where}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), where
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_same(g, r, f"{where}/{i}")
    else:
        assert got == ref, where


def load(path):
    return torch.load(path, weights_only=False)


def test_async_file_equals_sync_file_after_in_place_changes(tmp_path):
    state = bacs_state()
    sync = checkpoint.save_task_checkpoint(str(tmp_path / "sync"), 0, state, "last0")
    saver = checkpoint.AsyncSaver()
    path = checkpoint.save_task_checkpoint(str(tmp_path / "async"), 0, state, "last0",
                                           saver, block=False)
    change_in_place(state)
    saver.wait()
    ref = load(sync)
    assert_same(load(path), ref)
    assert ref["optimizer"]["state"] and ref["buffer"]["num_seen"] == 4
    # the change itself reached the state: a new save differs
    changed = checkpoint.save_task_checkpoint(str(tmp_path / "sync"), 0, state, "last1")
    assert not torch.equal(load(changed)["prototypes"], ref["prototypes"])
    assert os.listdir(tmp_path / "async" / "step_0") == ["last0"]  # no temporary left


def test_two_saves_in_a_row_leave_both_slots_whole(tmp_path):
    state = bacs_state()
    ref0 = checkpoint.state_to_dict(bacs_state())
    saver = checkpoint.AsyncSaver()
    d = str(tmp_path)
    checkpoint.save_task_checkpoint(d, 1, state, "last0", saver, block=False)
    buffers = {k: v.data_ptr() for k, v in saver._host.items()}
    change_in_place(state)
    ref1 = load(checkpoint.save_task_checkpoint(str(tmp_path / "ref"), 1, state, "last1"))
    checkpoint.save_task_checkpoint(d, 1, state, "last1", saver, block=False)
    change_in_place(state)
    saver.wait()
    assert {k: v.data_ptr() for k, v in saver._host.items()} == buffers  # reused
    assert sorted(os.listdir(tmp_path / "step_1")) == ["last0", "last1"]
    assert_same(load(tmp_path / "step_1" / "last0"), ref0)
    assert_same(load(tmp_path / "step_1" / "last1"), ref1)
    assert checkpoint.latest_checkpoint(d) == (1, str(tmp_path / "step_1" / "last1"))


def test_a_writers_error_is_raised_at_the_next_wait(tmp_path, monkeypatch):
    state = bacs_state()
    saver = checkpoint.AsyncSaver()

    def full(obj, path):
        raise OSError("no space left on device")

    monkeypatch.setattr(checkpoint, "_write", full)
    checkpoint.save_task_checkpoint(str(tmp_path), 0, state, "last0", saver, block=False)
    with pytest.raises(OSError, match="no space"):
        saver.wait()
    saver.wait()  # raised once
    checkpoint.save_task_checkpoint(str(tmp_path), 0, state, "last1", saver, block=False)
    with pytest.raises(OSError, match="no space"):  # the next save waits first
        checkpoint.save_task_checkpoint(str(tmp_path), 0, state, "last0", saver,
                                        block=False)
    with pytest.raises(ValueError, match="AsyncSaver"):
        checkpoint.save_task_checkpoint(str(tmp_path), 0, state, "last0", block=False)


def test_the_trainer_raises_a_writers_error(tmp_path, monkeypatch):
    """conf/continual_debug (RN18, 32^2, batch 3, debug: 2 steps a task, a
    mid-task save after the first): a failing mid-task write stops the run
    with the writer's error; the blocking final save was not reached."""
    write = checkpoint._write

    def final_only(obj, path):
        if not path.endswith("final"):
            raise OSError(f"cannot write {path}")
        write(obj, path)

    monkeypatch.setattr(checkpoint, "_write", final_only)
    config = load_config(os.path.join(ROOT, "conf", "continual_debug"), "config", [
        "network=deep_lab", "dataset.dataset.crop_size=32", "training.batch_size=3",
        f"+training.ckpt_dir={tmp_path}"])
    trainer = loop.Trainer(config, device="cpu")
    with pytest.raises(OSError, match="cannot write .*last0"):
        trainer.fit()
    assert not (tmp_path / "step_0" / "final").exists()
    assert trainer.saver._thread is None


def test_resume_check_saves_records_async_saves(tmp_path):
    """``resume_check_saves`` waits for an asynchronous save's file before it
    records its size and stops the run."""
    state = bacs_state()
    saver = checkpoint.AsyncSaver()
    record = []
    with checkpoint.resume_check_saves(stop_task=0, record=record), \
            pytest.raises(checkpoint.Interrupted):
        checkpoint.save_task_checkpoint(str(tmp_path), 0, state, "last0", saver,
                                        block=False)
    ((task, slot, blocked, size, written),) = record
    assert (task, slot) == (0, "last0") and size == os.path.getsize(
        tmp_path / "step_0" / "last0")
    assert blocked >= 0 and written > 0 and np.isfinite(blocked + written)
