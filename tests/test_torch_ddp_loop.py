"""The data-parallel Trainer: two gloo ranks against the JAX ``Trainer`` on a
2-device mesh, and the command line with ``+training.n_devices=2``.

``conf/continual_debug`` with ``network=deep_lab`` (DeepLabV3-ResNet-18),
32^2 crops, 3 images a rank (a global batch of 6), 3 tasks.

- ``python -m bacs_tpu_torch.main --device cpu ... loss=bacs
  +training.n_devices=2`` (in this process: it spawns its two ranks), not
  in debug mode (24 train images, 1 epoch, checkpoints on): it finishes at
  a finite mIoU.
- Then every case below in two ranks spawned once (``ranks``):
  - ``smooth``: CE with the fused stem on the smooth network (every ABN
    the identity activation, as ``tests/test_torch_loop.py``'s
    ``ce_fused_stem_smooth``), debug mode (6 images a task, 2 epochs: 2
    steps a task), both sides' augmentation replaced by the eval transform
    and the port started from JAX's initial weights, against the JAX
    Trainer with ``n_devices=2``: every train-step loss within 1e-4 and
    every task's mIoU within 1e-3.  The smooth network's patches go to the
    ranks as arguments (a spawned process inherits no monkeypatch).
  - ``resume``: the command line's run resumed from its checkpoints with
    task 2's removed, so both ranks restore task 1's final checkpoint, the
    one rank 0 wrote, and train task 2 again: the final mIoU equals the
    command line's.  In that run only rank 0 saves; ``end_task``'s stream
    is loader-sized (3 images a batch, not the global 6) and its context
    names no group.

JAX is imported inside the reference function: the ranks import this
module and need none of it.
"""

import contextlib
import functools
import os
import re
import shutil
from unittest import mock

import numpy as np
import pytest

import bacs_tpu_torch.models as port_models
from bacs_tpu_torch import main as port_main
from bacs_tpu_torch import parallel
from bacs_tpu_torch.config import load_config
from bacs_tpu_torch.data import transforms
from bacs_tpu_torch.train import loop
from bacs_tpu_torch.utils import checkpoint
from bacs_tpu_torch.utils.flax_weights import load_flax_variables
from bacs_tpu_torch.utils.logging import Logger
from torch_port_helpers import _one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(ROOT, "conf", "continual_debug")
BASE = ["network=deep_lab", "dataset.dataset.crop_size=32", "training.batch_size=3",
        "+training.n_devices=2"]
SMOOTH = BASE + ["+network.fused_stem=true", "training.epochs=2"]
BACS = BASE + ["loss=bacs", "training.debug=false", "dataset.dataset.n_train=24"]
LOSS_RTOL, MIOU_TOL = 1e-4, 1e-3


def _recording(stack, loop_mod, logger_cls, models_mod, smooth):
    """Record every logged metric dict and train-step loss; with ``smooth``
    give every ABN the identity activation."""
    log = {"metrics": [], "losses": []}
    stack.enter_context(mock.patch.object(
        logger_cls, "log_metrics", lambda self, m: log["metrics"].append(dict(m))))
    make_steps = loop_mod.make_steps

    def recording(*a, **k):
        train_step, eval_step, put_batch = make_steps(*a, **k)

        def step(state, batch):
            state, metrics = train_step(state, batch)
            log["losses"].append(float(metrics["loss"]))
            return state, metrics

        return step, eval_step, put_batch

    stack.enter_context(mock.patch.object(loop_mod, "make_steps", recording))
    if smooth:
        make_norm = models_mod.make_norm
        stack.enter_context(mock.patch.object(
            models_mod, "make_norm",
            lambda *a, **k: functools.partial(make_norm(*a, **k), activation="identity")))
    return log


def _miou(log):
    return {k: v for m in log["metrics"] for k, v in m.items()
            if re.fullmatch(r"test\.\d+/Task \d+/mIoU", k)}


# ---------------------------------------------------------------- the ranks


def rank_smooth(group, init):
    """The smooth CE run on this rank, from JAX's initial weights."""
    params, stats = init
    with contextlib.ExitStack() as stack:
        log = _recording(stack, loop, Logger, port_models, smooth=True)
        stack.enter_context(mock.patch.object(
            transforms, "train_transform",
            lambda gen, imgs, lbls, table, crop=512, scale=None, rows=None:
            transforms.eval_transform(imgs, lbls, table, crop=crop)))
        stack.enter_context(mock.patch.object(
            loop, "init_weights", lambda model, seed: load_flax_variables(model, params, stats)))
        trainer = loop.Trainer(load_config(CONF, "config", SMOOTH), device="cpu", group=group)
        log["miou"] = trainer.fit()
        log["n_devices"] = trainer.n_devices
    return log


def rank_resume(group, ckpt_dir):
    """The BACS run resumed from ``ckpt_dir``: its final mIoU, the saves this
    rank made, and each ``end_task`` stream's batch sizes and group."""
    saves, boundary = [], []
    save = checkpoint.save_task_checkpoint

    def recorded_save(ckpt_dir, task_id, state, step="final", *a, **k):
        saves.append((task_id, step))
        return save(ckpt_dir, task_id, state, step, *a, **k)

    with mock.patch.object(checkpoint, "save_task_checkpoint", recorded_save):
        trainer = loop.Trainer(load_config(CONF, "config", BACS + [
            f"+training.ckpt_dir={ckpt_dir}"]), device="cpu", group=group)
        starts, try_resume = [], trainer._try_resume
        trainer._try_resume = lambda: starts.append(try_resume()) or starts[-1]
        end_task = trainer.method.end_task

        def recorded_end_task(state, ctx, batches):
            sizes = []

            def stream():
                for b in batches:
                    sizes.append(int(b["image"].shape[0]))
                    yield b

            boundary.append((ctx.group is None, sizes))
            return end_task(state, ctx, stream())

        trainer.method.end_task = recorded_end_task
        miou = trainer.fit()
    return dict(start=starts[0], miou=miou, saves=saves, boundary=boundary,
                writes=trainer.writes_checkpoints)


def rank_cases(group, device, cases):
    return {name: fn(group, *args) for name, (fn, args) in cases.items()}


# ---------------------------------------------------------------- JAX


@functools.lru_cache(maxsize=None)
def jax_smooth():
    import jax

    import bacs_tpu.models as jax_models
    from bacs_tpu.config import load_config as jax_load_config
    from bacs_tpu.data import transforms as jax_transforms
    from bacs_tpu.train import loop as jax_loop
    from bacs_tpu.utils.logging import Logger as JaxLogger

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    with contextlib.ExitStack() as stack:
        log = _recording(stack, jax_loop, JaxLogger, jax_models, smooth=True)
        stack.enter_context(mock.patch.object(
            jax_transforms, "train_transform",
            lambda rng, imgs, lbls, table, crop=512, scale=None:
            jax_transforms.eval_transform(imgs, lbls, table, crop=crop)))
        trainer = jax_loop.Trainer(jax_load_config(CONF, "config", SMOOTH))
        task = trainer._task_info(0)
        init = trainer._init_state(trainer._make_model(task), trainer._make_tx(task), task)
        log["init"] = (jax.tree.map(np.asarray, init.params),
                       jax.tree.map(np.asarray, init.batch_stats))
        log["miou"] = trainer.fit()
        log["n_devices"] = trainer.n_devices
    return log


# ---------------------------------------------------------------- the fixture


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The command line's BACS run, then every rank case, one spawn each."""
    ckpt_dir = str(tmp_path_factory.mktemp("ddp_ckpt"))
    try:
        # the command line's ranks on one thread each, as the rest of the file
        with mock.patch.dict(os.environ, {"OMP_NUM_THREADS": "1"}):
            cli_miou = port_main.main(["--device", "cpu", "--config-path", CONF,
                                       "--config-name", "config", *BACS,
                                       f"+training.ckpt_dir={ckpt_dir}"])
        files = sorted(os.path.relpath(os.path.join(d, f), ckpt_dir)
                       for d, _, fs in os.walk(ckpt_dir) for f in fs)
        shutil.rmtree(os.path.join(ckpt_dir, "step_2"))
        cases = {"smooth": (rank_smooth, (jax_smooth()["init"],)),
                 "resume": (rank_resume, (ckpt_dir,))}
        ranks = parallel.spawn(rank_cases, 2, (cases,), threads=1)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return dict(cli_miou=cli_miou, files=files, ranks=ranks)


def test_cli_trains_bacs_on_two_cpu_ranks(runs):
    assert np.isfinite(runs["cli_miou"])
    # the tasks' final checkpoints and the mid-task slots, each written once
    assert {"step_0/final", "step_1/final", "step_2/final"} <= set(runs["files"])
    assert not [f for f in runs["files"] if "tmp" in f]


def test_smooth_ce_trainer_matches_the_jax_mesh(runs):
    ref = jax_smooth()
    r0, r1 = (r["smooth"] for r in runs["ranks"])
    assert ref["n_devices"] == r0["n_devices"] == 2
    assert r0["losses"] == r1["losses"] and r0["miou"] == r1["miou"]
    assert len(r0["losses"]) == len(ref["losses"]) == 6
    np.testing.assert_allclose(r0["losses"], ref["losses"], rtol=LOSS_RTOL)
    got, want = _miou(r0), _miou(ref)
    assert got.keys() == want.keys() and len(want) == 6
    for k in want:
        assert abs(got[k] - want[k]) <= MIOU_TOL, (k, got[k], want[k])


def test_resume_from_a_two_rank_checkpoint(runs):
    r0, r1 = (r["resume"] for r in runs["ranks"])
    assert r0["start"] == r1["start"] == 2
    assert r0["miou"] == r1["miou"] == pytest.approx(runs["cli_miou"], abs=1e-6)
    # only rank 0 writes; the task's final save comes after end_task
    assert r0["writes"] and not r1["writes"]
    assert r0["saves"] and r0["saves"][-1] == (2, "final") and not r1["saves"]
    # end_task at the boundary: no group, loader-sized batches
    for r in (r0, r1):
        (no_group, sizes), = r["boundary"]
        assert no_group and sizes and set(sizes) == {3}
