"""MiB, PLOP and SDR through the port's ``Trainer`` against the JAX
``Trainer``, over three tasks, on the CPU.

The protocol of ``tests/test_torch_loop.py``: ``conf/continual_debug``
with ``network=deep_lab`` (DeepLabV3-ResNet-18), 32^2 crops, batch 3,
``debug: true`` (2 train steps a task), 6 classes in 3 tasks, both sides'
train augmentation replaced by the eval transform, the port started from
the JAX package's initial weights, and every ABN with the identity
activation (the smooth network), so the two packages agree to f32
rounding.  None of these methods draws at random, so nothing is injected.

What the Trainer adds to the steps is held: each method's task boundary
(the previous-model snapshot in ``end_task``, the head surgery, PLOP's
``begin_task`` histogram and thresholds inside the loop, SDR's class
prototypes across tasks).

SDR runs at batch 6 (one step a task): at batch 3 its steps amplify
rounding about a thousandfold (the unbiased KD at ``loss_kd`` 100
through the ASPP's global-pool ABN over three images): when its initial
weights move by 1e-6 (relative, seeded) the port's own loss at task 1's
second step moves by 2.4e-3, where the port and JAX differ by 3.7e-5
(and by 1.2e-4 and 2.4e-4 at task 2's two steps; measured). At batch 6
the same perturbation moves its losses by at most 3.6e-5 and the port is
within 1.2e-6 of JAX.

Every train-step loss of every task within LOSS_RTOL 1e-4, every task's
mIoU on every evaluated task within MIOU_TOL 1e-3, the same metric keys,
task count and step counts.  One exception, shown where it is taken: a
test pixel whose two best logits in the port lie within TIE_MARGIN 1e-4
of each other is a tie the packages' rounding (about 1e-5 of the ~2-9
logits) may break either way, and the task whose test holds one has its
mIoUs held within TIE_MIOU_TOL 1e-2 (each run prints its margins).
Measured: BACS's task-1 test has a pixel at 6.1e-5, and its task-1
mIoUs are 3.5e-3 and 4.5e-3 from JAX's; the port's own run, its initial
weights moved by 1e-6 (relative, seeded), lands within 1e-5 of JAX's
there.  Each side's run is made once per process.
``run_pair`` is shared with ``tests/test_torch_loop_replay.py``.
"""

import contextlib
import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax

import bacs_tpu.models as jax_models
import bacs_tpu_torch.models as port_models
import test_torch_loop as tl
from bacs_tpu.config import load_config as jax_load_config
from bacs_tpu.data import transforms as jax_transforms
from bacs_tpu.train import loop as jax_loop
from bacs_tpu.utils.logging import Logger as JaxLogger
from bacs_tpu_torch.config import load_config
from bacs_tpu_torch.data import transforms
from bacs_tpu_torch.train import loop
from bacs_tpu_torch.utils.flax_weights import load_flax_variables
from bacs_tpu_torch.utils.logging import Logger
from torch_port_helpers import _one_thread  # noqa: F401

LOSS_RTOL, MIOU_TOL = 1e-4, 1e-3
# a test pixel whose two best logits are closer than TIE_MARGIN can take
# either class in the two packages; a task whose test has one is held at
# TIE_MIOU_TOL
TIE_MARGIN, TIE_MIOU_TOL = 1e-4, 1e-2
RUNS = {"mib": ["loss=mib"], "plop": ["loss=plop"],
        "sdr": ["loss=sdr", "training.batch_size=6"]}


def jax_trainer_run(overrides, injected=contextlib.nullcontext):
    """The JAX Trainer on the smooth network: its logged metrics, every
    train step's loss, its initial variables and its final mIoU."""
    config = jax_load_config(tl.CONF, "config", tl.BASE + list(overrides))
    log = {}
    with tl._patches("run_smooth", jax_models, JaxLogger, jax_loop, log), mock.patch.object(
            jax_transforms, "train_transform",
            lambda rng, imgs, lbls, table, crop=512, scale=None:
            jax_transforms.eval_transform(imgs, lbls, table, crop=crop)), injected():
        trainer = jax_loop.Trainer(config)
        task = trainer._task_info(0)
        init = trainer._init_state(trainer._make_model(task), trainer._make_tx(task), task)
        log["init"] = (jax.tree.map(np.asarray, init.params),
                       jax.tree.map(np.asarray, init.batch_stats))
        log["miou"] = trainer.fit()
        log["n_tasks"] = trainer.n_tasks
    return log


def recording_margins(margins):
    """``loop.make_steps`` whose eval step also records, per task, the
    smallest gap between the two best logits over the valid test pixels."""
    make_steps = loop.make_steps

    def steps(ctx, *a, **k):
        train_step, eval_step, put_batch = make_steps(ctx, *a, **k)

        def recorded(state, conf, batch):
            with torch.no_grad():
                logits = state.model.eval()(batch["image"]).logits[..., : ctx.n_cur]
            top = logits.topk(2, dim=-1).values
            gap = float((top[..., 0] - top[..., 1])[batch["label"] != 255].min())
            t = ctx.task.task_id
            margins[t] = min(margins.get(t, np.inf), gap)
            return eval_step(state, conf, batch)

        return train_step, recorded, put_batch

    return mock.patch.object(loop, "make_steps", steps)


def port_trainer_run(overrides, init, injected=contextlib.nullcontext):
    """The port's Trainer on the smooth network from ``init``."""
    params, stats = init
    config = load_config(tl.CONF, "config", tl.BASE + list(overrides))
    log = {"margins": {}}
    with tl._patches("run_smooth", port_models, Logger, loop, log), \
            recording_margins(log["margins"]), mock.patch.object(
            transforms, "train_transform",
            lambda gen, imgs, lbls, table, crop=512, scale=None:
            transforms.eval_transform(imgs, lbls, table, crop=crop)), mock.patch.object(
            loop, "init_weights", lambda model, seed: load_flax_variables(model, params, stats)), \
            injected():
        trainer = loop.Trainer(config, device="cpu")
        log["miou"] = trainer.fit()
        log["n_tasks"] = trainer.n_tasks
        log["steps_per_task"] = trainer.datamodule.steps_per_epoch()
        log["trainer"] = trainer
    return log


def run_pair(overrides, jax_injected=contextlib.nullcontext,
             port_injected=contextlib.nullcontext):
    ref = jax_trainer_run(overrides, jax_injected)
    return ref, port_trainer_run(overrides, ref["init"], port_injected)


def assert_runs_match(ref, got):
    """Keys, task and step counts; every loss within LOSS_RTOL; every
    task's mIoU on every evaluated task within MIOU_TOL, or TIE_MIOU_TOL
    where that task's test had a tie (its margin printed)."""
    assert got["n_tasks"] == ref["n_tasks"] == 3
    assert tl._keys(got) == tl._keys(ref)
    assert len(got["losses"]) == len(ref["losses"]) == 3 * got["steps_per_task"]
    assert np.isfinite(got["losses"]).all()
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)
    ref_miou, got_miou = tl._miou(ref), tl._miou(got)
    assert got_miou.keys() == ref_miou.keys() and len(ref_miou) == 6
    tied = {t for t, gap in got["margins"].items() if gap < TIE_MARGIN}
    print(f"smallest top-2 logit gap of each task's test: {got['margins']}")
    for k in ref_miou:
        tol = TIE_MIOU_TOL if int(k.split("Task ")[1].split("/")[0]) in tied else MIOU_TOL
        assert abs(got_miou[k] - ref_miou[k]) <= tol, (k, got_miou[k], ref_miou[k])
    tol = TIE_MIOU_TOL if 2 in tied else MIOU_TOL
    assert got["miou"] == pytest.approx(ref["miou"], abs=tol)


@functools.lru_cache(maxsize=None)
def runs(name):
    return run_pair(RUNS[name])


@pytest.mark.parametrize("name", list(RUNS))
def test_trainer_matches_jax(name):
    ref, got = runs(name)
    assert_runs_match(ref, got)
    state = got["trainer"].state
    assert state.prev_model is not None
    if name == "plop":  # begin_task ran inside the loop at tasks 1 and 2
        assert state.plop_thresholds is not None and float(state.plop_max_entropy) > 0
    if name == "sdr":
        assert bool((state.class_proto_counts[:6] > 0).any())
