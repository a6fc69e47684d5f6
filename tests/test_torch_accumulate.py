"""Gradient accumulation and stage remat in the port, on the CPU.

- Accumulation (``training.accumulate_gradients``) against the JAX chain
  wrapped in ``optax.MultiSteps`` (``bacs_tpu/train/optim.py:154-155``):
  seeded parameters and gradients (some above the clip value 2.0), nesterov
  SGD with weight decay under the poly schedule, six mini-steps at k = 2
  and 3: the parameters and the rate after every mini-step.  The task's
  mini-step count and the schedule's length against the JAX loop's
  formulas; a run stopped between two mini-steps and resumed against the
  whole run; the ``conf/plop`` tree (``accumulate_gradients: 2``) through
  the Trainer.
- Remat (``network.remat``): an RN18 train step with ``remat=true`` and
  ``remat=[3]``, the fused stem on and off, against the same step without
  remat: gradients, updates and running statistics equal (the recompute
  runs the same kernels on the same inputs; the norms update their
  statistics once).  ``stage_remat`` against JAX's.
"""

import functools
import os
import shutil

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from bacs_tpu.config import load_config as jax_load_config
from bacs_tpu.models.resnet import stage_remat as jax_stage_remat
from bacs_tpu.train import loop as jax_loop
from bacs_tpu.train import optim as jax_optim
from bacs_tpu_torch.config import load_config
from bacs_tpu_torch.methods import ModelContext, create_method
from bacs_tpu_torch.models import create_network
from bacs_tpu_torch.models.norm import ABN
from bacs_tpu_torch.models.resnet import stage_remat
from bacs_tpu_torch.train import loop, optim
from bacs_tpu_torch.train.state import TaskInfo, TrainState
from bacs_tpu_torch.train.step import make_steps
from bacs_tpu_torch.utils import checkpoint
from torch_port_helpers import _one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(ROOT, "conf", "continual_debug")
OPT_CFG = {"_target_": "torch.optim.SGD", "lr": 0.01, "momentum": 0.9, "nesterov": True,
           "weight_decay": 1e-4}  # conf/bacs/optimizer/nesterov.yaml


# ---------------------------------------------------------------- accumulation


@pytest.mark.parametrize("k", [2, 3])
def test_accumulation_matches_optax_multisteps(k):
    """Six mini-steps: after each, the parameters within rtol 1e-5 (f32)
    and the rate of the next update equal to the schedule at MultiSteps'
    ``gradient_step``; the parameters move on every k-th mini-step only."""
    rs = np.random.RandomState(9)
    shapes = [(3, 4), (5,), (2, 3, 3)]
    params0 = [rs.randn(*s).astype(np.float32) for s in shapes]
    grads = [[(rs.randn(*s) * 3).astype(np.float32) for s in shapes] for _ in range(6)]
    schedule = jax_optim.poly_schedule(OPT_CFG["lr"], 4)
    tx = jax_optim.make_optimizer(OPT_CFG, schedule, accumulate_steps=k)
    jp = [jnp.asarray(p) for p in params0]
    opt_state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params0]
    opt, sched = optim.make_optimizer(OPT_CFG, tp, optim.poly_schedule(OPT_CFG["lr"], 4),
                                      accumulate_steps=k)
    for i, step_grads in enumerate(grads):
        before = [p.detach().clone() for p in tp]
        updates, opt_state = tx.update([jnp.asarray(g) for g in step_grads], opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(tp, step_grads):
            p.grad = torch.from_numpy(g.copy())
        applied = optim.apply_updates(opt, sched)
        assert applied == ((i + 1) % k == 0)
        for p, b, r in zip(tp, before, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)
            assert torch.equal(p.detach(), b) != applied
        assert opt.param_groups[0]["mini_step"] == int(opt_state.mini_step)
        np.testing.assert_allclose(opt.param_groups[0]["lr"],
                                   float(schedule(opt_state.gradient_step)), rtol=1e-6)


def _config(load, root, extra=()):
    return load(root, "config", ["network=unet", "network.num_layers=3",
                                 "dataset.dataset.crop_size=32", "training.batch_size=2",
                                 "training.debug=false", "dataset.dataset.n_train=12",
                                 *extra])


@pytest.mark.parametrize("k", [2, 3])
def test_mini_steps_and_schedule_match_the_jax_loop(k):
    """Per task, the schedule's length (the optimizer updates,
    ``bacs_tpu/train/loop.py:230-237``) equals the JAX Trainer's, with
    ``training.steps_per_class`` and without; the task runs
    ``_max_iters * k`` mini-steps where its epochs hold as many
    (``bacs_tpu/train/loop.py:444``), and the schedule advances once per
    k of them."""
    extra = [f"+training.accumulate_gradients={k}", "training.epochs=2"]
    for budget in ([], ["+training.steps_per_class=2"]):
        jt = jax_loop.Trainer(_config(jax_load_config, CONF, extra + budget))
        pt = loop.Trainer(_config(load_config, CONF, extra + budget), device="cpu")
        for t in range(pt.n_tasks):
            jt.datamodule.set_task_id(t)
            pt.datamodule.set_task_id(t)
            assert pt._max_iters(pt._task_info(t)) == jt._max_iters(jt._task_info(t))
    calls = []
    make = loop.make_steps

    def counting(*a, **kw):
        train_step, eval_step, put_batch = make(*a, **kw)

        def step(state, batch):
            calls.append(state.scheduler.last_epoch)
            return train_step(state, batch)

        return step, eval_step, put_batch

    pt = loop.Trainer(_config(load_config, CONF, extra), device="cpu")
    loop.make_steps, pt_steps = counting, []
    try:
        for t in range(pt.n_tasks):
            n0 = len(calls)
            pt.per_step_metric.update(pt._run_task(t))
            steps_epoch = pt.datamodule.steps_per_epoch()
            mini = min(pt._max_iters(pt._task_info(t)) * k, steps_epoch * pt.epochs)
            assert len(calls) - n0 == mini, (t, len(calls) - n0, mini)
            assert pt.state.scheduler.last_epoch == mini // k
            pt_steps.append(mini)
    finally:
        loop.make_steps = make
    assert sum(pt_steps) == len(calls)


def test_resume_between_mini_steps_matches_the_whole_run(tmp_path):
    """A run saved after every mini-step (k = 2) and stopped at task 1's
    first save, between its first two mini-steps, resumes from the mean
    gradient and the mini-step count in the checkpoint: every parameter
    and the final metrics equal the uninterrupted run's."""
    extra = ["+training.accumulate_gradients=2", "+training.ckpt_every_steps=1"]
    whole = loop.Trainer(_config(load_config, CONF, extra), device="cpu")
    whole_miou = whole.fit()
    whole_params = [p.detach().clone() for p in whole.state.model.parameters()]
    ckpt_dir = str(tmp_path / "ckpt")
    conf = lambda: _config(load_config, CONF, extra + [f"+training.ckpt_dir={ckpt_dir}"])  # noqa: E731
    saved = []
    try:
        with checkpoint.resume_check_saves(stop_task=1, record=saved), \
                pytest.raises(checkpoint.Interrupted):
            loop.Trainer(conf(), device="cpu").fit()
        assert saved[-1][:2] == (1, "last0")
        with checkpoint.resume_check_saves():
            resumed = loop.Trainer(conf(), device="cpu")
            assert resumed._try_resume() == 1
            group = resumed.state.optimizer.param_groups[0]
            assert group["accumulate_steps"] == 2 and group["mini_step"] == 1
            assert all("grad_acc" in resumed.state.optimizer.state[p]
                       for p in resumed.state.model.parameters())
            resumed = loop.Trainer(conf(), device="cpu")
            miou = resumed.fit()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    for got, ref in zip(resumed.state.model.parameters(), whole_params):
        torch.testing.assert_close(got.detach(), ref, rtol=0, atol=0)
    assert miou == pytest.approx(whole_miou, abs=1e-6)


def test_plop_tree_trains_with_accumulation():
    """``conf/plop`` (``accumulate_gradients: 2``, bf16, PLOP, the MultiHead
    learner) with the synthetic source at 32^2 and RN18: the Trainer
    builds, the optimizer accumulates over 2, task 0 runs its mini-steps
    and updates on every second, and its test loss is finite."""
    config = load_config(os.path.join(ROOT, "conf", "plop"), "config", [
        "dataset._target_=dataloaders.SyntheticDataModule", "dataset.dataset.crop_size=32",
        "+dataset.dataset.n_train=12", "+dataset.dataset.n_val=8",
        "network.backbone=resnet18", "training.epochs=1", "training.batch_size=2",
        "~training.ckpt_dir"])
    trainer = loop.Trainer(config, device="cpu")
    assert trainer.accumulate == 2 and trainer.mixed_precision
    steps = trainer.datamodule.steps_per_epoch()
    results = trainer._run_task(0)
    assert steps >= 2
    assert trainer.state.optimizer.param_groups[0]["accumulate_steps"] == 2
    assert trainer.state.scheduler.last_epoch == steps // 2 and trainer.state.step == steps
    assert np.isfinite(results[0]["test.0/Task 0/loss"])


# ---------------------------------------------------------------- remat


def test_stage_remat_matches_jax():
    for remat in (False, True, (3,), (1, 4), [2], ()):
        for stage in range(1, 5):
            assert stage_remat(remat, stage) == jax_stage_remat(remat, stage), (remat, stage)
    net = create_network("deeplab", 3, backbone="resnet18", remat=[3])
    assert net.backbone.remat_blocks == {"mod4_block1", "mod4_block2"}
    assert len(create_network("deeplab", 3, backbone="resnet18",
                              remat=True).backbone.remat_blocks) == 8
    assert not create_network("deeplab", 3, backbone="resnet18").backbone.remat_blocks


CROP, BATCH, NUM_CLASSES = 32, 4, 5


@functools.lru_cache(maxsize=None)
def remat_run(remat, fused_stem):
    """Two CE train steps of RN18 at 32^2 (seeded weights and batches):
    the gradients of the second, the parameters and running statistics
    after it, and the train-ABN launches of a step."""
    torch.manual_seed(0)
    model = create_network("deeplab", NUM_CLASSES, backbone="resnet18", remat=remat,
                           fused_stem=fused_stem)
    loop.init_weights(model, 3)
    opt, sched = optim.make_optimizer(OPT_CFG, model.parameters(),
                                      optim.poly_schedule(0.01, 10))
    state = TrainState(model, opt, sched)
    task = TaskInfo(task_id=0, initial_classes=NUM_CLASSES, increment=0,
                    num_classes=NUM_CLASSES, n_tasks=1, max_epochs=1)
    train_step, _, put_batch = make_steps(ModelContext(task), create_method("loss.CrossEntropy"),
                                          NUM_CLASSES, device="cpu")
    rs = np.random.RandomState(3)
    calls = []
    for m in model.modules():
        if isinstance(m, ABN):
            m.register_forward_hook(lambda *_: calls.append(1))
    for _ in range(2):
        batch = put_batch({"image": rs.randn(BATCH, CROP, CROP, 3).astype(np.float32),
                           "label": rs.randint(0, NUM_CLASSES, (BATCH, CROP, CROP))
                           .astype(np.int32)})
        n0 = len(calls)
        state, metrics = train_step(state, batch)
    return dict(loss=float(metrics["loss"]),
                grads={k: p.grad.clone() for k, p in model.named_parameters()},
                params={k: p.detach().clone() for k, p in model.named_parameters()},
                buffers={k: b.clone() for k, b in model.named_buffers()},
                abn_calls=len(calls) - n0)


@pytest.mark.parametrize("fused_stem", [False, True], ids=["stem", "fused_stem"])
@pytest.mark.parametrize("remat", [True, (3,)], ids=["all", "stage3"])
def test_remat_step_equals_the_plain_step(remat, fused_stem):
    """The loss, every gradient, parameter and running statistic after two
    steps equal the plain step's to f32 rounding (rtol 1e-6, atol 1e-7 of
    the tensor's largest value); the running statistics update once per
    forward although the remat blocks run their forward twice (the ABN
    calls of a step count the recompute: the 8 blocks of RN18's
    ``remat=true`` hold 19 ABN layers, ``remat=[3]``'s 2 blocks 5)."""
    ref, got = remat_run(False, fused_stem), remat_run(remat, fused_stem)
    assert got["loss"] == pytest.approx(ref["loss"], rel=1e-6)
    for name in ("grads", "params", "buffers"):
        assert got[name].keys() == ref[name].keys()
        for k, r in ref[name].items():
            torch.testing.assert_close(got[name][k], r, rtol=1e-6,
                                       atol=1e-7 * float(r.abs().max()), msg=k)
    assert got["abn_calls"] == ref["abn_calls"] + (19 if remat is True else 5)
