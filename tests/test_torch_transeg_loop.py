"""The port's continual trainer on TranSeg against the JAX ``Trainer``, and
``conf/experiments/bacs_transformer_config`` through the port's command
line, on the CPU.

The Trainer: ``conf/continual_debug`` (CE, 6 classes in 3 tasks of 3 + 1 +
1, overlap, one epoch a task, ``debug: true``: 6 images a task) with the
network swapped for TranSeg on a ResNet-18 at 32^2 (hidden 32, 4 heads, 2
layers, feed-forward 64), batch 3, the ``TransformerLearner`` with the
``mean`` token growth of ``der_15_1_transformer.yaml``.  Every ABN has the
identity activation on both sides (``make_norm`` patched, as
``tests/test_torch_loop.py``'s smooth runs), both sides' train augmentation
is the eval transform (the packages' generators differ) and the port
starts from the JAX package's initial weights (``utils/flax_weights.py``).
Each side's run is made once per process.

Tolerances.  The network is smooth, so every train-step loss of every task
holds to LOSS_RTOL 1e-4 and every task's mIoU on every evaluated task to
MIOU_TOL 1e-3, as ``tests/test_torch_loop.py``'s smooth CE run (measured:
losses within 2e-6, mIoUs equal).  A dropped token growth, a growth of
another mode, a class count left at the old task's or a fresh optimizer
state each moves the losses of tasks 1 and 2 by far more.
"""

import contextlib
import functools
import os
import re
from unittest import mock

import numpy as np
import pytest
import torch

import jax

import bacs_tpu.models as jax_models
import bacs_tpu_torch.models as port_models
from bacs_tpu.config import load_config as jax_load_config
from bacs_tpu.data import transforms as jax_transforms
from bacs_tpu.train import loop as jax_loop
from bacs_tpu.utils.logging import Logger as JaxLogger
from bacs_tpu_torch import main as port_main
from bacs_tpu_torch.config import load_config
from bacs_tpu_torch.data import transforms
from bacs_tpu_torch.models.transeg import TranSeg
from bacs_tpu_torch.train import loop
from bacs_tpu_torch.utils.flax_weights import load_flax_variables
from bacs_tpu_torch.utils.logging import Logger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(ROOT, "conf", "continual_debug")
TR = ["+network.transformer.hidden_dim=32", "+network.transformer.nhead=4",
      "+network.transformer.num_decoder_layers=2", "+network.transformer.dim_feedforward=64"]
BASE = (["network=deep_lab", "network._target_=networks.TranSeg",
         "dataset.dataset.crop_size=32", "training.batch_size=3",
         "training.learner._target_=learner.TransformerLearner",
         "+training.new_token_init=mean"] + TR)
# conf/experiments/bacs_transformer_config cut to the CPU: the synthetic
# source at 32^2, 60 / 36 images, RN18, the head above, batch 2, 8 slots
CLI = (["--device", "cpu", "--config-path", os.path.join(ROOT, "conf", "experiments"),
        "--config-name", "bacs_transformer_config",
        "dataset._target_=dataloaders.SyntheticDataModule", "dataset.dataset.crop_size=32",
        "+dataset.dataset.n_train=60", "+dataset.dataset.n_val=36",
        "+training.steps_per_class=1", "training.epochs=1", "~training.ckpt_dir",
        "network.backbone=resnet18", "training.batch_size=2", "loss.buffer_size=8",
        "loss.replay_minibatch_size=2"]
       + [o.lstrip("+") for o in TR])
LOSS_RTOL, MIOU_TOL = 1e-4, 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one intra-op thread (``tests/test_torch_accumulate.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _patches(models_mod, logger_cls, loop_mod, log):
    """Record every logged metric dict and every train step's loss; every
    ABN with the identity activation."""
    stack = contextlib.ExitStack()
    log["metrics"], log["losses"] = [], []
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
    make_norm = models_mod.make_norm
    stack.enter_context(mock.patch.object(
        models_mod, "make_norm",
        lambda *a, **k: functools.partial(make_norm(*a, **k), activation="identity")))
    return stack


@functools.lru_cache(maxsize=None)
def jax_run():
    config = jax_load_config(CONF, "config", BASE)
    log = {}
    with _patches(jax_models, JaxLogger, jax_loop, log), mock.patch.object(
            jax_transforms, "train_transform",
            lambda rng, imgs, lbls, table, crop=512, scale=None:
            jax_transforms.eval_transform(imgs, lbls, table, crop=crop)):
        trainer = jax_loop.Trainer(config)
        task = trainer._task_info(0)
        init = trainer._init_state(trainer._make_model(task), trainer._make_tx(task), task)
        log["init"] = (jax.tree.map(np.asarray, init.params),
                       jax.tree.map(np.asarray, init.batch_stats))
        log["miou"] = trainer.fit()
        log["n_tasks"] = trainer.n_tasks
        log["tokens"] = np.asarray(trainer.state.params["base_classifier"]["class_tokens"])
    return log


@functools.lru_cache(maxsize=None)
def port_run():
    params, stats = jax_run()["init"]
    config = load_config(CONF, "config", BASE)
    log = {}
    with _patches(port_models, Logger, loop, log), mock.patch.object(
            transforms, "train_transform",
            lambda gen, imgs, lbls, table, crop=512, scale=None:
            transforms.eval_transform(imgs, lbls, table, crop=crop)), mock.patch.object(
            loop, "init_weights", lambda model, seed: load_flax_variables(model, params, stats)):
        trainer = loop.Trainer(config, device="cpu")
        log["miou"] = trainer.fit()
        log["n_tasks"] = trainer.n_tasks
        log["model"] = trainer.state.model
        log["steps_per_task"] = trainer.datamodule.steps_per_epoch()
    return log


def _keys(log):
    return sorted(k for m in log["metrics"] for k in m)


def _miou(log):
    return {k: v for m in log["metrics"] for k, v in m.items()
            if re.fullmatch(r"test\.\d+/Task \d+/mIoU", k)}


def test_transeg_trainer_matches_jax():
    """The same keys, tasks and step count; every loss within LOSS_RTOL,
    every mIoU within MIOU_TOL; the class tokens after the three tasks (two
    ``mean`` growths and the training) to 1e-4 of their largest value."""
    ref, got = jax_run(), port_run()
    assert got["n_tasks"] == ref["n_tasks"] == 3
    model = got["model"]
    assert isinstance(model, TranSeg) and model.active_classes == 6
    assert _keys(got) == _keys(ref)
    assert len(got["losses"]) == len(ref["losses"]) == 3 * got["steps_per_task"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)
    ref_miou, got_miou = _miou(ref), _miou(got)
    assert got_miou.keys() == ref_miou.keys() and len(ref_miou) == 6
    for k, v in ref_miou.items():
        assert abs(got_miou[k] - v) <= MIOU_TOL, (k, got_miou[k], v)
    tokens = model.base_classifier.class_tokens.detach().numpy()
    np.testing.assert_allclose(tokens, ref["tokens"], rtol=0,
                               atol=1e-4 * np.abs(ref["tokens"]).max())


def test_cli_trains_bacs_transformer_config(capsys, monkeypatch):
    """``python -m bacs_tpu_torch.main --device cpu --config-path
    conf/experiments --config-name bacs_transformer_config`` with the
    synthetic source and a CPU-sized network, in this process: TranSeg
    with the ``mean`` growth, BACS+ with the detector, all 6 tasks
    (the network config's null ``crop_size`` and ``num_classes`` and the
    absent backbone file notwithstanding); the final mIoU printed."""
    monkeypatch.chdir(ROOT)
    trainers = []
    Trainer = loop.Trainer

    class Recorded(Trainer):
        def fit(self):
            trainers.append(self)
            return super().fit()

    with mock.patch.object(loop, "Trainer", Recorded):
        miou = port_main.main(CLI)
    out = capsys.readouterr().out
    assert re.search(r"^final mIoU: \d\.\d{4}$", out, re.M) and np.isfinite(miou)
    (tr,) = trainers
    assert tr.n_tasks == 6 and tr.use_bg_detector and tr.new_token_init == "mean"
    assert tr.learner_init is loop.transformer_init and tr.mixed_precision
    model = tr.state.model
    assert isinstance(model, TranSeg) and model.active_classes == 21
    assert tr.state.prev_model.active_classes == 21
    assert model.base_classifier.pos_embed.shape == (1, 2, 2, 32)
    assert '"test.5/Task 5/mIoU"' in out
