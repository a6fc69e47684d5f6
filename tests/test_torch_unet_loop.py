"""The port's continual trainer on UNet against the JAX ``Trainer``, and the
port's command line on the shipped UNet trees, on the CPU.

The protocol: ``conf/continual_debug`` as shipped (UNet, CE, 6 classes in
3 tasks of 3 + 1 + 1, overlap, one epoch a task, ``debug: true``: 6
images a task) cut to UNet-3 at 32^2, batch 3.  Both sides' train
augmentation is replaced by the eval transform (the packages' generators
differ) and the port starts from the JAX package's initial weights
(``utils/flax_weights.py``), as ``tests/test_torch_loop.py`` does for
DeepLabV3.  Each side's run is made once per process.

Tolerances.  Every train-step loss of every task within LOSS_RTOL 1e-3
and every task's mIoU on every evaluated task within MIOU_TOL 1e-3.  The
first loss agrees to f32 rounding; the later ones pass ReLU and max-pool
kinks (``tests/test_torch_unet.py``: a pre-activation or a window's top
two within rounding may take another branch, and the batch norm's
backward spreads that pixel over its channel), which move the updates by
about 1e-3 of their size (``tests/test_torch_unet_steps.py``) and the
next losses by less (measured: at most 1.7e-5 over the 6 losses of the
three tasks; the mIoUs, 0.027-0.083, within 4.8e-5).
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

from bacs_tpu.config import load_config as jax_load_config
from bacs_tpu.data import transforms as jax_transforms
from bacs_tpu.train import loop as jax_loop
from bacs_tpu.utils.logging import Logger as JaxLogger
from bacs_tpu_torch import main as port_main
from bacs_tpu_torch import protocol_compare
from bacs_tpu_torch.config import load_config
from bacs_tpu_torch.data import transforms
from bacs_tpu_torch.train import loop
from bacs_tpu_torch.utils.flax_weights import load_flax_variables
from bacs_tpu_torch.utils.logging import Logger
from torch_port_helpers import _one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(ROOT, "conf", "continual_debug")
JOINT = os.path.join(ROOT, "conf", "joint_debug")
BASE = ["network.num_layers=3", "dataset.dataset.crop_size=32", "training.batch_size=3"]
LOSS_RTOL, MIOU_TOL = 1e-3, 1e-3


def _patches(logger_cls, loop_mod, log):
    """Record every logged metric dict and every train step's loss."""
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
    return stack


@functools.lru_cache(maxsize=None)
def jax_run(conf=CONF, overrides=tuple(BASE)):
    config = jax_load_config(conf, "config", list(overrides))
    log = {}
    with _patches(JaxLogger, jax_loop, log), mock.patch.object(
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
    return log


@functools.lru_cache(maxsize=None)
def port_run():
    params, stats = jax_run()["init"]
    config = load_config(CONF, "config", BASE)
    log = {}
    with _patches(Logger, loop, log), mock.patch.object(
            transforms, "train_transform",
            lambda gen, imgs, lbls, table, crop=512, scale=None:
            transforms.eval_transform(imgs, lbls, table, crop=crop)), mock.patch.object(
            loop, "init_weights", lambda model, seed: load_flax_variables(model, params, stats)):
        trainer = loop.Trainer(config, device="cpu")
        log["miou"] = trainer.fit()
        log["n_tasks"] = trainer.n_tasks
    return log


def _keys(log):
    return sorted(k for m in log["metrics"] for k in m)


def _miou(log):
    return {k: v for m in log["metrics"] for k, v in m.items()
            if re.fullmatch(r"test\.\d+/Task \d+/mIoU", k)}


def test_unet_trainer_matches_jax():
    """The same keys, tasks and step count; every loss within LOSS_RTOL,
    every mIoU within MIOU_TOL."""
    ref, got = jax_run(), port_run()
    assert got["n_tasks"] == ref["n_tasks"] == 3
    assert _keys(got) == _keys(ref)
    assert len(got["losses"]) == len(ref["losses"]) > 3
    np.testing.assert_allclose(got["losses"][0], ref["losses"][0], rtol=1e-5)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)
    ref_miou, got_miou = _miou(ref), _miou(got)
    assert got_miou.keys() == ref_miou.keys() and len(ref_miou) == 6
    for k, v in ref_miou.items():
        assert abs(got_miou[k] - v) <= MIOU_TOL, (k, got_miou[k], v)
    assert abs(got["miou"] - ref["miou"]) <= MIOU_TOL


def _cli_keys(capsys, extra=()):
    """The port's command line (``bacs_tpu_torch.main.main``) run in this
    process: (printed metric keys, final mIoU line found)."""
    port_main.main(["--device", "cpu", *extra])
    out = capsys.readouterr().out
    keys = {k for line in out.splitlines() for k in re.findall(r'"([^"]+)":', line)}
    return keys, bool(re.search(r"^final mIoU: \d\.\d{4}$", out, re.M))


def _printed(keys):
    # the logger prints the per-class IoUs only as IoU-Old and IoU-New
    return {k for k in keys if "/IoU-" not in k or "/IoU-Old" in k or "/IoU-New" in k}


@pytest.mark.parametrize("tree", ["joint_debug", "continual_debug"])
def test_cli_trains_the_shipped_unet_trees(tree, capsys, monkeypatch):
    """``python -m bacs_tpu_torch.main --device cpu`` with no override
    (``conf/joint_debug``, the default tree: UNet-4, 64^2, two epochs) and
    on ``conf/continual_debug`` as shipped, in this process from the repo
    root (``tests/test_torch_loop.py`` runs the command line in a fresh
    process and checks that it imports no JAX): it finishes, prints the
    final mIoU and the JAX package's metric keys (the JAX Trainer's on the
    same tree at UNet-3 32^2: the keys depend on the tasks and classes
    only)."""
    monkeypatch.chdir(ROOT)
    extra = [] if tree == "joint_debug" else ["--config-path", CONF]
    keys, final = _cli_keys(capsys, extra)
    assert final
    conf = JOINT if tree == "joint_debug" else CONF
    assert keys == _printed(_keys(jax_run(conf, tuple(BASE))))


@pytest.mark.parametrize("name", sorted(protocol_compare.PROTOCOLS))
def test_every_protocol_builds_its_trainer(name):
    """Every protocol's Trainer builds on the CPU at a cut size (crop 32 or
    64, 24 / 16 images, RN18 for the DeepLab ones) with its own network,
    method overrides and options, ``15-1-paper``'s remat and uint8 buffer
    included, and its network runs a train forward and backward."""
    p = dict(protocol_compare.PROTOCOLS[name], n_train=24, n_val=16)
    network = p.get("net", "unet")
    method = "bacs_plus" if name == "15-1-paper" else p["default_methods"][-1]
    overrides = protocol_compare.method_overrides(
        p, method, 42, network=network, backbone="resnet18",
        crop=64 if network == "deeplab" else 32)
    config = load_config(CONF, "config", overrides)
    trainer = loop.Trainer(config, device="cpu")
    state = trainer._init_state(trainer._task_info(0))
    if name == "15-1-paper":
        assert state.model.backbone.remat_blocks and trainer.mixed_precision
        assert state.buffer.images.dtype == torch.uint8
    crop = trainer.datamodule.crop_size
    out = state.model.train()(torch.zeros(2, crop, crop, 3))
    out.sem_logits.float().sum().backward()
    assert out.sem_logits.shape[-1] == p["n_classes"]
