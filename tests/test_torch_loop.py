"""The port's continual trainer against the JAX ``Trainer``, on the CPU.

The protocol: ``conf/continual_debug`` with ``network=deep_lab``
(DeepLabV3-ResNet-18), 32^2 crops, batch 3, ``debug: true`` (6 images per
task, so 2 steps per task under the poly schedule), 6 classes in 3 tasks
(3 + 1 + 1, overlap), one epoch per task.  Both sides' train augmentation
is replaced by the eval transform (the packages' random generators
differ), and the port starts from the JAX package's initial weights
(``utils/flax_weights.py``).  Nothing else in a CE run is random, so every
train step of every task sees the same batch and the same weights up to
the drift of the steps before it.  Each side's run is made once per
process (cached).  Three runs:

- ``ce_fused_stem_smooth``: CE with the fused stem, every ABN with the
  identity activation (leaky slope 1, through the same fused kernels), so
  the network is smooth and the two packages agree to f32 rounding.  This
  run holds what the loop adds on top of ``make_steps``: each task's
  schedule and ``lr_next``, the head surgery, a fresh optimizer per task,
  ``begin_task``/``end_task`` and the step budget.  Every train-step loss
  of the three tasks within SMOOTH_LOSS_RTOL 1e-4 (measured: at most
  8.9e-6), every task's mIoU on every evaluated task within MIOU_TOL 1e-3
  (measured: equal; the values lie between 0.0085 and 0.197).
- ``ce_fused_stem``: the configured network (leaky-ReLU 0.01) with the
  fused stem.  Its first loss agrees to rounding, the later ones drift: a
  pre-activation within rounding of 0 takes different sides of the kink
  in the two packages and moves the updates by a few percent
  (``tests/test_torch_train_step.py``).  Every train-step loss within
  LEAKY_LOSS_RTOL 5e-2 (measured: at most 1.7e-2, at task 2's last step);
  only task 0's mIoU within MIOU_TOL (measured: equal), as the drift moves
  the later tasks' mIoU by up to 0.019 at values from 0.024.
- ``bacs_smooth``: BACS (replay 2 from 8 slots) on the smooth network.
  Only task 0 is held: its losses within SMOOTH_LOSS_RTOL (measured: at
  most 4.7e-6), its mIoU within MIOU_TOL (measured: equal); the replay of
  two images puts the ASPP's global-pool ABN over two images, and the
  whole runs with every draw taken from the seed are
  ``tests/test_torch_seed_runs.py``'s.

All three: the same metric keys (``test.<d>/Task <t>/...``,
``Final/test.<d>/...``), task count and number of train steps.  Batch 3,
not 2: the ASPP's global-pooling ABN normalises over the batch alone, and
over two images the f32 rounding of E[x^2] - mean^2 is amplified into the
head (the smooth run drifts by 5e-3 at batch 2 by task 1's first step).

Also: the command line
``python -m bacs_tpu_torch.main --device cpu --config-path
conf/continual_debug --config-name config network=deep_lab`` finishes and
prints the JAX package's metric keys.
"""

import contextlib
import functools
import os
import re
import subprocess
import sys
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
from bacs_tpu_torch.train import loop
from bacs_tpu_torch.utils.flax_weights import load_flax_variables
from bacs_tpu_torch.utils.logging import Logger
from torch_port_helpers import _one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(ROOT, "conf", "continual_debug")
BASE = ["network=deep_lab", "dataset.dataset.crop_size=32", "training.batch_size=3"]
RUNS = {"ce_fused_stem_smooth": BASE + ["+network.fused_stem=true"],
        "ce_fused_stem": BASE + ["+network.fused_stem=true"],
        "bacs_smooth": BASE + ["loss=bacs"]}
SMOOTH_LOSS_RTOL, LEAKY_LOSS_RTOL, MIOU_TOL = 1e-4, 5e-2, 1e-3


def _patches(name, models_mod, logger_cls, loop_mod, log):
    """Patch one package for a run: record every logged metric dict and
    every train step's loss, and for the smooth run give every ABN the
    identity activation."""
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
    if name.endswith("_smooth"):
        make_norm = models_mod.make_norm
        stack.enter_context(mock.patch.object(
            models_mod, "make_norm",
            lambda *a, **k: functools.partial(make_norm(*a, **k), activation="identity")))
    return stack


@functools.lru_cache(maxsize=None)
def jax_run(name):
    config = jax_load_config(CONF, "config", RUNS[name])
    log = {}
    with _patches(name, jax_models, JaxLogger, jax_loop, log), mock.patch.object(
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
def port_run(name):
    params, stats = jax_run(name)["init"]
    config = load_config(CONF, "config", RUNS[name])
    log = {}
    with _patches(name, port_models, Logger, loop, log), mock.patch.object(
            transforms, "train_transform",
            lambda gen, imgs, lbls, table, crop=512, scale=None:
            transforms.eval_transform(imgs, lbls, table, crop=crop)), mock.patch.object(
            loop, "init_weights", lambda model, seed: load_flax_variables(model, params, stats)):
        trainer = loop.Trainer(config, device="cpu")
        log["miou"] = trainer.fit()
        log["n_tasks"] = trainer.n_tasks
        log["task_seconds"] = trainer.task_seconds
        log["steps_per_task"] = trainer.datamodule.steps_per_epoch()
    return log


def _keys(log):
    return sorted(k for m in log["metrics"] for k in m)


def _miou(log):
    return {k: v for m in log["metrics"] for k, v in m.items()
            if re.fullmatch(r"test\.\d+/Task \d+/mIoU", k)}


@pytest.mark.parametrize("name", list(RUNS))
def test_trainer_matches_jax(name):
    ref, got = jax_run(name), port_run(name)
    assert got["n_tasks"] == ref["n_tasks"] == 3 and len(got["task_seconds"]) == 3
    assert _keys(got) == _keys(ref)
    assert len(got["losses"]) == len(ref["losses"]) == 3 * got["steps_per_task"] == 6
    ref_miou, got_miou = _miou(ref), _miou(got)
    assert got_miou.keys() == ref_miou.keys()
    # bacs: task 0 only (see the docstring)
    n = len(got["losses"]) if name.startswith("ce") else got["steps_per_task"]
    rtol = SMOOTH_LOSS_RTOL if name.endswith("_smooth") else LEAKY_LOSS_RTOL
    np.testing.assert_allclose(got["losses"][:n], ref["losses"][:n], rtol=rtol)
    held = list(ref_miou) if name == "ce_fused_stem_smooth" else ["test.0/Task 0/mIoU"]
    for k in held:
        assert abs(got_miou[k] - ref_miou[k]) <= MIOU_TOL, (k, got_miou[k], ref_miou[k])
    assert np.isfinite(got["miou"])


def test_cli_on_the_cpu_prints_the_jax_metric_keys():
    """The command line as a user runs it, in a fresh process: it finishes,
    prints the JAX package's metric keys and the final mIoU, and imports
    nothing of JAX or of the JAX package."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['bacs_tpu_torch.main', '--device', 'cpu', '--config-path', %r,\n"
        "            '--config-name', 'config', 'network=deep_lab']\n"
        "runpy.run_module('bacs_tpu_torch.main', run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'bacs_tpu'))\n"
        "assert not bad, bad\n" % CONF)
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    out = run.stdout
    assert re.search(r"^final mIoU: \d\.\d{4}$", out, re.M)
    keys = {k for line in out.splitlines() for k in re.findall(r'"([^"]+)":', line)}
    # the logger prints the per-class IoUs only as IoU-Old and IoU-New
    printed = {k for k in _keys(jax_run("ce_fused_stem"))
               if "/IoU-" not in k or "/IoU-Old" in k or "/IoU-New" in k}
    assert keys == printed


def test_trainer_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = load_config(CONF, "config", BASE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.Trainer(config)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main.main(["--config-path", CONF, "--config-name", "config", "network=deep_lab"])


# each option, and the ROADMAP item that ported it
@pytest.mark.parametrize("override, item", [
    ("+training.log_prototypes=true", "item 14"),
    ("+training.log_images=true", "item 14"),
    ("+training.log_drift=true", "item 14"),
])
def test_unported_options_raise(override, item, tmp_path, monkeypatch):
    """The options that raised until they were ported now train and do
    their part: the collages and prototype plots of each task under
    ``training.media_dir``, the drift logged in the later tasks (held to
    JAX in ``tests/test_torch_ood_viz.py``).  UNet and
    ``accumulate_gradients`` train (``tests/test_torch_unet_loop.py``,
    ``tests/test_torch_accumulate.py``)."""
    metrics = []
    monkeypatch.setattr(Logger, "log_metrics", lambda self, m: metrics.append(dict(m)))
    config = load_config(CONF, "config", BASE + [
        override, f"+training.media_dir={tmp_path}", "+training.drift_measure_every=1"])
    loop.Trainer(config, device="cpu").fit()
    written = sorted(os.listdir(tmp_path)) if os.path.isdir(tmp_path) else []
    drift = [m["representation_drift"] for m in metrics if "representation_drift" in m]
    if "prototypes" in override:
        assert written == sorted(f"{k}_task{t}.png" for t in range(3)
                                 for k in ("proto_dist", "tsne")), written
    elif "images" in override:
        assert written == [f"task{t}_test.png" for t in range(3)], written
    else:  # two train steps in each of tasks 1 and 2
        assert not written and len(drift) == 4 and all(np.isfinite(drift)), drift
