"""A seed names the same run in both packages: the port's ``Trainer(seed)``
against the JAX ``Trainer(seed)`` over three tasks, on the CPU, with
nothing mocked between them.

The protocol of ``tests/test_torch_loop_methods.py`` (its
``assert_runs_match``): ``conf/continual_debug`` with
DeepLabV3-ResNet-18 at 32^2, ``debug: true`` (2 train steps a task), 6
classes in 3 tasks and the smooth network (every ABN with the identity
activation, patched alike on both sides); every train-step loss within
LOSS_RTOL 1e-4, every task's mIoU on every evaluated task within MIOU_TOL
1e-3, with the tie rule of that file (a task whose test holds a pixel whose
two best logits lie within 1e-4 is held at 1e-2; each run prints its
margins).

Unlike those files, nothing passes from one package to the other: the
port draws its own initial weights (JAX's ``model.init`` for the seed,
``utils/flax_init.py``), its own train augmentation (the crops and flips
of every batch), the detector's dropout masks at rate 0.1, the replay
samples, autocontrast coins, replay crops and ER's partitions, the
buffer's reservoir and eviction uniforms and mixup's Beta draws, each from
JAX's keys (``ops/rng.py``).  A run that took any draw otherwise would part
from JAX at its first step.

The replay batches are 4 (the configs' 2 put the ASPP's global-pool ABN
over two images, ill-conditioned: ``tests/test_torch_loop.py``).
"""

import functools
import json

import numpy as np
import pytest

import bacs_tpu.models as jax_models
import bacs_tpu_torch.models as port_models
import test_torch_loop as tl
import test_torch_loop_methods as lm
from bacs_tpu.config import load_config as jax_load_config
from bacs_tpu.train import loop as jax_loop
from bacs_tpu.utils.logging import Logger as JaxLogger
from bacs_tpu_torch import protocol_compare as pc
from bacs_tpu_torch.config import load_config
from bacs_tpu_torch.train import loop
from bacs_tpu_torch.utils.logging import Logger
from torch_port_helpers import _one_thread  # noqa: F401

REPLAY = ["loss.replay_minibatch_size=4"]
DETECTOR = ["training.bg_detector=true"]
RUNS = {"ce": [],
        "bacs": ["loss=bacs"] + DETECTOR + REPLAY,
        "er": ["loss=er"] + REPLAY,
        "icarl": ["loss=icarl"],
        "bacs_mixup": ["loss=bacs", "+loss.mixup=true"] + DETECTOR + REPLAY}


@functools.lru_cache(maxsize=None)
def jax_run(name):
    """The JAX Trainer on the smooth network, as shipped otherwise."""
    config = jax_load_config(tl.CONF, "config", tl.BASE + RUNS[name])
    log = {}
    with tl._patches("run_smooth", jax_models, JaxLogger, jax_loop, log):
        trainer = jax_loop.Trainer(config)
        log["miou"] = trainer.fit()
        log["n_tasks"] = trainer.n_tasks
    return log


@functools.lru_cache(maxsize=None)
def port_run(name):
    """The port's Trainer on the smooth network, from its own seed."""
    config = load_config(tl.CONF, "config", tl.BASE + RUNS[name])
    log = {"margins": {}}
    with tl._patches("run_smooth", port_models, Logger, loop, log), \
            lm.recording_margins(log["margins"]):
        trainer = loop.Trainer(config, device="cpu")
        log["miou"] = trainer.fit()
        log["n_tasks"] = trainer.n_tasks
        log["steps_per_task"] = trainer.datamodule.steps_per_epoch()
        log["trainer"] = trainer
    return log


@pytest.mark.parametrize("name", list(RUNS))
def test_trainer_seed_matches_jax(name):
    ref, got = jax_run(name), port_run(name)
    lm.assert_runs_match(ref, got)
    trainer = got["trainer"]
    assert trainer.datamodule.crop_size == 32
    if name.startswith("bacs"):
        assert trainer.use_bg_detector
        assert trainer.state.model.seen_fg_network.dropout_rate == 0.1
    if name in ("bacs", "er", "bacs_mixup"):
        assert bool(trainer.state.buffer.valid.any())


def test_pair_reads_the_jax_runner_output(tmp_path, capsys):
    """``protocol_compare --pair PORT JAX`` pairs the port's ``--digest``
    records with ``scripts/protocol_compare.py``'s output (a record per
    method, then the ``## ... (seed N`` line) by (method, seed), both sides
    at JAX's 3 decimals: a port value that rounds to JAX's pairs as equal."""
    port, jax_out = tmp_path / "port.log", tmp_path / "jax.log"
    rows = {"icarl": {42: (0.5012, 0.49), 43: (0.5207, 0.523), 44: (0.4811, 0.47)},
            "ce": {42: (0.03392, 0.034), 43: (0.03388, 0.034), 44: (0.0341, 0.034)}}
    with open(port, "w") as f:
        for m, by_seed in rows.items():
            for seed, (a, _) in by_seed.items():
                f.write(json.dumps(dict(method=m, final_miou=round(a, 3), seed=seed,
                                        final_miou_exact=a, weights_sha256="0")) + "\n")
    with open(jax_out, "w") as f:
        for seed in (42, 43, 44):
            for m, by_seed in rows.items():
                f.write(json.dumps(dict(method=m, final_miou=by_seed[seed][1],
                                        oldest_task_miou=0.1, task0_miou=0.6,
                                        avg_iou_per_dataset=[0.5], seconds=1.0)) + "\n")
            f.write(f"\n## 15-1-flagship protocol (seed {seed}, deeplab/resnet18)\n\n")
            f.write("| Method | final mIoU |\n")
    study = pc.main(["--pair", str(port), str(jax_out)])[0]
    s = study["icarl"]
    assert [r[0] for r in s["rows"]] == [42, 43, 44]
    assert s["mean_diff"] == pytest.approx(np.mean([round(a, 3) - b for a, b in
                                                    rows["icarl"].values()]))
    assert study["ce"]["mean_diff"] == 0 and study["ce"]["wilcoxon_p"] == 1.0
    out = capsys.readouterr().out
    assert "| 43 | 0.5210 | 0.5230 | -0.0020 |" in out
    assert f"## ce: A ({port}) mean 0.0340, B ({jax_out}) mean 0.0340" in out
