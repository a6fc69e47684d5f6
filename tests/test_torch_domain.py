"""The domain-incremental scenario against the JAX package, on the CPU.

- ``DomainShiftedSource``: images (each domain's channel permutation, gain
  and bias) and labels bit-equal to JAX's.
- ``DomainScenario``: task count, per-task train and validation indices and
  label tables equal JAX's, for one and two domains a task.
- The Cityscapes ``n_cities`` split (4 cities of a tree written by
  ``scripts/gen_cityscapes_layout.py``, 2 a task) and the synthetic
  ``n_domains`` source (``conf/continual_debug``'s ``synthetic_domain``):
  the DataModule's tasks, train indices, unaugmented train stream and
  eval streams (each task validating on its own 20 % of the train source)
  equal JAX's, the Cityscapes tree decoded natively on both sides and
  with PIL on both sides (both packages' native decoders masked).
- The port's CLI trains ``conf/continual_debug`` with
  ``dataset=synthetic_domain`` on the CPU: 3 domain tasks.
"""

import os
import sys

import numpy as np
import pytest
import torch

from bacs_tpu.config import load_config as jax_load_config
from bacs_tpu.data import continual as jax_continual
from bacs_tpu.data import datamodule as jax_datamodule
from bacs_tpu.data import datasets as jax_datasets
from bacs_tpu.data import native_decode
from bacs_tpu_torch import main as cli
from bacs_tpu_torch.config import load_config
from bacs_tpu_torch.data import continual, datamodule, datasets
from bacs_tpu_torch.utils.logging import Logger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from scripts import gen_cityscapes_layout  # noqa: E402
from torch_port_helpers import _one_thread  # noqa: F401

DEBUG = os.path.join(ROOT, "conf", "continual_debug")


def test_domain_shifted_source_bit_equal():
    domain_ids = [i % 4 for i in range(10)]
    ref = jax_datasets.DomainShiftedSource(jax_datasets.SyntheticSource(10, 24, 6, seed=1),
                                           domain_ids)
    got = datasets.DomainShiftedSource(datasets.SyntheticSource(10, 24, 6, seed=1),
                                       domain_ids)
    assert got.class_names == ref.class_names and len(got) == len(ref)
    for i in range(10):
        (gi, gl), (ri, rl) = got.load(i), ref.load(i)
        assert np.array_equal(gi, ri) and np.array_equal(gl, rl)
        assert np.array_equal(got.load_label(i), ref.load_label(i))
    # the domains differ in appearance, not in labels
    base = datasets.SyntheticSource(10, 24, 6, seed=1)
    assert not np.array_equal(got.load(1)[0], base.load(1)[0])


@pytest.mark.parametrize("per_task,val_fraction", [(1, 0.2), (2, 0.2), (2, 0.5)])
def test_domain_scenario_matches_jax(per_task, val_fraction):
    domain_ids = [int(d) for d in np.random.RandomState(3).randint(0, 5, 40)]
    ref = jax_continual.DomainScenario(domain_ids, 20, per_task, val_fraction, seed=7)
    got = continual.DomainScenario(domain_ids, 20, per_task, val_fraction, seed=7)
    assert got.n_tasks == ref.n_tasks == -(-5 // per_task)
    for t in range(got.n_tasks):
        assert np.array_equal(got.task_indices(t), ref.task_indices(t))
        assert np.array_equal(got.val_indices(t), ref.val_indices(t))
        assert got.n_classes_at(t) == ref.n_classes_at(t) == 20
        for train in (True, False):
            assert np.array_equal(got.label_table(t, train), ref.label_table(t, train))
    # each task's train and validation images are its domains', disjoint
    for t in range(got.n_tasks):
        tr, va = set(got.task_indices(t)), set(got.val_indices(t))
        assert not tr & va and va
        assert {domain_ids[i] for i in tr | va} == got._task_domains(t)


def _streams(dm):
    """Per task: train indices, the unaugmented train stream's images and
    labels, and every eval batch's (n_real, labels, images)."""
    out = []
    for t in range(dm.n_tasks):
        dm.set_task_id(t)
        train = [(np.asarray(b["image"]), np.asarray(b["label"]))
                 for b in dm.train_batches(0, augment=False)]
        evals = [[(b["n_real"], np.asarray(b["label"]), np.asarray(b["image"]))
                  for b in dm.eval_batches(d)] for d in dm.eval_task_range(t)]
        out.append((np.asarray(dm.train_indices()), train, evals))
    return out


def _hold_streams(got, ref):
    assert got.n_tasks == ref.n_tasks and got.domain_shift and ref.domain_shift
    a, b = _streams(got), _streams(ref)
    for (idx1, tr1, ev1), (idx2, tr2, ev2) in zip(a, b):
        assert np.array_equal(idx1, idx2)
        assert len(tr1) == len(tr2)
        for (i1, l1), (i2, l2) in zip(tr1, tr2):
            assert np.array_equal(l1, l2)
            np.testing.assert_allclose(i1, i2, rtol=0, atol=1e-6)
        assert len(ev1) == len(ev2)
        for x, y in zip(ev1, ev2):
            assert len(x) == len(y) and x
            for (n1, l1, i1), (n2, l2, i2) in zip(x, y):
                assert n1 == n2 and np.array_equal(l1, l2)
                np.testing.assert_allclose(i1, i2, rtol=0, atol=1e-6)


@pytest.mark.parametrize("decoder", ["native", "pil"])
def test_cityscapes_city_split_matches_jax(tmp_path, monkeypatch, decoder):
    from bacs_tpu_torch.data import native_decode as port_native_decode

    if decoder == "native":
        assert native_decode.available() and port_native_decode.available()
    else:
        for module in (native_decode, port_native_decode):
            monkeypatch.setattr(module, "_LIB", None)
            monkeypatch.setattr(module, "_TRIED", True)
    root = str(tmp_path)
    gen_cityscapes_layout.generate(root, cities=4, per_city=5, val_cities=1,
                                   val_per_city=2, size=40)
    cfg = {"dataset": {"_target_": "dataloaders.CityscapeDataModule", "dataset": {
               "root": root, "num_classes": 20, "crop_size": 32, "n_cities": 2}},
           "training": {"batch_size": 3, "seed": 42}}
    ref = jax_datamodule.create_datamodule(cfg)
    got = datamodule.create_datamodule(cfg, "cpu")
    # 4 cities // n_cities 2 = 2 cities a task
    assert got.n_tasks == 2 and got.train_scenario.n_per_task == 2
    assert got.train_source.domain_ids == [c for c in range(4) for _ in range(5)]
    _hold_streams(got, ref)


def test_synthetic_domain_datamodule_matches_jax():
    cfg = load_config(DEBUG, "config", ["dataset=synthetic_domain"])
    ref = jax_datamodule.create_datamodule(
        jax_load_config(DEBUG, "config", ["dataset=synthetic_domain"]))
    got = datamodule.create_datamodule(cfg, "cpu")
    assert isinstance(got.train_source, datasets.DomainShiftedSource)
    assert got.n_tasks == 3
    _hold_streams(got, ref)


def test_cli_trains_the_domain_scenario(monkeypatch):
    """The Trainer's tasks are JAX's (every class in every domain task), and
    the CLI trains all three."""
    from bacs_tpu.train import loop as jax_loop
    from bacs_tpu_torch.train import loop

    overrides = ["dataset=synthetic_domain", "network=deep_lab"]
    ref = jax_loop.Trainer(jax_load_config(DEBUG, "config", overrides))
    got = loop.Trainer(load_config(DEBUG, "config", overrides), device="cpu")
    assert got.n_tasks == ref.n_tasks == 3
    for t in range(3):
        g, r = got._task_info(t), ref._task_info(t)
        assert g.domain_shift and r.domain_shift
        for k in ("initial_classes", "increment", "num_classes", "nb_current_classes",
                  "nb_new_classes", "old_classes"):
            assert getattr(g, k) == getattr(r, k), k
    metrics = []
    monkeypatch.setattr(Logger, "log_metrics", lambda self, m: metrics.append(dict(m)))
    miou = cli.main(["--device", "cpu", "--config-path", DEBUG, "--config-name", "config",
                     "dataset=synthetic_domain", "network=deep_lab",
                     "dataset.dataset.crop_size=32"])
    assert np.isfinite(miou)
    keys = {k for m in metrics for k in m}
    assert {f"test.{d}/Task 2/mIoU" for d in range(3)} <= keys
