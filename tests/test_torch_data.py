"""The port's config loader, data pipeline and metrics against the JAX
package, on the CPU.

- ``load_config`` gives the JAX loader's dict for every shipped root config,
  and for one override of each kind.
- Scenarios, class sets, label tables and the debug and sweep subsets equal
  JAX's; ``SyntheticSource`` images and labels are bit-equal in both styles
  and with the era options.
- ``eval_transform`` matches (same size exactly; a resize to f32 rounding
  of the interpolation weights, 1e-3 of the 0-255 range); ``train_transform``
  matches given the same crop parameters (JAX's ``_resize_region`` takes
  them explicitly): images to 1e-5 of their range, labels equal.
- The DataModule's per-epoch index batches equal JAX's for tasks 0..2 and
  two epochs, and so do the eval batches' indices and real counts.
- ``detailed_iou_metrics`` and ``PerStepResult`` equal JAX's on random
  confusion matrices (float equality up to 1e-6).
"""

import glob
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bacs_tpu.config import load_config as jax_load_config
from bacs_tpu.data import continual as jax_continual
from bacs_tpu.data import datamodule as jax_datamodule
from bacs_tpu.data import datasets as jax_datasets
from bacs_tpu.data import transforms as jax_transforms
from bacs_tpu.train import metrics as jax_metrics
from bacs_tpu_torch.ops import rng
from bacs_tpu_torch.config import load_config
from bacs_tpu_torch.data import continual, datamodule, datasets, transforms
from bacs_tpu_torch.train import metrics
from torch_port_helpers import _one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT_CONFIGS = sorted(
    glob.glob(os.path.join(ROOT, "conf", "*", "config.yaml"))
    + glob.glob(os.path.join(ROOT, "conf", "experiments", "*.yaml"))
    + [os.path.join(ROOT, "conf", "bacs", "bacs_plus_config.yaml")])
OVERRIDES = ["training=der_15_1_bg", "loss=bacs_plus_bg", "training.batch_size=4",
             "+network.fused_stem=true", "~training.ckpt_dir", "seed_note=7"]


@pytest.mark.parametrize("path", ROOT_CONFIGS, ids=lambda p: os.path.relpath(p, ROOT))
def test_load_config_matches_jax(path):
    cdir, name = os.path.dirname(path), os.path.splitext(os.path.basename(path))[0]
    assert load_config(cdir, name).to_dict() == jax_load_config(cdir, name).to_dict()


def test_overrides_of_each_kind_match_jax():
    cdir = os.path.join(ROOT, "conf", "bacs")
    got = load_config(cdir, "bacs_plus_config", OVERRIDES)
    assert got.to_dict() == jax_load_config(cdir, "bacs_plus_config", OVERRIDES).to_dict()
    assert got.network.fused_stem is True and got.training.batch_size == 4
    assert got.loss.bg_weighted_ce and "ckpt_dir" not in got.training and got.seed_note == 7
    with pytest.raises(KeyError, match="use \\+"):
        load_config(cdir, "bacs_plus_config", ["training.not_a_key=1"])


# ---------------------------------------------------------------- sources


@pytest.mark.parametrize("kw", [
    dict(style="flat"), dict(style="rich"),
    dict(style="rich", cooccur=0.5, cooccur_initial=3, cooccur_increment=1),
    dict(style="rich", cooccur=0.0, bg_drift=True, cooccur_initial=3, cooccur_increment=1),
], ids=["flat", "rich", "cooccur", "bg_drift"])
def test_synthetic_source_is_bit_equal(kw):
    ref = jax_datasets.SyntheticSource(5, 48, 6, seed=3, **kw)
    got = datasets.SyntheticSource(5, 48, 6, seed=3, **kw)
    assert got.class_names == ref.class_names and len(got) == len(ref)
    for i in range(len(ref)):
        for a, b in zip(got.load(i), ref.load(i)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_class_sets_scenarios_tables_and_subsets_match_jax():
    src = jax_datasets.SyntheticSource(40, 32, 21, seed=1)
    labels = [src.load_label(i) for i in range(len(src))]
    ref_sets = jax_continual.compute_class_sets(labels)
    got_sets = continual.compute_class_sets(labels)
    assert all(np.array_equal(a, b) for a, b in zip(got_sets, ref_sets))
    order = continual.shuffle_class_order(21, 42)
    assert order == jax_continual.shuffle_class_order(21, 42)
    for mode in ("overlap", "disjoint", "sequential"):
        for class_order in (None, order):
            ref = jax_continual.ContinualScenario(ref_sets, 15, 1, 21, mode=mode,
                                                  class_order=class_order)
            got = continual.ContinualScenario(got_sets, 15, 1, 21, mode=mode,
                                              class_order=class_order)
            assert got.n_tasks == ref.n_tasks == 6
            for t in range(6):
                assert np.array_equal(got.task_indices(t), ref.task_indices(t))
                assert got.n_classes_at(t) == ref.n_classes_at(t)
                for train in (True, False):
                    assert np.array_equal(got.label_table(t, train), ref.label_table(t, train))
    # the domain-incremental scenario is ported (tests/test_torch_domain.py)
    got, ref = continual.DomainScenario([0, 1], 6), jax_continual.DomainScenario([0, 1], 6)
    assert got.n_tasks == ref.n_tasks == 2
    assert np.array_equal(got.val_indices(1), ref.val_indices(1))


def _modules(debug=False, sweep=False, batch_size=4):
    kw = dict(num_classes=6, crop_size=16, batch_size=batch_size, initial_increment=3,
              increment=1, mode="overlap", seed=42, debug=debug, sweep=sweep)
    ref = jax_datamodule.DataModule(jax_datasets.SyntheticSource(30, 16, 6, seed=1),
                                    jax_datasets.SyntheticSource(11, 16, 6, seed=2), **kw)
    got = datamodule.DataModule(datasets.SyntheticSource(30, 16, 6, seed=1),
                                datasets.SyntheticSource(11, 16, 6, seed=2), device="cpu", **kw)
    return ref, got


def _jax_index_batches(dm, monkeypatch, stream):
    """The index batches the JAX DataModule decodes, and what it yields."""
    seen = []

    def host_stream(self, source, index_batches):
        seen.extend(np.asarray(b) for b in index_batches)
        s = self.crop_size
        return ((np.zeros((len(b), s, s, 3), np.uint8), np.zeros((len(b), s, s), np.uint8))
                for b in index_batches)

    monkeypatch.setattr(jax_datamodule.DataModule, "_host_stream", host_stream)
    out = list(stream())
    return seen, out


@pytest.mark.parametrize("subset", ["full", "debug", "sweep"])
def test_datamodule_index_batches_match_jax(subset, monkeypatch):
    ref, got = _modules(debug=subset == "debug", sweep=subset == "sweep")
    assert got.n_tasks == ref.n_tasks == 3 and got.continual == ref.continual
    for t in range(3):
        ref.set_task_id(t)
        got.set_task_id(t)
        assert np.array_equal(got.train_indices(), ref.train_indices())
        assert got.steps_per_epoch() == ref.steps_per_epoch()
        for epoch in range(2):
            seen, _ = _jax_index_batches(ref, monkeypatch,
                                         lambda: ref.train_batches(epoch, augment=False))
            batches, _, _ = got.train_index_batches(epoch)
            assert len(batches) == len(seen)
            assert all(np.array_equal(a, b) for a, b in zip(batches, seen))
        for d in range(t + 1):
            seen, out = _jax_index_batches(ref, monkeypatch, lambda: ref.eval_batches(d))
            batches, n_reals, table = got.eval_index_batches(d)
            assert all(np.array_equal(a, b) for a, b in zip(batches, seen))
            assert n_reals == [o["n_real"] for o in out]
            assert np.array_equal(table, ref.val_scenario.label_table(t, train=False))


def test_datamodule_streams_on_the_cpu():
    """The port's streams decode, pad and remap as JAX's: eval batches of the
    same images and labels (padding ignored), unaugmented train batches
    too, and augmented ones of the same shapes."""
    ref, got = _modules(batch_size=4)
    ref.set_task_id(1)
    got.set_task_id(1)
    for a, b in zip(got.eval_batches(0), ref.eval_batches(0)):
        assert a["n_real"] == b["n_real"]
        assert np.array_equal(a["label"].numpy(), np.asarray(b["label"]))
        np.testing.assert_allclose(a["image"].numpy(), np.asarray(b["image"]), rtol=0,
                                   atol=1e-6)
    for a, b in zip(got.train_batches(0, augment=False), ref.train_batches(0, augment=False)):
        assert np.array_equal(a["label"].numpy(), np.asarray(b["label"]))
    batch = next(iter(got.train_batches(1)))
    assert batch["image"].shape == (4, 16, 16, 3) and batch["label"].dtype == torch.int32


def test_device_cache_and_unported_sources():
    src = datasets.SyntheticSource(4, 16, 6, seed=1)
    cache = datasets.DeviceCache(src, "cpu")
    imgs, lbls = cache.load_batch([2, 0])
    assert np.array_equal(imgs[0].numpy(), src.load(2)[0])
    assert np.array_equal(lbls[1].numpy(), src.load(0)[1])
    ram = datasets.DecodedCache(src)
    assert np.array_equal(ram.load(3)[0], src.load(3)[0])
    # ADE20K and Cityscapes are ported: a missing root raises as in JAX
    # (their trees: tests/test_torch_folder_sources.py)
    for target in ("dataloaders.AdeDataModule", "dataloaders.CityscapesDataModule"):
        cfg = {"dataset": {"_target_": target, "dataset": {"root": "/nonexistent"}},
               "training": {}}
        with pytest.raises(FileNotFoundError, match="not found"):
            datamodule.create_datamodule(cfg, "cpu")
        with pytest.raises(FileNotFoundError, match="not found"):
            jax_datamodule.create_datamodule(cfg)
    # and so is the domain-shifted synthetic source
    cfg = {"dataset": {"dataset": {"n_domains": 2, "crop_size": 16}}, "training": {}}
    got, ref = datamodule.create_datamodule(cfg, "cpu"), jax_datamodule.create_datamodule(cfg)
    assert got.domain_shift and got.n_tasks == ref.n_tasks == 2
    assert isinstance(got.train_source, datasets.DomainShiftedSource)


# ---------------------------------------------------------------- transforms


@pytest.mark.parametrize("size", [16, 24, 10])
def test_eval_transform_matches_jax(size):
    rs = np.random.RandomState(0)
    imgs = rs.randint(0, 256, (2, size, size, 3)).astype(np.uint8)
    lbls = rs.randint(0, 6, (2, size, size)).astype(np.uint8)
    lbls[0, :3] = 255
    table = np.concatenate([np.arange(6), np.zeros(249), [255]]).astype(np.int32)
    table[4] = 0
    ref = jax_transforms.eval_transform(jnp.asarray(imgs), jnp.asarray(lbls),
                                        jnp.asarray(table), crop=16)
    got = transforms.eval_transform(torch.from_numpy(imgs), torch.from_numpy(lbls),
                                    torch.from_numpy(table), crop=16)
    assert np.array_equal(got["label"].numpy(), np.asarray(ref["label"]))
    # 1e-3 of the pixel range, in normalized units (the smallest std 0.225)
    tol = 1e-6 if size == 16 else 1e-3 / 0.225
    np.testing.assert_allclose(got["image"].numpy(), np.asarray(ref["image"]), rtol=0,
                               atol=tol)


def test_train_transform_matches_jax_given_the_crop_parameters(monkeypatch):
    rs = np.random.RandomState(1)
    imgs = rs.randint(0, 256, (3, 20, 20, 3)).astype(np.uint8)
    lbls = rs.randint(0, 6, (3, 20, 20)).astype(np.uint8)
    table = np.concatenate([np.arange(6), np.full(250, 255)]).astype(np.int32)
    params = transforms.sample_crop_params(3, (20, 20), rng.key(5))
    params["flip"] = torch.tensor([True, False, True])
    monkeypatch.setattr(transforms, "sample_crop_params", lambda *a, **k: params)
    got = transforms.train_transform(None, torch.from_numpy(imgs), torch.from_numpy(lbls),
                                     torch.from_numpy(table), crop=16)
    ref_img, ref_lbl = [], []
    for k in range(3):
        region = [jnp.asarray(params[n][k].item(), jnp.float32) for n in ("i", "j", "ch", "cw")]
        im = jax_transforms._resize_region(jnp.asarray(imgs[k]), *region, 16, "bilinear")
        lb = jax_transforms._resize_region(jnp.asarray(lbls[k]), *region, 16, "nearest")
        if bool(params["flip"][k]):
            im, lb = im[:, ::-1], lb[:, ::-1]
        ref_img.append(np.asarray(jax_transforms.normalize_image(im)))
        ref_lbl.append(np.asarray(jax_transforms.remap_labels(lb, jnp.asarray(table))))
    assert np.array_equal(got["label"].numpy(), np.stack(ref_lbl))
    np.testing.assert_allclose(got["image"].numpy(), np.stack(ref_img), rtol=0, atol=1e-5)


# ---------------------------------------------------------------- metrics


def test_metrics_match_jax():
    rs = np.random.RandomState(0)
    for trial in range(3):
        conf = rs.randint(0, 50, (8, 8)).astype(np.int64)
        conf[rs.rand(8) < 0.3] = 0  # absent classes: 0/0 ratios
        for init, cur in ((4, 6), (8, 8), (1, 5)):
            names = [f"c{i}" for i in range(8)] if trial == 0 else None
            ref = jax_metrics.detailed_iou_metrics(conf, init, cur, names)
            got = metrics.detailed_iou_metrics(conf, init, cur, names)
            assert got.keys() == ref.keys()
            for k in ref:
                assert abs(got[k] - ref[k]) <= 1e-6, (k, got[k], ref[k])
    for continual_ in (True, False):
        ref, got = jax_metrics.PerStepResult(continual_), metrics.PerStepResult(continual_)
        for t in range(3):
            results = [{(f"test.{d}/Task {t}/" if continual_ else f"test.{d}/") + m:
                        float(rs.rand()) for m in ("mIoU", "IoU-Old", "IoU-New")}
                       for d in range(t + 1)]
            ref.update(results)
            got.update(results)
        r, g = ref.compute(), got.compute()
        assert r.keys() == g.keys()
        for k in r:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(r[k]))
        np.testing.assert_equal(got.final_miou, ref.final_miou)
