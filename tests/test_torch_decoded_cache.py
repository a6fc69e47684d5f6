"""The port's ``DecodedCache`` (RAM and disk) against the JAX package's, on
the CPU, over a VOC tree written by ``scripts/gen_voc_layout.py``.

- JAX's own checks of its cache, run on the port's: bit-identical to the
  source's decode (``load`` and ``load_batch``, hits, misses and
  duplicates), a warm pass never decodes, the files persist and rekey when
  a file or the size changes, full-resolution ``load_label``, the flush
  before the flags (one image and one label flush a batch, taken while every
  new flag is 0), the flush ranges' arithmetic, and the DataModule's
  ``cache_decoded`` modes.
- Each package reads the other's disk cache bit-equal, without decoding:
  the same key, the same three files.
- Two processes that open and fill one cache at once leave it whole: every
  flag set, every slot its decode.
- The DataModule's streams with ``cache_decoded=disk`` equal JAX's, each
  package filling its own cache.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import pytest

from bacs_tpu.data import datasets as jax_datasets
from bacs_tpu_torch.data import datamodule, datasets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from scripts.gen_voc_layout import generate  # noqa: E402
from torch_port_helpers import _one_thread  # noqa: F401,E402

DecodedCache = datasets.DecodedCache


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc_cache")
    generate(str(root), n_train=10, n_val=4, size=72, seed=5)
    return str(root)


def _cache(voc_root, tmp_path, size=64, package=datasets):
    src = package.make_voc_source(voc_root, "train", size)
    return src, package.DecodedCache(src, str(tmp_path / "cache"))


def _batch(src, idx):
    out = src.load_batch(idx)
    return out if out is not None else tuple(np.stack(x) for x in zip(*[src.load(i) for i in idx]))


@pytest.mark.parametrize("mode", ["ram", "disk"])
def test_cache_is_bit_identical_to_source(voc_root, tmp_path, mode):
    src = datasets.make_voc_source(voc_root, "train", 64)
    cached = DecodedCache(src, str(tmp_path / "cache") if mode == "disk" else None)
    assert isinstance(cached._imgs, np.memmap) == (mode == "disk")
    for i in (0, 3):
        for _ in range(2):  # a fill, then a read
            ci, cl = cached.load(i)
            si, sl = src.load(i)
            assert np.array_equal(ci, si) and np.array_equal(cl, sl)
    cached.load_batch([1])
    imgs, lbls = cached.load_batch([3, 2, 1, 2])  # hit, miss, hit, duplicate
    ref = _batch(src, [3, 2, 1, 2])
    assert np.array_equal(imgs[1:], ref[0][1:]) and np.array_equal(lbls, ref[1])
    assert cached._valid[[0, 1, 2, 3]].all() and not cached._valid[4]


def test_second_pass_never_touches_the_decoder(voc_root, tmp_path, monkeypatch):
    src, cached = _cache(voc_root, tmp_path)
    cached.load_batch(list(range(len(src))))

    def boom(*a, **k):
        raise AssertionError("decoder called on a warm cache")

    monkeypatch.setattr(src, "load", boom)
    monkeypatch.setattr(src, "load_batch", boom)
    imgs, lbls = cached.load_batch([0, 2, 4])
    assert imgs.shape == (3, 64, 64, 3) and lbls.shape == (3, 64, 64)


def test_cache_persists_and_rekeys_on_dataset_change(voc_root, tmp_path):
    src, cached = _cache(voc_root, tmp_path)
    cached.load(0)
    again = DecodedCache(datasets.make_voc_source(voc_root, "train", 64), str(tmp_path / "cache"))
    assert again._valid[0] == 1 and again.base == cached.base
    p = src.image_paths[0]
    st = os.stat(p)
    try:
        os.utime(p, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
        rekeyed = DecodedCache(datasets.make_voc_source(voc_root, "train", 64),
                               str(tmp_path / "cache"))
        assert rekeyed._valid[0] == 0 and rekeyed.base != cached.base
    finally:
        os.utime(p, ns=(st.st_atime_ns, st.st_mtime_ns))
    other = DecodedCache(datasets.make_voc_source(voc_root, "train", 48), str(tmp_path / "cache"))
    assert other._imgs.shape[1:] == (48, 48, 3)
    # the label remap is part of the key
    remapped = datasets.FolderSource(src.image_paths, src.label_paths, 64, src.class_names,
                                     label_remap={1: 2})
    assert DecodedCache(remapped, str(tmp_path / "cache")).base != cached.base


def test_load_label_stays_full_resolution(voc_root, tmp_path):
    src, cached = _cache(voc_root, tmp_path)
    assert np.array_equal(cached.load_label(2), src.load_label(2))
    assert cached.load_label(2).shape != (64, 64)


def test_disk_commit_flushes_pixels_before_valid_flags(voc_root, tmp_path, monkeypatch):
    src, cached = _cache(voc_root, tmp_path)
    valid_at_flush = []
    orig_flush = DecodedCache._flush_rows

    def spy(self, mm, indices):
        if self is cached:
            valid_at_flush.append(np.array(cached._valid))
        return orig_flush(self, mm, indices)

    monkeypatch.setattr(DecodedCache, "_flush_rows", spy)
    cached.load_batch([0, 1, 2])
    assert cached._valid[[0, 1, 2]].all()
    assert len(valid_at_flush) == 2
    for snap in valid_at_flush:
        assert not snap[[0, 1, 2]].any()
    valid_at_flush.clear()
    cached.load(5)
    assert cached._valid[5] and len(valid_at_flush) == 2
    assert not any(s[5] for s in valid_at_flush)


@pytest.mark.parametrize("indices,row,total", [
    ([3, 1, 2, 7], 2, 100), ([99], 2, 100), ([0, 1, 2], 0.25, 16), ([0, 2, 4, 6], 0.25, 16),
    ([5, 5, 6, 40, 41, 3], 1.5, 64),
])
def test_flush_row_range_math_matches_jax(indices, row, total):
    """The flush ranges (rows coalesced, offsets aligned down to mmap's
    granularity, clamped to the file, touching ranges merged) equal JAX's;
    ``row`` and ``total`` in granularities and rows."""
    import mmap

    row_bytes = max(int(row * mmap.ALLOCATIONGRANULARITY) + 128 * (row > 1), 1)
    got = DecodedCache._row_runs(indices, row_bytes, row_bytes * total)
    assert got == jax_datasets.DecodedCache._row_runs(indices, row_bytes, row_bytes * total)
    for lo, hi in got:
        assert lo % mmap.ALLOCATIONGRANULARITY == 0 and 0 <= lo < hi <= row_bytes * total


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_cache(voc_root, tmp_path, monkeypatch, writer):
    """One package fills a disk cache; the other opens the same three files
    (the same key) and serves every slot bit-equal without decoding."""
    packages = {"jax": jax_datasets, "port": datasets}
    reader = "port" if writer == "jax" else "jax"
    wsrc, wcache = _cache(voc_root, tmp_path, package=packages[writer])
    filled = wcache.load_batch(list(range(len(wsrc))))
    wcache._imgs.flush()
    rsrc, rcache = _cache(voc_root, tmp_path, package=packages[reader])
    files = sorted(f for f in os.listdir(tmp_path / "cache") if f.startswith("decoded_"))
    assert len(files) == 3 and rcache._valid.all()

    def boom(*a, **k):
        raise AssertionError("the reader decoded")

    monkeypatch.setattr(rsrc, "load", boom)
    monkeypatch.setattr(rsrc, "load_batch", boom)
    got = rcache.load_batch(list(range(len(rsrc))))
    assert np.array_equal(got[0], filled[0]) and np.array_equal(got[1], filled[1])
    assert np.array_equal(got[0], _batch(wsrc, list(range(len(wsrc))))[0])


# one process of the two: wait for the go file, open the cache, fill its slots
FILL = """
import os, sys, time
from bacs_tpu_torch.data import datasets
root, cache_dir, go, indices = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4]
indices = [int(i) for i in indices.split(",")]
open(f"{go}.{os.getpid()}.ready", "w").close()
while not os.path.exists(go):
    time.sleep(0.005)
cache = datasets.DecodedCache(datasets.make_voc_source(root, "train", 64), cache_dir)
for k in range(0, len(indices), 3):
    cache.load_batch(indices[k:k + 3])
"""


def test_two_processes_fill_one_cache(voc_root, tmp_path):
    """Two processes open the one (absent) cache at once and fill
    overlapping slots: no file is truncated under the other, every flag
    ends set and every slot holds its decode."""
    import subprocess

    cache_dir, go = str(tmp_path / "cache"), str(tmp_path / "go")
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, "-c", FILL, voc_root, cache_dir, go, idx], env=env)
             for idx in ("0,1,2,3,4,5,6", "9,8,7,6,5,4,3")]
    deadline = time.time() + 120
    while len([f for f in os.listdir(tmp_path) if f.endswith(".ready")]) < 2:
        assert time.time() < deadline and all(p.poll() is None for p in procs)
        time.sleep(0.01)
    open(go, "w").close()  # both past their imports: they open the cache at once
    assert [p.wait(120) for p in procs] == [0, 0]
    src = datasets.make_voc_source(voc_root, "train", 64)
    cache = DecodedCache(src, cache_dir)
    assert cache._valid.all()
    got = cache.load_batch(list(range(len(src))))
    ref = _batch(src, list(range(len(src))))
    assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
    assert not [f for f in os.listdir(cache_dir) if f.endswith(".tmp")]


@pytest.mark.parametrize("mode", [True, "disk"])
def test_datamodule_cache_streams_match_jax(voc_root, mode):
    """``cache_decoded`` true (RAM) or ``disk`` (memmaps under
    ``<root>/cache``): the sources are caches of the configured kind and
    the streams equal JAX's.  On disk each package fills its own cache:
    JAX's streams run first, its files are removed, and the port's
    DataModule then decodes and stores every sample itself (its streams
    read back the bytes it stored) under JAX's file names."""
    import glob

    from bacs_tpu.data import datamodule as jax_datamodule

    config = {"dataset": {"_target_": "dataloaders.VocDataModule", "dataset": {
                  "root": voc_root, "num_classes": 21, "crop_size": 64,
                  "cache_decoded": mode}},
              "training": {"batch_size": 3, "seed": 42}}

    def streams(dm):
        labels = [np.asarray(b["label"]) for b in dm.train_batches(0, augment=False)]
        evals = [(b["n_real"], np.asarray(b["image"])) for b in dm.eval_batches(0)]
        return labels, evals

    cached = os.path.join(voc_root, "cache", "decoded_*")
    for f in glob.glob(cached):
        os.remove(f)
    ref = jax_datamodule.create_datamodule(config)
    b, eb = streams(ref)
    ref_base = ref.train_source._imgs.filename[:-len(".imgs")] if mode == "disk" else None
    for f in glob.glob(cached):
        os.remove(f)
    got = datamodule.create_datamodule(config, "cpu")
    assert isinstance(got.train_source, DecodedCache)
    assert isinstance(got.train_source._imgs, np.memmap) == (mode == "disk")
    if mode == "disk":
        assert got.train_source.base == ref_base and not got.train_source._valid.any()
    a, ea = streams(got)
    assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
    assert len(ea) == len(eb)
    for (n1, i1), (n2, i2) in zip(ea, eb):
        assert n1 == n2
        np.testing.assert_allclose(i1, i2, rtol=0, atol=1e-6)
    if mode == "disk":
        assert got.train_source._valid.any() and got.val_source._valid.any()
    config["dataset"]["dataset"]["cache_decoded"] = False
    assert not isinstance(datamodule.create_datamodule(config, "cpu").train_source, DecodedCache)
