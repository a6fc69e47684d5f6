"""The port's folder sources (VOC, ADE20K, Cityscapes), their DataModule
streams and its layout writer against the JAX package, on the CPU.

- Trees written by the JAX scripts (``scripts/gen_*_layout.py``, about 8
  images a split) read through both packages' sources: every image and
  label bit-equal per index, through ``load``, ``load_label`` and the remap
  tables, the class names and Cityscapes' per-city ``domain_ids`` equal.
- ``create_datamodule`` on those trees (VOC continual, ADE20K and
  Cityscapes joint): the train index batches, the unaugmented train
  stream's labels, the eval streams' indices, real counts, labels (and
  images to 1e-6) and their decoded uint8 batches (bit for bit) equal
  JAX's, with both packages' native batch decoders on (the path each takes
  where the decoder builds) and with both masked (the PIL path of a host
  without the image headers).  The two decoders differ by a few levels
  (``tests/test_native.py``), so the native case fails where only one
  package decodes natively.
- ``dataset.download`` on a complete tree fetches nothing; on a missing
  one it raises ``DownloadError`` when the archive cannot be fetched.
- ``bacs_tpu_torch.data.layouts`` writes the scripts' files byte for byte.
"""

import os
import shutil
import sys

import numpy as np
import pytest

from bacs_tpu.data import datamodule as jax_datamodule
from bacs_tpu.data import datasets as jax_datasets
from bacs_tpu.data import native_decode
from bacs_tpu.data.decode_pool import gather_host as jax_gather_host
from bacs_tpu_torch.data import datamodule, datasets, download, layouts
from bacs_tpu_torch.data import native_decode as port_native_decode
from bacs_tpu_torch.data.decode_pool import gather_host

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scripts import gen_ade_layout, gen_cityscapes_layout, gen_voc_layout  # noqa: E402
from torch_port_helpers import _one_thread  # noqa: F401

SIZE = 48  # the images' canonical size
CROP = 32


def _write_trees(root):
    gen_voc_layout.generate(os.path.join(root, "voc"), n_train=8, n_val=4, size=SIZE)
    gen_ade_layout.generate(os.path.join(root, "ade"), n_train=8, n_val=4, size=SIZE)
    gen_cityscapes_layout.generate(os.path.join(root, "cs"), cities=2, per_city=4,
                                   val_cities=1, val_per_city=4, size=SIZE)
    return root


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    return _write_trees(str(tmp_path_factory.mktemp("jax_trees")))


@pytest.fixture(params=["native", "pil"])
def decoder(request, monkeypatch):
    """Both packages' folder sources decode natively ("native": each
    decoder must build), or both with PIL ("pil": both decoders masked)."""
    if request.param == "native":
        assert native_decode.available() and port_native_decode.available()
    else:
        for module in (native_decode, port_native_decode):
            monkeypatch.setattr(module, "_LIB", None)
            monkeypatch.setattr(module, "_TRIED", True)
    return request.param


MAKERS = {"voc": "make_voc_source", "ade": "make_ade_source", "cs": "make_cityscapes_source"}


@pytest.mark.parametrize("name", ["voc", "ade", "cs"])
@pytest.mark.parametrize("split", ["train", "val"])
def test_sources_bit_equal_to_jax(trees, name, split):
    root = os.path.join(trees, name)
    ref = getattr(jax_datasets, MAKERS[name])(root, split, SIZE)
    got = getattr(datasets, MAKERS[name])(root, split, SIZE)
    assert len(got) == len(ref) >= 4
    assert got.class_names == ref.class_names
    assert got.image_paths == ref.image_paths and got.label_paths == ref.label_paths
    if ref._table is None:
        assert got._table is None
    else:
        assert np.array_equal(got._table, ref._table)
    if name == "cs":
        assert got.domain_ids == ref.domain_ids and len(set(got.domain_ids)) >= 1
        # raw ids in the files; train ids, background 0, out of the loader
        assert np.array_equal(got._table[[0, 7, 33, 255, 5]], [0, 1, 19, 255, 0])
    for i in range(len(ref)):
        gi, gl = got.load(i)
        ri, rl = ref.load(i)
        assert gi.dtype == np.uint8 and gl.dtype == np.uint8
        assert np.array_equal(gi, ri) and np.array_equal(gl, rl)
        assert np.array_equal(got.load_label(i), ref.load_label(i))


def test_remap_table_matches_jax():
    remap = {3: 1, 9: 2, 200: 7}
    for default in (255, 0, 4):
        ref = jax_datasets.FolderSource([], [], 8, ["bg"], label_remap=remap,
                                        remap_default=default)
        got = datasets.FolderSource([], [], 8, ["bg"], label_remap=remap,
                                    remap_default=default)
        assert np.array_equal(got._table, ref._table)
        assert got._table[0] == 0 and got._table[255] == 255
    assert datasets.CITYSCAPES_ID_TO_TRAINID == jax_datasets.CITYSCAPES_ID_TO_TRAINID
    assert datasets.ADE20K_CLASSES == jax_datasets.ADE20K_CLASSES
    assert datasets.CITYSCAPES_CLASSES == jax_datasets.CITYSCAPES_CLASSES
    assert len(datasets.ADE20K_CLASSES) == 151


def _config(name, root, **training):
    target, classes = {"voc": ("dataloaders.VocDataModule", 21),
                       "ade": ("dataloaders.ADE20kDataModule", 151),
                       "cs": ("dataloaders.CityscapeDataModule", 20)}[name]
    return {"dataset": {"_target_": target, "dataset": {
                "root": root, "num_classes": classes, "crop_size": CROP}},
            "training": {"batch_size": 3, "seed": 42, **training}}


def _streams(dm):
    """{"train_labels": the unaugmented train stream's labels per task,
    "eval": every task's eval batches as (n_real, labels, images)}."""
    out = {"train_labels": [], "eval": []}
    for t in range(dm.n_tasks):
        dm.set_task_id(t)
        labels = [np.asarray(b["label"]) for b in dm.train_batches(0, augment=False)]
        out["train_labels"].append(labels)
        for d in dm.eval_task_range(t):
            out["eval"].append([(b["n_real"], np.asarray(b["label"]), np.asarray(b["image"]))
                                for b in dm.eval_batches(d)])
    return out


@pytest.mark.parametrize("name,training", [
    ("voc", dict(initial_increment=15, increment=5, mode="overlap")),
    ("ade", {}),
    ("cs", {}),
])
def test_datamodule_streams_match_jax(trees, name, training, decoder):
    root = os.path.join(trees, name)
    shutil.rmtree(os.path.join(root, "cache"), ignore_errors=True)
    ref = jax_datamodule.create_datamodule(_config(name, root, **training))
    shutil.rmtree(os.path.join(root, "cache"), ignore_errors=True)
    got = datamodule.create_datamodule(_config(name, root, **training), "cpu")
    assert got.n_tasks == ref.n_tasks and got.continual == ref.continual
    assert got.class_names == ref.class_names
    for t in range(got.n_tasks):
        got.set_task_id(t)
        ref.set_task_id(t)
        assert np.array_equal(got.train_indices(), ref.train_indices())
    a, b = _streams(got), _streams(ref)
    # the decoded host batches of every task's eval indices, bit for bit
    for t in range(got.n_tasks):
        got.set_task_id(t)
        for d in got.eval_task_range(t):
            for idx in got.eval_index_batches(d)[0]:
                for x, y in zip(gather_host(got.val_source, idx),
                                jax_gather_host(ref.val_source, idx)):
                    assert x.dtype == y.dtype == np.uint8 and np.array_equal(x, y)
    for x, y in zip(a["train_labels"], b["train_labels"]):
        assert len(x) == len(y) and all(np.array_equal(u, v) for u, v in zip(x, y))
    assert len(a["eval"]) == len(b["eval"])
    for x, y in zip(a["eval"], b["eval"]):
        assert len(x) == len(y)
        for (n1, l1, i1), (n2, l2, i2) in zip(x, y):
            assert n1 == n2 and np.array_equal(l1, l2)
            np.testing.assert_allclose(i1, i2, rtol=0, atol=1e-6)


def test_layouts_write_the_scripts_files(trees, tmp_path):
    """The port's writer against the scripts' files, byte for byte."""
    got = str(tmp_path)
    layouts.generate_voc(os.path.join(got, "voc"), n_train=8, n_val=4, size=SIZE)
    layouts.generate_ade(os.path.join(got, "ade"), n_train=8, n_val=4, size=SIZE)
    layouts.main(["cityscapes", "--root", os.path.join(got, "cs"), "--cities", "2",
                  "--per-city", "4", "--val-per-city", "4", "--size", str(SIZE)])

    def files(root):
        out = {}
        for d, _, names in os.walk(root):
            if os.path.basename(d) == "cache":
                continue
            for n in names:
                out[os.path.relpath(os.path.join(d, n), root)] = os.path.join(d, n)
        return out

    for name in ("voc", "ade", "cs"):
        a, b = files(os.path.join(got, name)), files(os.path.join(trees, name))
        assert sorted(a) == sorted(b) and len(a) >= 16
        for rel in a:
            with open(a[rel], "rb") as f, open(b[rel], "rb") as g:
                assert f.read() == g.read(), rel
    assert layouts.TRAIN_CITIES == gen_cityscapes_layout.TRAIN_CITIES
    assert layouts.VAL_CITIES == gen_cityscapes_layout.VAL_CITIES


def test_download_still_raises(trees, tmp_path, monkeypatch):
    """``dataset.download``: a complete tree is read as it is, nothing
    fetched; a missing one raises ``DownloadError`` at once where its
    archive cannot be fetched (a refused local port)."""
    for var in ("http_proxy", "HTTP_PROXY", "https_proxy", "HTTPS_PROXY"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(download, "VOC_URL", "http://127.0.0.1:9/VOCtrainval.tar")
    cfg = _config("voc", os.path.join(trees, "voc"))
    cfg["dataset"]["dataset"]["download"] = True
    assert len(datamodule.create_datamodule(cfg, "cpu").train_source) == 8
    cfg["dataset"]["dataset"]["root"] = str(tmp_path)
    with pytest.raises(download.DownloadError, match="layout"):
        datamodule.create_datamodule(cfg, "cpu")
