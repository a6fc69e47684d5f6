"""The port's ``data/download.py`` against the JAX package's, offline, on the
CPU.  No test reaches another host: a fetch that must fail goes to a
refused local port, and the archives are ``file://`` URLs to archives the
tests build from trees written by ``scripts/gen_*_layout.py``.

- The class-name tables equal JAX's and the reference's published metadata.
- ``_fetch`` raises ``DownloadError`` with the layout note at once against
  a refused port, leaving no partial file; it copies a ``file://`` URL.
- ``_extract`` rejects a zip member that escapes the directory, and a tar's.
- ``download_voc`` and ``download_ade20k`` build, from the archives, the
  trees ``make_voc_source`` and ``make_ade_source`` read, file for file
  the trees JAX's functions build from the same archives; a complete
  layout is returned without a fetch.
- ``download_cityscapes`` on a complete tree fetches nothing, and without
  credentials or ``requests`` raises ``DownloadError``.
"""

import io
import os
import sys
import tarfile
import time
import zipfile

import numpy as np
import pytest

from bacs_tpu.data import datasets as jax_datasets
from bacs_tpu.data import download as jax_download
from bacs_tpu_torch.data import datasets, download

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scripts import gen_ade_layout, gen_voc_layout  # noqa: E402
from torch_port_helpers import _one_thread  # noqa: F401,E402

REFUSED = "http://127.0.0.1:9/"  # the discard port: nothing listens, refused at once


@pytest.fixture(autouse=True)
def _no_proxy(monkeypatch):
    for var in ("http_proxy", "HTTP_PROXY", "https_proxy", "HTTPS_PROXY", "all_proxy",
                "ALL_PROXY"):
        monkeypatch.delenv(var, raising=False)


@pytest.mark.parametrize("name,n,checks", [
    ("VOC_CLASSES", 21, {15: "person"}),
    ("ADE20K_CLASSES", 151, {1: "wall", 13: "person", 150: "flag"}),
    ("CITYSCAPES_CLASSES", 20, {1: "road", 19: "bicycle"}),
])
def test_class_name_tables_match_jax(name, n, checks):
    table = getattr(datasets, name)
    assert table == getattr(jax_datasets, name) and len(table) == n
    for i, label in checks.items():
        assert table[i] == label


def test_fetch_fails_at_once_offline_and_copies_file_urls(tmp_path):
    dest = tmp_path / "x.tar"
    t0 = time.perf_counter()
    with pytest.raises(download.DownloadError, match="layout"):
        download._fetch(REFUSED + "nonexistent.tar", str(dest))
    assert time.perf_counter() - t0 < 10 and not os.listdir(tmp_path)
    src = tmp_path / "src.bin"
    src.write_bytes(b"\x00\x01payload")
    got = download._fetch(src.as_uri(), str(tmp_path / "sub" / "copy.bin"))
    assert open(got, "rb").read() == b"\x00\x01payload"
    # an existing destination is returned without a fetch
    assert download._fetch(REFUSED, got) == got


def test_extract_rejects_escaping_members(tmp_path):
    z = tmp_path / "evil.zip"
    with zipfile.ZipFile(z, "w") as f:
        f.writestr("../escape.txt", "x")
    with pytest.raises(download.DownloadError, match="unsafe"):
        download._extract(str(z), str(tmp_path / "out"))
    t = tmp_path / "evil.tar"
    with tarfile.open(t, "w") as f:
        info = tarfile.TarInfo("../escape.txt")
        info.size = 1
        f.addfile(info, io.BytesIO(b"x"))
    with pytest.raises(tarfile.OutsideDestinationError):
        download._extract(str(t), str(tmp_path / "out"))
    assert not (tmp_path / "escape.txt").exists()


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """The release archives' layouts, packed from generated trees: VOC's
    tar (JPEGImages, SegmentationClass, ImageSets without train_aug.txt),
    the SegmentationClassAug zip, train_aug.txt, and ADE20K's zip."""
    base = tmp_path_factory.mktemp("archives")
    voc = base / "voc_tree"
    gen_voc_layout.generate(str(voc), n_train=6, n_val=3, size=40)
    voc2012 = voc / "VOCdevkit" / "VOC2012"
    aug_split = voc2012 / "ImageSets" / "Segmentation" / "train_aug.txt"
    out = {"train_aug": (base / "train_aug.txt")}
    out["train_aug"].write_bytes(aug_split.read_bytes())
    with tarfile.open(base / "VOCtrainval.tar", "w") as t:
        for d, _, names in os.walk(voc):
            for n in names:
                p = os.path.join(d, n)
                rel = os.path.relpath(p, voc)
                if "SegmentationClassAug" in rel or rel.endswith("train_aug.txt"):
                    continue
                t.add(p, rel)
    with zipfile.ZipFile(base / "SegmentationClassAug.zip", "w") as z:
        for n in sorted(os.listdir(voc2012 / "SegmentationClassAug")):
            z.write(voc2012 / "SegmentationClassAug" / n, f"SegmentationClassAug/{n}")
    ade = base / "ade_tree"
    gen_ade_layout.generate(str(ade), n_train=6, n_val=3, size=40)
    with zipfile.ZipFile(base / "ADEChallengeData2016.zip", "w") as z:
        for d, _, names in os.walk(ade):
            for n in sorted(names):
                p = os.path.join(d, n)
                z.write(p, os.path.relpath(p, ade))
    out.update(voc=base / "VOCtrainval.tar", aug=base / "SegmentationClassAug.zip",
               ade=base / "ADEChallengeData2016.zip")
    return {k: v.as_uri() for k, v in out.items()}


def _point_urls(monkeypatch, archives):
    for module in (download, jax_download):
        monkeypatch.setattr(module, "VOC_URL", archives["voc"])
        monkeypatch.setattr(module, "VOC_AUG_URL", archives["aug"])
        monkeypatch.setattr(module, "VOC_AUG_SPLIT_URL", archives["train_aug"])
        monkeypatch.setattr(module, "ADE_URL", archives["ade"])


@pytest.mark.parametrize("dataset", ["voc", "ade"])
def test_download_builds_the_trees_jax_builds(dataset, archives, tmp_path, monkeypatch):
    _point_urls(monkeypatch, archives)
    fn = {"voc": "download_voc", "ade": "download_ade20k"}[dataset]
    got_root, ref_root = str(tmp_path / "port"), str(tmp_path / "jax")
    got = getattr(download, fn)(got_root)
    ref = getattr(jax_download, fn)(ref_root)
    assert os.path.relpath(got, got_root) == os.path.relpath(ref, ref_root)
    a, b = _files(got_root), _files(ref_root)
    assert sorted(a) == sorted(b) and len(a) >= 10
    assert all(a[k] == b[k] for k in a)
    make = {"voc": "make_voc_source", "ade": "make_ade_source"}[dataset]
    for split in ("train", "val"):
        src = getattr(datasets, make)(got_root, split, 32)
        ref_src = getattr(jax_datasets, make)(ref_root, split, 32)
        assert len(src) == len(ref_src) >= 3
        for i in range(len(src)):
            for x, y in zip(src.load(i), ref_src.load(i)):
                assert np.array_equal(x, y)
    # complete now: a second call fetches nothing
    monkeypatch.setattr(download, "_fetch", lambda *a: pytest.fail("fetched"))
    assert getattr(download, fn)(got_root) == got


def test_cityscapes_complete_tree_and_missing_requests(tmp_path, monkeypatch):
    root = tmp_path / "cs"
    (root / "leftImg8bit").mkdir(parents=True)
    (root / "gtFine").mkdir()
    assert download.download_cityscapes(str(root), "", "") == str(root)
    monkeypatch.setitem(sys.modules, "requests", None)  # not installed
    with pytest.raises(download.DownloadError, match="requests"):
        download.download_cityscapes(str(tmp_path / "empty"), "u", "p")
