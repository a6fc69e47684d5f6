"""The port's host libraries (``csrc/host/``: the batch decoder and the label
ops) against the JAX package's, on the CPU.

- The label ops (``class_presence``, ``remap_labels``,
  ``unpack_bitplanes``, ``resize_nearest_u8``) bit-equal
  to JAX's on the same arrays, natively and through the numpy fallbacks;
  ``ops/bitpack.unpack_bits`` and ``continual.compute_class_sets`` on them.
- ``decode_batch`` bit-equal to JAX's on the same JPEG/PNG files (odd
  sizes, a palette PNG, a grey PNG, a missing file), its failure flags
  equal, its labels PIL's away from rounding ties and its images within
  JAX's own bound of PIL's (``tests/test_native.py``: mean < 1.5, max <=
  16); the counter of native batches.
- ``FolderSource.load_batch`` (remap tables, a failed slot patched through
  PIL) equal to JAX's; where the decoder does not build it warns once and
  the batch stream takes PIL, equal to JAX's PIL path.
- The libraries build under ``build/``, never into ``native/``.
"""

import os

import numpy as np
import pytest

from bacs_tpu.data import datasets as jax_datasets
from bacs_tpu.data import native as jax_native
from bacs_tpu.data import native_decode as jax_native_decode
from bacs_tpu_torch.data import datasets, native, native_decode
from bacs_tpu_torch.kernels import host_build
from torch_port_helpers import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(params=["native", "numpy"])
def label_lib(request, monkeypatch):
    """Both packages' label ops natively, or both on their numpy fallbacks."""
    if request.param == "native":
        assert native.available() and jax_native._build_and_load() is not None
    else:
        for module in (native, jax_native):
            monkeypatch.setattr(module, "_LIB", None)
            monkeypatch.setattr(module, "_TRIED", True)
    return request.param


def _label_ops(rs):
    labels = rs.randint(0, 256, (5, 19, 23)).astype(np.uint8)
    labels[0] = rs.choice([0, 3, 255], (19, 23))
    table = rs.randint(0, 50, 256).astype(np.int32)
    packed = rs.randint(0, 256, (3, 5, 4, 24)).astype(np.uint8)
    return {
        "class_presence": lambda m: m.class_presence(labels),
        "remap_labels": lambda m: m.remap_labels(labels[1], table),
        "unpack_bitplanes": lambda m: m.unpack_bitplanes(packed, 3, 5, 4, 24),
        "resize_nearest_u8": lambda m: [m.resize_nearest_u8(labels[2], dh, dw)
                                        for dh, dw in ((7, 5), (40, 31), (19, 23))],
    }


@pytest.mark.parametrize("op", ["class_presence", "remap_labels", "unpack_bitplanes",
                                "resize_nearest_u8"])
def test_label_ops_bit_equal_to_jax(op, label_lib):
    fn = _label_ops(np.random.RandomState(3))[op]
    got, ref = fn(native), fn(jax_native)
    if op == "unpack_bitplanes" and label_lib == "numpy":
        assert got is None and ref is None  # no fallback, as JAX's
        return
    got = got if isinstance(got, list) else [got]
    ref = ref if isinstance(ref, list) else [ref]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g, r = np.asarray(g), np.asarray(r)
        assert g.dtype == r.dtype and g.shape == r.shape and np.array_equal(g, r)


def test_unpack_bits_and_class_sets_match_jax(label_lib):
    """``ops/bitpack.unpack_bits`` and ``compute_class_sets`` on the label
    ops: JAX's values either way."""
    import torch

    from bacs_tpu.data.continual import compute_class_sets as jax_class_sets
    from bacs_tpu.ops.bitpack import unpack_bits as jax_unpack_bits
    from bacs_tpu_torch.data.continual import compute_class_sets
    from bacs_tpu_torch.ops.bitpack import pack_bits, unpack_bits

    rs = np.random.RandomState(5)
    preds = rs.randint(0, 21, (2, 16, 24)).astype(np.uint8)
    packed = pack_bits(torch.from_numpy(preds), 5).numpy()
    got = unpack_bits(packed, preds.shape, 5)
    assert np.array_equal(got, preds)
    assert np.array_equal(got, jax_unpack_bits(packed, preds.shape, 5))
    maps = [rs.choice([0, 1, 7, 20, 255], (9, 11)).astype(np.uint8) for _ in range(6)]
    for g, r in zip(compute_class_sets(maps), jax_class_sets(maps)):
        assert g.dtype == r.dtype and np.array_equal(g, r)


def _write_pair(root, i, w, h, rs, kind="palette"):
    from PIL import Image

    img = rs.randint(0, 255, (h, w, 3)).astype(np.uint8)
    lbl = rs.randint(0, 21, (h, w)).astype(np.uint8)
    ext = "png" if i % 3 == 2 else "jpg"  # PNG images too
    img_p, lbl_p = os.path.join(root, f"img_{i}.{ext}"), os.path.join(root, f"lbl_{i}.png")
    Image.fromarray(img).save(img_p, **({"quality": 95} if ext == "jpg" else {}))
    if kind == "palette":  # VOC's SegmentationClassAug masks
        pal = Image.fromarray(lbl, mode="P")
        pal.putpalette([c for k in range(256) for c in (k, 0, 0)])
        pal.save(lbl_p)
    else:  # ADE's and Cityscapes' grey masks
        Image.fromarray(lbl).save(lbl_p)
    return img_p, lbl_p


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("native_pairs"))
    rs = np.random.RandomState(11)
    sizes = [(40, 60), (64, 32), (32, 32), (100, 90), (77, 51), (53, 97)]
    return [_write_pair(root, i, w, h, rs, "palette" if i % 2 else "grey")
            for i, (w, h) in enumerate(sizes)] + [
        (os.path.join(root, "missing.jpg"), os.path.join(root, "lbl_0.png"))]


@pytest.mark.parametrize("size", [16, 32, 45])
def test_decode_batch_bit_equal_to_jax(pairs, size):
    assert native_decode.available() and jax_native_decode.available()
    imgs, lbls = [p[0] for p in pairs], [p[1] for p in pairs]
    before = native_decode.decode_batch.launches
    got = native_decode.decode_batch(imgs, lbls, size)
    assert native_decode.decode_batch.launches == before + 1
    ref = jax_native_decode.decode_batch(imgs, lbls, size)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and np.array_equal(g, r)
    assert list(got[2]) == [False] * 6 + [True] and not got[0][6].any()
    # against PIL: images within JAX's bound; labels equal where the two
    # nearest conventions meet no rounding tie (at 32, as JAX's test holds
    # them, and 16), else on all but a few pixels of these noise masks
    for i in range(6):
        pil_img, pil_lbl = datasets._load_pair(imgs[i], lbls[i], size)
        moved = np.mean(got[1][i] != pil_lbl)
        assert moved == 0 if size in (16, 32) else moved < 0.05, moved
        diff = np.abs(got[0][i].astype(int) - pil_img.astype(int))
        assert diff.mean() < 1.5 and diff.max() <= 16, (diff.mean(), diff.max())


def test_folder_source_load_batch_matches_jax(pairs):
    """``load_batch`` with a remap table and a failed slot patched through
    PIL (a BMP image: the native decoder reads JPEG and PNG only)."""
    from PIL import Image

    imgs, lbls = [p[0] for p in pairs[:6]], [p[1] for p in pairs[:6]]
    bmp = os.path.join(os.path.dirname(imgs[0]), "img_4.bmp")
    Image.open(imgs[4]).save(bmp)
    imgs[4] = bmp
    remap = {3: 1, 9: 2, 20: 7}
    got = datasets.FolderSource(imgs, lbls, 24, ["c"] * 21, label_remap=remap, remap_default=0)
    ref = jax_datasets.FolderSource(imgs, lbls, 24, ["c"] * 21, label_remap=remap,
                                    remap_default=0)
    assert native_decode.decode_batch(imgs, lbls, 24)[2][4]
    idx = [5, 4, 0, 4, 1]
    g, r = got.load_batch(idx), ref.load_batch(idx)
    for x, y in zip(g, r):
        assert np.array_equal(x, y)
    assert set(np.unique(g[1])) <= {0, 1, 2, 7}
    # the patched slot is PIL's decode
    assert np.array_equal(g[0][1], got.load(4)[0])


def test_unavailable_decoder_warns_and_takes_pil(pairs, monkeypatch):
    """A decoder that does not build: one warning, ``available()`` False,
    ``load_batch`` None, and the batch stream equal to JAX's PIL path."""
    from bacs_tpu.data.decode_pool import gather_host as jax_gather_host
    from bacs_tpu_torch.data.decode_pool import gather_host

    def broken(name):
        raise RuntimeError("g++ failed (1): fatal error: jpeglib.h: No such file")

    monkeypatch.setattr(native_decode, "_LIB", None)
    monkeypatch.setattr(native_decode, "_TRIED", False)
    monkeypatch.setattr(host_build, "build", broken)
    monkeypatch.setattr(jax_native_decode, "_LIB", None)
    monkeypatch.setattr(jax_native_decode, "_TRIED", True)
    with pytest.warns(UserWarning, match="16 levels.*jpeglib.h"):
        assert not native_decode.available()
    assert native_decode.decode_batch(["a"], ["b"], 8) is None  # no second warning
    imgs, lbls = [p[0] for p in pairs[:4]], [p[1] for p in pairs[:4]]
    got = datasets.FolderSource(imgs, lbls, 20, ["c"] * 21)
    assert got.load_batch([0, 1]) is None
    ref = jax_datasets.FolderSource(imgs, lbls, 20, ["c"] * 21)
    for x, y in zip(gather_host(got, [3, 0, 2]), jax_gather_host(ref, [3, 0, 2])):
        assert np.array_equal(x, y)


def test_libraries_build_under_build_dir():
    for name in ("fastdecode", "fastlabel"):
        path = host_build.library_path(name)
        assert path.is_file() and path.parent.name == "bacs_tpu_torch"
        assert path.parent.parent.name == "build"
        # the port's copies are the JAX package's sources, unchanged
        with open(os.path.join(REPO, "native", f"{name}.cpp"), "rb") as f:
            assert host_build.source(name).read_bytes() == f.read()
    # where g++ finds both image headers, the decoder builds
    assert all(host_build.header_probe().values()) == native_decode.available()
