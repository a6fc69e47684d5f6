"""Dataset sources: VOC, ADE20K and Cityscapes file-backed, synthetic,
domain-shifted, and the decoded caches.

Port of ``bacs_tpu/data/datasets.py``.  Each source exposes ``load(i) ->
(image uint8 [H, W, 3], label uint8 [H, W])`` at a fixed canonical size;
augmentation happens on the device (``data/transforms.py``).

- ``SyntheticSource`` (both styles, ``flat`` and ``rich``, and the era
  options): a numpy copy, bit-equal to the JAX package's images and labels.
- ``FolderSource`` with its label remap, and ``make_voc_source``,
  ``make_ade_source``, ``make_cityscapes_source`` (raw ids remapped to
  train ids, unknown ids to background, a ``domain_ids`` entry per city).
  ``load(i)`` decodes one pair with PIL (imported only when an image is
  decoded); ``load_batch(indices)`` decodes a batch through the native
  decoder (``data/native_decode.py``) and returns None where that did not
  build, as JAX's (``datasets.py:91-113``).  The batch stream takes
  ``load_batch`` first (``data/decode_pool.py:gather_host``), so on one
  host both packages read a folder tree's same pixels; the two decoders
  differ by a few levels.  Several batches decode at once in the decode
  pool.
- ``DomainShiftedSource``: a fixed colour transform per domain.
- ``DecodedCache`` and ``DeviceCache``: the decoded set in host memory or
  in memmaps on disk (``datasets.py:124-272``; JAX's key and file layout,
  so either package reads the other's files), or resident on the card as
  uint8 tensors with batches gathered there (``datasets.py:511-566``).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

VOC_CLASSES = [
    "background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]

# Cityscapes id → train id (reference: dataset/cityscape_domain_dataset.py:15-51)
CITYSCAPES_ID_TO_TRAINID = {
    7: 1, 8: 2, 11: 3, 12: 4, 13: 5, 17: 6, 19: 7, 20: 8, 21: 9, 22: 10,
    23: 11, 24: 12, 25: 13, 26: 14, 27: 15, 28: 16, 31: 17, 32: 18, 33: 19,
}


def _load_pair(img_path: str, lbl_path: str, size: int):
    """Decode to a canonical size×size pair, aspect-preserving: resize the
    shorter side to `size`, then center-crop (the reference's eval transform,
    voc_datamodule.py:24-30; train-time RandomResizedCrop then samples
    regions of this canvas on device)."""
    from PIL import Image

    img = Image.open(img_path).convert("RGB")
    lbl = Image.open(lbl_path)
    w, h = img.size
    scale = size / min(w, h)
    nw, nh = max(size, round(w * scale)), max(size, round(h * scale))
    img = img.resize((nw, nh), Image.BILINEAR)
    lbl = lbl.resize((nw, nh), Image.NEAREST)
    left, top = (nw - size) // 2, (nh - size) // 2
    box = (left, top, left + size, top + size)
    return (
        np.asarray(img.crop(box), np.uint8),
        np.asarray(lbl.crop(box), np.uint8),
    )


class FolderSource:
    """Generic (image, mask) path-list source with optional label remap,
    decoded with PIL one image at a time (``load``) or natively a batch at
    a time (``load_batch``).  The remap is a [256] table:
    ``label_remap``'s ids to their values, 0 and 255 kept, every other id
    to ``remap_default``."""

    def __init__(
        self,
        image_paths: Sequence[str],
        label_paths: Sequence[str],
        size: int,
        class_names: Sequence[str],
        label_remap: Optional[dict] = None,
        remap_default: int = 255,
    ):
        assert len(image_paths) == len(label_paths)
        self.image_paths = list(image_paths)
        self.label_paths = list(label_paths)
        self.size = size
        self.class_names = list(class_names)
        self._table = None
        if label_remap is not None:
            table = np.full((256,), remap_default, np.uint8)
            table[0] = 0
            table[255] = 255
            for k, v in label_remap.items():
                table[k] = v
            self._table = table

    def __len__(self):
        return len(self.image_paths)

    def load(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        img, lbl = _load_pair(self.image_paths[i], self.label_paths[i], self.size)
        if self._table is not None:
            lbl = self._table[lbl]
        return img, lbl

    def load_batch(self, indices):
        """(images, labels) of ``indices`` decoded in parallel by the native
        decoder, a slot it fails patched through PIL; None (the caller's
        per-sample path) when the decoder is unavailable."""
        from bacs_tpu_torch.data import native_decode

        out = native_decode.decode_batch(
            [self.image_paths[i] for i in indices],
            [self.label_paths[i] for i in indices],
            self.size,
        )
        if out is None:
            return None
        imgs, lbls, failed = out
        for k in np.nonzero(failed)[0]:
            imgs[k], lbls[k] = _load_pair(
                self.image_paths[indices[k]], self.label_paths[indices[k]], self.size)
        if self._table is not None:
            lbls = self._table[lbls]
        return imgs, lbls

    def load_label(self, i: int) -> np.ndarray:
        from PIL import Image

        lbl = np.asarray(Image.open(self.label_paths[i]), np.uint8)
        if self._table is not None:
            lbl = self._table[lbl]
        return lbl


class DecodedCache:
    """Cache of a source's canonical decoded (image, label) pairs
    (``bacs_tpu/data/datasets.py:124-272``): the first touch of a sample
    decodes and stores it, later epochs read the bytes.  Lossless, since a
    source decodes to a fixed canonical size.

    - RAM (``cache_dir`` None): arrays in this process.
    - disk (``cache_dir``, ``dataset.cache_decoded=disk``: for datasets
      bigger than host memory): three memmaps ``<cache_dir>/decoded_<s>_
      <key>.{imgs,lbls,valid}``, ``key`` a blake2b of the size, each path's
      mtime and size and the remap table, kept across runs; JAX's key and
      layout, so a cache that either package writes, the other reads.  A
      sample's ``valid`` flag is set after its pixels are flushed, so a
      crash mid-fill only decodes again.  The files are created whole under
      a private name and linked into place, never truncated, and every
      process opens them ``r+``: data-parallel ranks (processes here, where
      JAX's mesh is one) may open one cache at once.

    ``load_label`` passes through uncached: the class-set scan reads the
    full-resolution labels, not the center-cropped canvas.
    """

    def __init__(self, source, cache_dir: Optional[str] = None):
        self.source = source
        self.size = source.size
        self.class_names = source.class_names
        n, s = len(source), source.size
        self._disk = cache_dir is not None
        if cache_dir is None:  # RAM mode
            self._imgs = np.zeros((n, s, s, 3), np.uint8)
            self._lbls = np.zeros((n, s, s), np.uint8)
            self._valid = np.zeros((n,), np.uint8)
            return
        import hashlib

        h = hashlib.blake2b(digest_size=8)
        h.update(str(source.size).encode())
        for p in source.image_paths + source.label_paths:
            st = os.stat(p)
            h.update(f"{p}:{st.st_mtime_ns}:{st.st_size}".encode())
        if source._table is not None:
            h.update(source._table.tobytes())
        os.makedirs(cache_dir, exist_ok=True)
        self.base = os.path.join(cache_dir, f"decoded_{s}_{h.hexdigest()}")
        self._imgs = _shared_memmap(self.base + ".imgs", (n, s, s, 3))
        self._lbls = _shared_memmap(self.base + ".lbls", (n, s, s))
        self._valid = _shared_memmap(self.base + ".valid", (n,))

    def __len__(self):
        return len(self.source)

    def _store(self, i: int, img: np.ndarray, lbl: np.ndarray):
        self._imgs[i] = img
        self._lbls[i] = lbl

    @staticmethod
    def _row_runs(indices, row_bytes: int, total_bytes: int):
        """Byte ranges covering the given memmap rows, consecutive rows
        coalesced and each range aligned down to mmap's flush granularity
        (mmap.flush requires an ALLOCATIONGRANULARITY-aligned offset)."""
        import mmap as _mmap

        gran = _mmap.ALLOCATIONGRANULARITY
        runs = []
        for i in sorted(set(int(i) for i in indices)):
            if runs and i == runs[-1][1]:
                runs[-1][1] = i + 1
            else:
                runs.append([i, i + 1])
        out = []
        for lo_row, hi_row in runs:
            lo = (lo_row * row_bytes) // gran * gran
            hi = min(hi_row * row_bytes, total_bytes)
            # merge with the previous range if page alignment made them touch
            if out and lo <= out[-1][1]:
                out[-1] = (out[-1][0], max(hi, out[-1][1]))
            else:
                out.append((lo, hi))
        return out

    def _flush_rows(self, mm: np.memmap, indices) -> None:
        """msync only the pages covering the written rows (a whole-map flush
        is O(cache size) a batch)."""
        buf = mm._mmap
        for lo, hi in self._row_runs(indices, mm.strides[0], len(buf)):
            buf.flush(lo, hi - lo)

    def _commit(self, indices) -> None:
        """Set the valid flags, after the pixel pages are on disk: writeback
        is not program order, and a flag persisted over never-written pixels
        would serve zeros forever.  A crash before the flags decodes again."""
        if self._disk:
            self._flush_rows(self._imgs, indices)
            self._flush_rows(self._lbls, indices)
        for i in indices:
            self._valid[i] = 1

    def load(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        if not self._valid[i]:
            self._store(i, *self.source.load(i))
            self._commit((i,))
        return np.array(self._imgs[i]), np.array(self._lbls[i])

    def load_batch(self, indices):
        """(images, labels) of ``indices``; the missing samples decoded as
        one batch (natively where the source can), then stored."""
        indices = [int(i) for i in indices]
        missing = [i for i in dict.fromkeys(indices) if not self._valid[i]]
        if missing:
            loader = getattr(self.source, "load_batch", None)
            out = loader(missing) if loader else None
            if out is None:  # no native decoder: PIL per sample
                out = tuple(np.stack(x) for x in zip(*[self.source.load(i) for i in missing]))
            for k, i in enumerate(missing):
                self._store(i, out[0][k], out[1][k])
            self._commit(missing)
        # fancy indexing already yields fresh arrays
        return np.asarray(self._imgs[indices]), np.asarray(self._lbls[indices])

    def load_label(self, i: int) -> np.ndarray:
        return self.source.load_label(i)


def _shared_memmap(path: str, shape) -> np.memmap:
    """A uint8 memmap of ``shape`` at ``path``, opened ``r+``; created
    zero-filled first if absent.  The file is written whole under a private
    name and hard-linked into place, which fails where another process
    linked first, so no process ever truncates a file another has open."""
    if not os.path.exists(path):
        import uuid

        tmp = f"{path}.{uuid.uuid4().hex}.tmp"
        with open(tmp, "xb") as f:
            f.truncate(int(np.prod(shape)))
        try:
            os.link(tmp, path)
        except FileExistsError:
            pass
        finally:
            os.remove(tmp)
    return np.memmap(path, np.uint8, "r+", shape=tuple(shape))


def _upsample_bilinear_np(small: np.ndarray, s: int) -> np.ndarray:
    """Bilinear [h,w,(c)] → [s,s,(c)] on host numpy (for texture fields)."""
    h, w = small.shape[:2]
    ys = np.linspace(0, h - 1, s)
    xs = np.linspace(0, w - 1, s)
    y0 = np.clip(ys.astype(np.int64), 0, h - 2)
    x0 = np.clip(xs.astype(np.int64), 0, w - 2)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[None, :]
    if small.ndim == 3:
        wy, wx = wy[..., None], wx[..., None]
    a = small[y0][:, x0]
    b = small[y0][:, x0 + 1]
    c = small[y0 + 1][:, x0]
    d = small[y0 + 1][:, x0 + 1]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + c * wy * (1 - wx) + d * wy * wx)


class SyntheticSource:
    """Deterministic synthetic segmentation data for tests and benchmarks.

    Two generator styles:

    * ``flat`` (default, the original generator — every existing protocol
      table and test is pinned to it): background plus 1–4 random class
      disks; images are class-correlated flat colors + noise.
    * ``rich``: a protocol sized for FLAGSHIP models (DeepLabV3 at crop
      256+).  Each class has a distinctive appearance — two class colors
      modulated by a class-keyed texture (stripes / checker / dots /
      smooth gradient, with per-instance phase, scale and rotation
      jitter) — drawn as one of six shape families (disk, ellipse,
      rectangle, ring, triangle, cross) over a textured low-frequency
      background with per-image illumination shifts.  Classes are
      therefore separable by texture+color statistics but not by pixel
      memorization, giving a 39M-param network genuine signal at scales
      where the flat generator degenerates (the flat 160-image protocol
      collapsed flagship runs to ~0.03 mIoU).
    """

    def __init__(self, n: int, size: int, num_classes: int, seed: int = 0,
                 style: str = "flat", cooccur: float = -1.0,
                 cooccur_initial: int = 0, cooccur_increment: int = 1,
                 bg_drift: bool = False):
        assert style in ("flat", "rich"), style
        self.n = n
        self.size = size
        self.num_classes = num_classes
        self.seed = seed
        self.style = style
        # -- controlled background-shift regime (rich style only) ---------
        # cooccur >= 0 switches class sampling to ERA-STRUCTURED mode: each
        # image gets one uniform "anchor" class defining its era (era 0 =
        # classes 1..cooccur_initial; later eras add cooccur_increment
        # classes each, mirroring a class-incremental split in class-id
        # order). Extra objects in an era-e>0 image are drawn from OLD-era
        # classes with probability `cooccur` (at training time these pixels
        # are collapsed to background → true background shift, the regime
        # BACS's seen-detector targets, reference: loss/bacs_loss.py:258-294)
        # and from the anchor's own era otherwise.  With `bg_drift`, era-e>0
        # images additionally get a fixed per-era background appearance
        # (channel gain/bias + a high-frequency hatch absent from era 0) —
        # background pixels whose appearance was NEVER seen in earlier
        # tasks, violating MiB's bg-is-a-mixture-of-old-classes modeling
        # assumption (reference: loss/loss_utils.py unbiased CE).
        self.cooccur = float(cooccur)
        self.cooccur_initial = int(cooccur_initial)
        self.cooccur_increment = max(1, int(cooccur_increment))
        self.bg_drift = bool(bg_drift)
        if self.cooccur >= 0 or self.bg_drift:
            assert style == "rich", "era mode needs the rich generator"
            assert 1 <= self.cooccur_initial < num_classes - 1
        self.class_names = ["background"] + [
            f"class_{i}" for i in range(1, num_classes)
        ]

    def _class_era(self, c: int) -> int:
        if c <= self.cooccur_initial:
            return 0
        return 1 + (c - self.cooccur_initial - 1) // self.cooccur_increment

    def _era_classes(self, era: int) -> np.ndarray:
        if era == 0:
            return np.arange(1, self.cooccur_initial + 1)
        lo = self.cooccur_initial + 1 + (era - 1) * self.cooccur_increment
        return np.arange(lo, min(lo + self.cooccur_increment,
                                 self.num_classes))

    def __len__(self):
        return self.n

    def _rng(self, i: int) -> np.random.RandomState:
        return np.random.RandomState(self.seed * 100003 + i)

    def load(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        if self.style == "rich":
            return self._load_rich(i)
        rng = self._rng(i)
        s = self.size
        lbl = np.zeros((s, s), np.uint8)
        n_obj = rng.randint(1, 5)
        classes = rng.randint(1, self.num_classes, size=n_obj)
        for c in classes:
            cx, cy = rng.randint(0, s, 2)
            r = rng.randint(s // 8, s // 3)
            yy, xx = np.ogrid[:s, :s]
            lbl[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = c
        # class-correlated colors
        palette = np.stack(
            [
                (np.arange(self.num_classes) * 53) % 255,
                (np.arange(self.num_classes) * 101) % 255,
                (np.arange(self.num_classes) * 197) % 255,
            ],
            axis=1,
        ).astype(np.float32)
        img = palette[lbl] + rng.randn(s, s, 3) * 20
        return np.clip(img, 0, 255).astype(np.uint8), lbl

    # -- rich generator ------------------------------------------------

    def _class_palette(self) -> Tuple[np.ndarray, np.ndarray]:
        """Two fixed colors per class (texture endpoints), well separated
        in hue; class 0 (bg) entries are unused."""
        c = np.arange(self.num_classes, dtype=np.float32)
        h1 = (c * 0.618034) % 1.0  # golden-ratio hue spacing
        h2 = (h1 + 0.23) % 1.0

        def hsv(h, sat, val):
            k = (np.stack([h * 6 + 0, h * 6 + 4, h * 6 + 2]) % 6)
            f = val - val * sat * np.clip(np.minimum(k, 4 - k), 0, 1)
            return (f.T * 255.0).astype(np.float32)

        return hsv(h1, 0.85, 0.9), hsv(h2, 0.6, 0.55)

    def _load_rich(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = self._rng(i + 7_777_777)
        s = self.size
        yy, xx = np.mgrid[:s, :s].astype(np.float32)
        col1, col2 = self._class_palette()

        # textured background: low-frequency color field + faint stripes
        small = rng.randn(7, 7, 3).astype(np.float32)
        bg = 110.0 + 35.0 * _upsample_bilinear_np(small, s)
        ang = rng.uniform(0, np.pi)
        bg += 8.0 * np.sin(
            (xx * np.cos(ang) + yy * np.sin(ang)) * rng.uniform(0.02, 0.06)
        )[..., None]
        n_obj = rng.randint(3, 7)
        if self.cooccur >= 0:  # era-structured mode (see __init__)
            anchor = int(rng.randint(1, self.num_classes))
            era = self._class_era(anchor)
            old = np.arange(1, self._era_classes(era)[0]) if era else None
            extras = []
            for _ in range(n_obj - 1):
                pool = (old if era > 0 and rng.uniform() < self.cooccur
                        else self._era_classes(era))
                extras.append(int(pool[rng.randint(len(pool))]))
            classes = np.array([anchor] + extras)
            if self.bg_drift and era > 0:
                # fixed per-era appearance shift: deterministic channel
                # gain/bias plus a high-frequency hatch that era-0
                # backgrounds never contain
                drs = np.random.RandomState(771_000 + era)
                bg = bg * drs.uniform(0.55, 1.35, 3).astype(np.float32) \
                    + drs.uniform(-45, 45, 3).astype(np.float32)
                hang = drs.uniform(0, np.pi)
                u = xx * np.cos(hang) + yy * np.sin(hang)
                bg += 18.0 * (np.sin(u * drs.uniform(0.25, 0.45)) > 0
                              )[..., None].astype(np.float32)
        else:
            classes = rng.randint(1, self.num_classes, size=n_obj)
        img = bg
        lbl = np.zeros((s, s), np.uint8)
        for c in classes:
            cx, cy = rng.uniform(0.1 * s, 0.9 * s, 2)
            r = rng.uniform(s / 9, s / 4)
            theta = rng.uniform(0, np.pi)
            xr = (xx - cx) * np.cos(theta) + (yy - cy) * np.sin(theta)
            yr = -(xx - cx) * np.sin(theta) + (yy - cy) * np.cos(theta)
            shape = rng.randint(0, 6)
            if shape == 0:  # disk
                m = xr * xr + yr * yr < r * r
            elif shape == 1:  # ellipse
                a, b = r, r * rng.uniform(0.45, 0.8)
                m = (xr / a) ** 2 + (yr / b) ** 2 < 1.0
            elif shape == 2:  # rectangle
                a, b = r * rng.uniform(0.7, 1.2), r * rng.uniform(0.5, 0.9)
                m = (np.abs(xr) < a) & (np.abs(yr) < b)
            elif shape == 3:  # ring
                q = xr * xr + yr * yr
                m = (q < r * r) & (q > (0.55 * r) ** 2)
            elif shape == 4:  # triangle (half-plane intersection)
                m = (yr > -0.6 * r) & (yr + 2.2 * np.abs(xr) < 0.9 * r)
            else:  # cross
                m = ((np.abs(xr) < 0.33 * r) & (np.abs(yr) < r)) | (
                    (np.abs(yr) < 0.33 * r) & (np.abs(xr) < r)
                )
            if not m.any():
                continue
            # class-keyed texture with per-instance jitter
            freq = (0.06 + 0.015 * (c % 5)) * rng.uniform(0.8, 1.25)
            phase = rng.uniform(0, 2 * np.pi)
            tang = (c * 0.7) % np.pi + rng.uniform(-0.2, 0.2)
            u = xx * np.cos(tang) + yy * np.sin(tang)
            v = -xx * np.sin(tang) + yy * np.cos(tang)
            kind = c % 4
            if kind == 0:  # stripes
                t = 0.5 + 0.5 * np.sin(u * freq * 2 * np.pi + phase)
            elif kind == 1:  # checker
                t = (np.sin(u * freq * 2 * np.pi + phase)
                     * np.sin(v * freq * 2 * np.pi) > 0).astype(np.float32)
            elif kind == 2:  # dots
                t = (
                    (np.sin(u * freq * 2 * np.pi + phase) > 0.3)
                    & (np.sin(v * freq * 2 * np.pi + phase) > 0.3)
                ).astype(np.float32)
            else:  # smooth radial gradient
                t = 0.5 + 0.5 * np.cos(
                    np.sqrt(xr * xr + yr * yr) / max(r, 1.0) * np.pi
                )
            jit = rng.uniform(-20, 20, 3).astype(np.float32)
            tex = (col1[c] + jit) * t[..., None] + (col2[c] + jit) * (
                1.0 - t[..., None]
            )
            img = np.where(m[..., None], tex, img)
            lbl[m] = c

        gain = rng.uniform(0.75, 1.25)
        img = img * gain + rng.randn(s, s, 3) * 6.0
        return np.clip(img, 0, 255).astype(np.uint8), lbl

    def load_label(self, i: int) -> np.ndarray:
        return self.load(i)[1]


class DeviceCache:
    """The whole decoded set resident on the card (uint8 tensors), batches
    gathered there (``bacs_tpu/data/datasets.py:511-566``): the per-batch
    host decode and host-to-device copy disappear.  The first access
    decodes the full source on the host, once (a batch through
    ``load_batch`` where the source has one), and uploads it.  Wraps any
    source exposing ``load``/``load_label``."""

    def __init__(self, source, device: torch.device | str = "cuda"):
        self.source = source
        self.size = source.size
        self.class_names = source.class_names
        self.device = torch.device(device)
        self._imgs = None
        self._lbls = None
        self._host_lbls = None

    def __len__(self):
        return len(self.source)

    def _ensure(self):
        if self._imgs is not None:
            return
        # natively decoded where the source can, as JAX's (:537-549)
        loader = getattr(self.source, "load_batch", None)
        out = loader(list(range(len(self.source)))) if loader else None
        if out is None:
            pairs = [self.source.load(i) for i in range(len(self.source))]
            out = np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])
        self._host_lbls = out[1]
        self._imgs = torch.from_numpy(out[0]).to(self.device)
        self._lbls = torch.from_numpy(self._host_lbls).to(self.device)

    def load_batch(self, indices) -> Tuple[torch.Tensor, torch.Tensor]:
        """(images [n, s, s, 3], labels [n, s, s]) uint8 on the card."""
        self._ensure()
        idx = torch.as_tensor(np.asarray(indices, np.int64), device=self.device)
        return self._imgs.index_select(0, idx), self._lbls.index_select(0, idx)

    def load(self, i: int):
        img, lbl = self.load_batch([i])
        return img[0].cpu().numpy(), lbl[0].cpu().numpy()

    def load_label(self, i: int) -> np.ndarray:
        """A file-backed source's full-resolution label, as JAX's; else the
        label from the decoded set (a synthetic source's label costs a whole
        image's generation, so the scenario's label scan decodes the set
        once here)."""
        if hasattr(self.source, "label_paths"):
            return self.source.load_label(i)
        self._ensure()
        return self._host_lbls[i]


class DomainShiftedSource:
    """Wrap a source with a REAL per-domain appearance shift, so that
    domain forgetting is measurable on the synthetic source.  Each domain
    gets a fixed, deterministic color transform (per-channel gain/bias +
    channel permutation — a stand-in for Cityscapes' per-city appearance
    statistics, reference: dataset/cityscape_domain_dataset.py); labels
    are untouched, so class semantics stay constant across domains and
    any accuracy drop on old domains is genuine appearance forgetting.
    """

    def __init__(self, base, domain_ids):
        self.base = base
        self.domain_ids = list(domain_ids)
        self.class_names = base.class_names
        perms = [(0, 1, 2), (1, 2, 0), (2, 0, 1), (0, 2, 1), (2, 1, 0),
                 (1, 0, 2)]
        self._tx = {}
        for d in sorted(set(self.domain_ids)):
            rs = np.random.RandomState(9176 + d)
            self._tx[d] = (
                perms[d % len(perms)],
                rs.uniform(0.6, 1.2, 3).astype(np.float32),  # gain
                rs.uniform(-30, 30, 3).astype(np.float32),   # bias
            )

    def __len__(self):
        return len(self.base)

    def load(self, i: int):
        img, lbl = self.base.load(i)
        perm, gain, bias = self._tx[self.domain_ids[i]]
        out = img.astype(np.float32)[..., list(perm)] * gain + bias
        return np.clip(out, 0, 255).astype(np.uint8), lbl

    def load_label(self, i: int) -> np.ndarray:
        return self.base.load_label(i)


# ADE20K label names (published dataset metadata;
# reference: dataset/ade20k.py:56-208 MAP_LABELS)
ADE20K_CLASSES = [
    'background', 'wall', 'building;edifice', 'sky', 'floor;flooring',
    'tree', 'ceiling', 'road;route', 'bed', 'windowpane;window', 'grass',
    'cabinet', 'sidewalk;pavement', 'person', 'earth;ground',
    'door;double;door', 'table', 'mountain;mount', 'plant;flora;plant;life',
    'curtain;drape;drapery;mantle;pall', 'chair',
    'car;auto;automobile;machine;motorcar', 'water', 'painting;picture',
    'sofa;couch;lounge', 'shelf', 'house', 'sea', 'mirror',
    'rug;carpet;carpeting', 'field', 'armchair', 'seat', 'fence;fencing',
    'desk', 'rock;stone', 'wardrobe;closet;press', 'lamp',
    'bathtub;bathing;tub;bath;tub', 'railing;rail', 'cushion',
    'base;pedestal;stand', 'box', 'column;pillar', 'signboard;sign',
    'chest;of;drawers;chest;bureau;dresser', 'counter', 'sand', 'sink',
    'skyscraper', 'fireplace;hearth;open;fireplace', 'refrigerator;icebox',
    'grandstand;covered;stand', 'path', 'stairs;steps', 'runway',
    'case;display;case;showcase;vitrine',
    'pool;table;billiard;table;snooker;table', 'pillow',
    'screen;door;screen', 'stairway;staircase', 'river', 'bridge;span',
    'bookcase', 'blind;screen', 'coffee;table;cocktail;table',
    'toilet;can;commode;crapper;pot;potty;stool', 'flower', 'book', 'hill',
    'bench', 'countertop', 'stove;kitchen;stove;range;kitchen;cooking;stove',
    'palm;palm;tree', 'kitchen;island', 'computer', 'swivel;chair', 'boat',
    'bar', 'arcade;machine', 'hovel;hut;hutch;shack;shanty',
    'bus;coach;double-decker;passenger;vehicle', 'towel',
    'light;light;source', 'truck;motortruck', 'tower',
    'chandelier;pendant;pendent', 'awning;sunshade;sunblind',
    'streetlight;street;lamp', 'booth;cubicle;stall;kiosk', 'television',
    'airplane;aeroplane;plane', 'dirt;track',
    'apparel;wearing;apparel;dress;clothes', 'pole', 'land;ground;soil',
    'bannister;banister;balustrade;balusters;handrail',
    'escalator;moving;staircase;moving;stairway',
    'ottoman;pouf;pouffe;puff;hassock', 'bottle', 'buffet;counter;sideboard',
    'poster;posting;placard;notice;bill;card', 'stage', 'van', 'ship',
    'fountain', 'conveyer;belt;conveyor;belt;conveyor;transporter', 'canopy',
    'washer;automatic;washer;washing;machine', 'plaything;toy',
    'swimming;pool;swimming;bath;natatorium', 'stool', 'barrel;cask',
    'basket;handbasket', 'waterfall;falls', 'tent;collapsible;shelter',
    'bag', 'minibike;motorbike', 'cradle', 'oven', 'ball', 'food;solid;food',
    'step;stair', 'tank;storage;tank', 'trade;name;brand;name;brand;marque',
    'microwave;microwave;oven', 'pot;flowerpot',
    'animal;animate;being;beast;brute;creature;fauna',
    'bicycle;bike;wheel;cycle', 'lake',
    'dishwasher;dish;washer;dishwashing;machine',
    'screen;silver;screen;projection;screen', 'blanket;cover', 'sculpture',
    'hood;exhaust;hood', 'sconce', 'vase',
    'traffic;light;traffic;signal;stoplight', 'tray',
    'trash;can;garbage;wastebin;bin;ashbin;dustbin;barrel;bin', 'fan',
    'pier;wharf;wharfage;dock', 'crt;screen', 'plate',
    'monitor;monitoring;device', 'bulletin;board;notice;board', 'shower',
    'radiator', 'glass;drinking;glass', 'clock', 'flag',
]


# Cityscapes trainid names (published dataset metadata;
# reference: dataset/cityscape_dataset.py:50-72 map_labels)
CITYSCAPES_CLASSES = [
    'background', 'road', 'sidewalk', 'building', 'wall', 'fence', 'pole',
    'traffic light', 'traffic sign', 'vegetation', 'terrain', 'sky',
    'person', 'rider', 'car', 'truck', 'bus', 'train', 'motorcycle',
    'bicycle',
]


def make_voc_source(root: str, split: str, size: int) -> FolderSource:
    """VOC2012-aug (reference: dataset/voc.py:92-147): SegmentationClassAug
    masks with train_aug.txt / val list files."""
    root = os.path.expanduser(root)
    voc_root = os.path.join(root, "VOCdevkit", "VOC2012")
    if not os.path.isdir(voc_root):
        raise FileNotFoundError(
            f"VOC root {voc_root} not found; download VOC2012 + "
            "SegmentationClassAug there (no network egress in this env)."
        )
    if split == "train":
        list_file = os.path.join(voc_root, "ImageSets", "Segmentation", "train_aug.txt")
        mask_dir = os.path.join(voc_root, "SegmentationClassAug")
        if not os.path.exists(list_file):
            # the reference downloader drops train_aug.txt at the voc root
            # (dataset/voc.py:100-105)
            list_file = os.path.join(voc_root, "train_aug.txt")
        if not os.path.exists(list_file):
            list_file = os.path.join(voc_root, "ImageSets", "Segmentation", "train.txt")
            mask_dir = os.path.join(voc_root, "SegmentationClass")
    else:
        list_file = os.path.join(voc_root, "ImageSets", "Segmentation", "val.txt")
        mask_dir = os.path.join(voc_root, "SegmentationClass")
        if not os.path.isdir(mask_dir):
            mask_dir = os.path.join(voc_root, "SegmentationClassAug")
    with open(list_file) as f:
        names = [line.strip().split()[0] for line in f if line.strip()]
    names = [os.path.splitext(os.path.basename(n))[0] for n in names]
    imgs = [os.path.join(voc_root, "JPEGImages", f"{n}.jpg") for n in names]
    lbls = [os.path.join(mask_dir, f"{n}.png") for n in names]
    return FolderSource(imgs, lbls, size, VOC_CLASSES)


def make_ade_source(root: str, split: str, size: int) -> FolderSource:
    """ADE20K (reference: dataset/ade20k.py): 150 fg classes + bg = 151."""
    root = os.path.expanduser(root)
    base = os.path.join(root, "ADEChallengeData2016")
    sub = "training" if split == "train" else "validation"
    img_dir = os.path.join(base, "images", sub)
    ann_dir = os.path.join(base, "annotations", sub)
    if not os.path.isdir(img_dir):
        raise FileNotFoundError(f"ADE20K root {img_dir} not found")
    names = sorted(os.listdir(img_dir))
    imgs = [os.path.join(img_dir, n) for n in names]
    lbls = [
        os.path.join(ann_dir, os.path.splitext(n)[0] + ".png") for n in names
    ]
    class_names = list(ADE20K_CLASSES)
    return FolderSource(imgs, lbls, size, class_names)


def make_cityscapes_source(root: str, split: str, size: int) -> FolderSource:
    """Cityscapes (reference: dataset/cityscape_dataset.py): gtFine labelIds
    remapped id→trainid (20 classes incl. bg)."""
    root = os.path.expanduser(root)
    img_base = os.path.join(root, "leftImg8bit", split)
    ann_base = os.path.join(root, "gtFine", split)
    if not os.path.isdir(img_base):
        raise FileNotFoundError(f"Cityscapes root {img_base} not found")
    imgs: List[str] = []
    lbls: List[str] = []
    domain_ids: List[int] = []
    for ci, city in enumerate(sorted(os.listdir(img_base))):
        for name in sorted(os.listdir(os.path.join(img_base, city))):
            imgs.append(os.path.join(img_base, city, name))
            domain_ids.append(ci)
            lbls.append(
                os.path.join(
                    ann_base,
                    city,
                    name.replace("leftImg8bit", "gtFine_labelIds"),
                )
            )
    class_names = list(CITYSCAPES_CLASSES)
    src = FolderSource(
        imgs, lbls, size, class_names,
        label_remap=CITYSCAPES_ID_TO_TRAINID, remap_default=0,
    )
    src.domain_ids = domain_ids  # per-image city index (domain-shift mode)
    return src
