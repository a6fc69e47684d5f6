"""Dataset sources: VOC file-backed and synthetic, and the decoded caches.

Port of ``bacs_tpu/data/datasets.py``.  Each source exposes ``load(i) ->
(image uint8 [H, W, 3], label uint8 [H, W])`` at a fixed canonical size;
augmentation happens on the device (``data/transforms.py``).

- ``SyntheticSource`` (both styles, ``flat`` and ``rich``, and the era
  options): a numpy copy, bit-equal to the JAX package's images and labels.
- ``FolderSource`` and ``make_voc_source``: PIL decode, one image at a time
  (PIL is imported only when an image is decoded).
- ``DecodedCache`` (RAM mode) and ``DeviceCache``: the decoded set in host
  memory, or resident on the card as uint8 tensors with batches gathered
  there (``datasets.py:511-566``).

ROADMAP.md queue 1 item 7 (``create_datamodule`` raises on them): the
ADE20K and Cityscapes sources, ``DomainShiftedSource``, the native and
multi-process decoders.  The ``DecodedCache`` disk mode (memmaps for a
slow TPU host) is not ported.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

VOC_CLASSES = [
    "background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]


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
    """Generic (image, mask) path-list source, decoded with PIL one image at
    a time.  (The JAX class's label remap serves only the Cityscapes
    source, ROADMAP.md queue 1 item 7.)"""

    def __init__(
        self,
        image_paths: Sequence[str],
        label_paths: Sequence[str],
        size: int,
        class_names: Sequence[str],
    ):
        assert len(image_paths) == len(label_paths)
        self.image_paths = list(image_paths)
        self.label_paths = list(label_paths)
        self.size = size
        self.class_names = list(class_names)

    def __len__(self):
        return len(self.image_paths)

    def load(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        return _load_pair(self.image_paths[i], self.label_paths[i], self.size)

    def load_label(self, i: int) -> np.ndarray:
        from PIL import Image

        return np.asarray(Image.open(self.label_paths[i]), np.uint8)


class DecodedCache:
    """In-memory cache of a source's canonical decoded (image, label) pairs
    (``bacs_tpu/data/datasets.py:124-272``, its RAM mode): the first touch of
    a sample decodes and stores it, later epochs read the bytes.
    ``load_label`` passes through uncached (the class-set scan reads the
    full-resolution labels)."""

    def __init__(self, source, cache_dir: Optional[str] = None):
        if cache_dir is not None:
            raise NotImplementedError(
                "DecodedCache's disk mode (dataset.cache_decoded=disk) is not "
                "ported; use cache_decoded=ram or device")
        self.source = source
        self.size = source.size
        self.class_names = source.class_names
        n, s = len(source), source.size
        self._imgs = np.zeros((n, s, s, 3), np.uint8)
        self._lbls = np.zeros((n, s, s), np.uint8)
        self._valid = np.zeros((n,), bool)

    def __len__(self):
        return len(self.source)

    def load(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        if not self._valid[i]:
            self._imgs[i], self._lbls[i] = self.source.load(i)
            self._valid[i] = True
        return np.array(self._imgs[i]), np.array(self._lbls[i])

    def load_label(self, i: int) -> np.ndarray:
        return self.source.load_label(i)


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
    decodes the full source on the host, once, and uploads it.  Wraps any
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
        pairs = [self.source.load(i) for i in range(len(self.source))]
        self._host_lbls = np.stack([p[1] for p in pairs])
        self._imgs = torch.from_numpy(np.stack([p[0] for p in pairs])).to(self.device)
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
        """The label from the decoded set (a synthetic source's label costs
        a whole image's generation, so the scenario's label scan decodes
        the set once here)."""
        self._ensure()
        return self._host_lbls[i]


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
