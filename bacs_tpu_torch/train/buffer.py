"""The device-resident reservoir replay buffer.

Port of ``bacs_tpu/train/buffer.py`` (``:46-256``): preallocated tensors on
the train state's device hold, per slot, the image (bf16 normalized, or
uint8 pixels, which is lossless for canonical crops), the pre-upsample sem
logits padded to the final class count, the labels (uint8), the importance
(-loss; -inf while unset), the classes present (a bitmask with a trailing
column for the ignore label, which the reference counts like a class), the
task id, the class count when the logits were stored, and a valid flag.

- :func:`add_batch` is the reservoir with score-weighted eviction
  (reference ``buffer.py:138-172``): once full, an item replaces a slot
  drawn from ``_eviction_scores`` (0.3 normalized importance + 0.7 class
  balance) when floor(u * seen) < size.  It runs only at task ends, one
  item at a time with a host read per item (the slot it writes), as the
  JAX scan does per item.  ``uniforms`` injects the two [n] uniform streams
  (reservoir, eviction), so both packages make the same decisions.
- :func:`sample` draws a replay batch uniformly without replacement
  (Gumbel top-k over the valid slots, or over one task's) every train
  step, on the device and without a host read; ``keys`` injects the Gumbel
  keys.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from bacs_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD, normalize_image


@dataclasses.dataclass
class BufferState:
    images: torch.Tensor  # [B, H, W, 3] bf16 normalized, or uint8 pixels
    logits: torch.Tensor  # [B, h, w, C_total]
    labels: torch.Tensor  # [B, H, W] uint8
    importance: torch.Tensor  # [B] f32 (-loss; -inf = unset)
    label_mask: torch.Tensor  # [B, C_total + 1] bool, last column: ignore label
    task_ids: torch.Tensor  # [B] int32
    n_classes: torch.Tensor  # [B] int32
    valid: torch.Tensor  # [B] bool
    class_counts: torch.Tensor  # [C_total + 1] int32
    num_seen: int = 0  # items offered to the reservoir so far

    @property
    def size(self) -> int:
        return self.images.shape[0]

    def to(self, device: torch.device | str) -> "BufferState":
        """A copy on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
            if torch.is_tensor(getattr(self, f.name))})


def _encode_image(img: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Normalized float image -> storage dtype; uint8 rounds the pixels
    (lossless for images that came from uint8 pixels)."""
    if dtype == torch.uint8:
        mean = torch.tensor(IMAGENET_MEAN, device=img.device)
        std = torch.tensor(IMAGENET_STD, device=img.device)
        x = img * std + mean
        return torch.round(torch.clamp(x * 255.0, 0, 255)).to(torch.uint8)
    return img.to(dtype)


def _decode_image(img: torch.Tensor) -> torch.Tensor:
    return normalize_image(img) if img.dtype == torch.uint8 else img.float()


def init_buffer(
    buffer_size: int,
    image_hw: Tuple[int, int],
    logit_hw: Tuple[int, int],
    num_classes: int,
    image_dtype: torch.dtype = torch.bfloat16,
    logit_dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cuda",
) -> BufferState:
    """An empty buffer of ``buffer_size`` slots on ``device``.  Asking for
    CUDA where torch sees none raises; nothing falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "init_buffer(device='cuda') but torch sees no CUDA device; pass "
            "device='cpu' to keep the buffer on the CPU"
        )
    h, w = image_hw
    lh, lw = logit_hw
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)  # noqa: E731
    return BufferState(
        images=z((buffer_size, h, w, 3), image_dtype),
        logits=z((buffer_size, lh, lw, num_classes), logit_dtype),
        labels=z((buffer_size, h, w), torch.uint8),
        importance=torch.full((buffer_size,), -torch.inf, device=device),
        label_mask=z((buffer_size, num_classes + 1), torch.bool),
        task_ids=z((buffer_size,), torch.int32),
        n_classes=z((buffer_size,), torch.int32),
        valid=z((buffer_size,), torch.bool),
        class_counts=z((num_classes + 1,), torch.int32),
    )


def _eviction_scores(buf: BufferState) -> torch.Tensor:
    """Eviction distribution over slots (reference ``buffer.py:145-163``):
    balance = the least count among a slot's non-background classes,
    importance scaled by mean|imp| * mean|balance|, blended 0.3/0.7, then
    min-max normalized and divided by its sum."""
    counts = buf.class_counts.float()
    present = buf.label_mask.clone()
    present[:, 0] = False
    balance = torch.where(present, counts[None, :], torch.inf).amin(dim=1)
    balance = torch.where(torch.isfinite(balance), balance, 0.0)
    imp = buf.importance
    imp = torch.where(torch.isfinite(imp), imp, 0.0)
    scaling = imp.abs().mean() * balance.abs().mean()
    pre = 0.3 * (imp / torch.clamp(scaling, min=1e-8)) + 0.7 * balance
    span = pre.max() - pre.min()
    pre = torch.where(span > 0, (pre - pre.min()) / torch.clamp(span, min=1e-8), pre)
    total = pre.sum()
    return torch.where(total > 0, pre / torch.clamp(total, min=1e-8),
                       torch.full_like(pre, 1.0 / pre.shape[0]))


def add_batch(
    buf: BufferState,
    images: torch.Tensor,
    logits: torch.Tensor,
    labels: torch.Tensor,
    losses: torch.Tensor,
    task_id: int,
    n_classes: int,
    ignore_index: int = 255,
    uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
) -> BufferState:
    """Reservoir-add a batch, in place; returns ``buf``.

    ``logits`` are already padded to the buffer's class width.  ``uniforms``
    is a pair of [n] uniform [0, 1) tensors (reservoir draw, eviction draw)
    used in place of draws from ``generator``.  Every item records the
    batch-wide label set (the reference reads the whole batch's unique
    labels inside its per-item loop, ``buffer.py:240-252``).
    """
    m = buf.size
    n_cols = buf.class_counts.shape[0]
    n_items = images.shape[0]
    dev = buf.images.device
    if uniforms is None:
        u_res, u_evict = torch.rand((2, n_items), generator=generator, device=dev)
    else:
        u_res, u_evict = (u.to(dev, torch.float32) for u in uniforms)
    ext = torch.where(labels == ignore_index, n_cols - 1, labels.long()).reshape(-1)
    batch_mask = torch.zeros(n_cols, dtype=torch.bool, device=dev)
    batch_mask[ext.to(dev)] = True
    for k in range(n_items):
        n = buf.num_seen
        idx = n if n < m else -1
        if n >= m and int(torch.floor(u_res[k] * float(max(n, 1)))) < m:
            cdf = torch.cumsum(_eviction_scores(buf), 0)
            cdf = cdf / torch.clamp(cdf[-1], min=1e-30)
            evict = torch.searchsorted(cdf, u_evict[k:k + 1], right=True)
            idx = min(int(evict), m - 1)
        if idx >= 0:
            old = buf.label_mask[idx] & buf.valid[idx]
            counts = buf.class_counts - old.int() + batch_mask.int()
            counts[0] = 0  # background is not tracked
            buf.class_counts = counts
            buf.images[idx] = _encode_image(images[k], buf.images.dtype)
            buf.logits[idx] = logits[k].to(buf.logits.dtype)
            buf.labels[idx] = labels[k].to(torch.uint8)
            buf.importance[idx] = losses[k]
            buf.label_mask[idx] = batch_mask
            buf.task_ids[idx] = task_id
            buf.n_classes[idx] = n_classes
            buf.valid[idx] = True
        buf.num_seen = n + 1
    return buf


def sample(
    buf: BufferState,
    batch_size: int,
    generator: Optional[torch.Generator] = None,
    keys: Optional[torch.Tensor] = None,
    task_id: Optional[torch.Tensor | int] = None,
) -> dict:
    """A replay batch, uniform without replacement over the valid slots
    (with ``task_id``, a device or Python integer, over the valid slots of
    that task; ``bacs_tpu/train/buffer.py:231-256``): the top
    ``batch_size`` of Gumbel keys (``keys``, or drawn from ``generator``)
    with the other slots at -inf.  No host read."""
    dev = buf.images.device
    if keys is None:
        tiny = torch.finfo(torch.float32).tiny
        u = torch.rand(buf.size, generator=generator, device=dev).clamp_(min=tiny)
        keys = -torch.log(-torch.log(u))
    eligible = buf.valid
    if task_id is not None:
        eligible = eligible & (buf.task_ids == task_id)
    keys = torch.where(eligible, keys.to(dev), -torch.inf)
    idx = torch.topk(keys, batch_size).indices
    return {
        "images": _decode_image(buf.images[idx]),
        "logits": buf.logits[idx].float(),
        "labels": buf.labels[idx].int(),
        "n_classes": buf.n_classes[idx],
        "indices": idx,
    }
