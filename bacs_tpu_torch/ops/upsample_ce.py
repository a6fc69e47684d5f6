"""Fused bilinear upsample + a softmax loss: the full-res logits never exist.

Port of the fused losses of ``bacs_tpu/ops/upsample_ce.py`` that the CE,
BACS, MiB and PLOP steps run.  Each loss is a function of
bilinear_upsample(sem_logits) and the labels (K7: of two upsampled logit
tensors); at 512^2, batch 16, VOC-21 the upsampled logits alone would be
352 MB of f32.  Six kernels, on the templates of ``csrc/upsample_ce.cuh``,
each loss's entry points a source of its own (``upsample_ce.cu``: K1 and
K8; ``upsample_bacs.cu``: K3; ``upsample_wce.cu``: K4; ``upsample_uce.cu``:
K6; ``upsample_ukd.cu``: K7), so that nvcc compiles them in parallel
(PLOP's pseudo-labels, K9, are in ``ops/upsample_pseudo.py``):

- K1, plain CE (the CE step; the eval loss).  :func:`ce_sums_per_image`
  (forward: per image, the NLL sum over valid pixels and the valid count;
  replaces ``_ce_sums_per_image_pallas``, ``upsample_ce.py:787``) and
  :func:`ce_dsem` (backward, replaces ``_dsem_pallas``, ``:125``; plain
  version the jnp branch of ``_uces_bwd``, ``:159-174``).
  :func:`upsampled_cross_entropy` divides by max(count, 1).
- K4, class-weighted CE (the dark++ replay term of BACS).
  :func:`wce_sums` (forward: Σ w[y] NLL and Σ w[y]; replaces
  ``_wce_sums_pallas``, ``:233``) and :func:`wce_dsem` (backward, replaces
  ``_dsem_pallas_w``, ``:243``; plain version the jnp branch of
  ``_uwces_bwd``, ``:287-296``).  The weights are a constant and take no
  gradient.  :func:`upsampled_weighted_cross_entropy` divides by
  max(Σ w, 1e-8), so a batch with no weighted pixel gives 0.
- K3, the BACS seen-weighted CE (the incremental step's main loss).
  :func:`bacs_sum` (forward: the sum over pixels of the focal bg/fg and
  new-vs-rest terms, weighted by the per-pixel max seen-probability
  ``max_seen`` [N, H, W] f32 at full resolution, which takes no gradient;
  replaces ``_bacs_pallas``, ``:396``) and :func:`bacs_dsem` (backward,
  the same TPU kernel with ``want_grad``).  Its plain forward is
  :func:`upsample_plain` + ``losses.weighted_cross_entropy`` times N H W
  (``_bacs_wce_sum_jnp``, ``:326-338``), its plain backward autograd
  through that, as JAX's ``jax.grad`` fallback (``:464-467``): independent
  of the kernel's hand-derived gradient.
  :func:`upsampled_bacs_weighted_ce` divides by N H W (the mean over all
  pixels, ignored ones included, of the reference).
- K8, K1's backward with one cotangent per image (PLOP's adaptive
  factor): :func:`ce_dsem_per_image` (replaces ``_dsem_pallas(per_image=
  True)``, ``:125``; plain version the jnp branch of ``_ucespi_bwd``,
  ``:823-831``).  :func:`upsampled_ce_sums_per_image` returns the K1
  forward's per-image sums and counts and takes its backward here.
- K6, MiB's unbiased CE: :func:`uce_sums` (forward: per image, the sum
  over valid pixels and the valid count; replaces ``_uce_pallas``,
  ``:543``) and :func:`uce_dsem` (backward, the same TPU kernel with
  ``want_grad``).  Plain forward :func:`upsample_plain` +
  ``losses.unbiased_cross_entropy`` (``_uce_sums_jnp``, ``:504-512``),
  plain backward autograd through it.  MiB divides the sum by N H W;
  :func:`upsampled_unbiased_cross_entropy` by max(count, 1).
- K7, MiB's unbiased KD of a student/teacher pair: :func:`ukd_sum`
  (forward: the sum T over every output pixel; replaces ``_ukd_pallas``,
  ``:695``) and :func:`ukd_dsem` (the student's backward; the teacher takes
  none).  Plain forward both upsamples + ``unbiased_knowledge_distillation``
  times -N H W (``_ukd_sum_jnp``, ``:648-655``), plain backward autograd.
  :func:`upsampled_unbiased_kd` is -T / (N H W).

Each wrapper launches its kernel for a CUDA tensor (or raises) and runs its
plain version for a CPU tensor; its ``launches`` attribute counts kernel
calls.  The ``upsampled_*`` functions are differentiable in ``sem_logits``
only (``torch.autograd.Function``s whose backward is the kernel's
backward); autograd hands the backward the mean's scale as a device
scalar.  The plain versions upsample with the ``interp_matrix`` einsums in
f32 (``upsample_tiles.py``).  Labels other than ``ignore_index`` are
expected in [0, C); one outside picks no logit, as the TPU kernels'
one-hot.  Bounds and tolerances are in the kernels' source note.  The
kernels of K1, K3, K4, K6, K7 and K8 (and K2, K9 and K10, in their own
modules) read their bilinear taps and their bands of output rows from int32
tables built here with ``interp_matrix``'s arithmetic (:func:`launch_plan`,
cached per shape on the device; K7's stage holds the teacher's channels
beside the student's).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from bacs_tpu_torch.kernels import build
from bacs_tpu_torch.ops.losses import (
    cross_entropy, unbiased_cross_entropy, unbiased_knowledge_distillation,
    weighted_cross_entropy)
from bacs_tpu_torch.ops.upsample_tiles import kmats

# the launch plan of the staged kernels (csrc/upsample_stage.cuh: K1, K3, K4,
# K6-K8 on csrc/upsample_ce.cuh, K9 and K10)
TILE = 256  # output pixels per tile, one a thread
CHUNK = 32  # the widest chunk of channels the kernels hold in registers (KC)
TARGET_BLOCKS = 1024  # bands x images: about 8 blocks for each of the H100's 132 SMs
SMEM_MAX = 232448  # bytes of shared memory a block may use on Hopper


def upsample_plain(sem: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """f32 [n, H, W, c] bilinear upsample as the two ``interp_matrix`` einsums."""
    kh, kw = (torch.from_numpy(k).to(sem.device) for k in kmats(sem.shape, out_hw))
    up = torch.einsum("Hh,nhwc->nHwc", kh, sem.float())
    return torch.einsum("Ww,nHwc->nHWc", kw, up)


def upsampled_argmax_nearest(sem: torch.Tensor, out_hw: Tuple[int, int],
                             down_hw: Tuple[int, int]) -> torch.Tensor:
    """``resize_nearest(argmax(upsample(sem, out_hw)), down_hw)`` without the
    full-resolution tensor (``bacs_tpu/ops/upsample_ce.py:623-649``): nearest
    picks the output rows and columns floor(i * out / down), so only those
    rows of the two interpolation matrices are applied, in f32.  SDR's
    prototype distillation reads the teacher's downsampled argmax this way.
    JAX computes it as two einsums outside any Pallas kernel, and so does
    this, on the tensor's device."""
    kh, kw = kmats(sem.shape, out_hw)
    ys = np.clip(np.floor(np.arange(down_hw[0]) * (out_hw[0] / down_hw[0])).astype(np.int64),
                 0, out_hw[0] - 1)
    xs = np.clip(np.floor(np.arange(down_hw[1]) * (out_hw[1] / down_hw[1])).astype(np.int64),
                 0, out_hw[1] - 1)
    kh, kw = (torch.from_numpy(np.ascontiguousarray(k)).to(sem.device)
              for k in (kh[ys], kw[xs]))
    up = torch.einsum("Hh,nhwc->nHwc", kh, sem.float())
    return torch.einsum("Ww,nHwc->nHWc", kw, up).argmax(dim=-1)


def _picked(up: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor):
    """(the label's logit, 0 where the label is invalid or out of range;
    the one-hot of the label, zero there too)."""
    c = up.shape[-1]
    onehot = (torch.arange(c, device=up.device) == labels.unsqueeze(-1)) & valid.unsqueeze(-1)
    return (up * onehot).sum(-1), onehot.float()


def ce_sums_plain(sem, labels, out_hw, ignore_index=255):
    """Plain version of K1 forward: ([n] NLL sums, [n] valid counts), f32."""
    up = upsample_plain(sem, out_hw)
    valid = labels != ignore_index
    lab, _ = _picked(up, labels, valid)
    nll = (torch.logsumexp(up, dim=-1) - lab) * valid
    return nll.sum(dim=(1, 2)), valid.sum(dim=(1, 2)).float()


def ce_dsem_plain(sem, labels, out_hw, g, ignore_index=255):
    """Plain version of K1 backward: K_H^T ((softmax - onehot) valid g) K_W,
    in sem's dtype."""
    kh, kw = (torch.from_numpy(k).to(sem.device) for k in kmats(sem.shape, out_hw))
    up = upsample_plain(sem, out_hw)
    valid = labels != ignore_index
    _, onehot = _picked(up, labels, valid)
    dup = (torch.softmax(up, dim=-1) - onehot) * (valid.unsqueeze(-1) * g)
    dsem = torch.einsum("Ww,nHWc->nHwc", kw, dup)
    return torch.einsum("Hh,nHwc->nhwc", kh, dsem).to(sem.dtype)


def check_inputs(sem, labels, out_hw):
    """Raise unless a kernel of this family takes (sem, labels, out_hw);
    returns (n, h, w, c, H, W)."""
    if sem.device.type != "cuda":
        raise ValueError(f"kernel needs a CUDA tensor, got {sem.device}")
    if sem.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"sem must be float32 or bfloat16, got {sem.dtype}")
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"labels must be int32 or int64, got {labels.dtype}")
    if sem.dim() != 4 or not sem.is_contiguous():
        raise ValueError("sem must be a contiguous [n, h, w, c] tensor")
    n, h, w, c = sem.shape
    H, W = (int(d) for d in out_hw)
    if (labels.shape != (n, H, W) or not labels.is_contiguous()
            or labels.device != sem.device):
        raise ValueError(f"labels must be a contiguous [{n}, {H}, {W}] tensor on "
                         f"{sem.device}, got {tuple(labels.shape)} on {labels.device}")
    if min(n, h, w, c, H, W) < 1:
        raise ValueError(f"unsupported shape {tuple(sem.shape)} -> {(H, W)}")
    return n, h, w, c, H, W


def _check_g(g, sem, numel=1):
    if (g.numel() != numel or g.dtype != torch.float32 or g.device != sem.device
            or not g.is_contiguous()):
        raise ValueError(f"g must be {numel} float32 value(s) on {sem.device}, got "
                         f"{g.dtype} {tuple(g.shape)} on {g.device}")


def _check_weights(weights, sem):
    c = sem.shape[-1]
    if (weights.shape != (c,) or weights.dtype != torch.float32
            or weights.device != sem.device or not weights.is_contiguous()):
        raise ValueError(f"class weights must be a contiguous float32 [{c}] tensor "
                         f"on {sem.device}, got {weights.dtype} "
                         f"{tuple(weights.shape)} on {weights.device}")


def _check_max_seen(max_seen, labels):
    if (max_seen.shape != labels.shape or max_seen.dtype != torch.float32
            or max_seen.device != labels.device or not max_seen.is_contiguous()):
        raise ValueError(f"max_seen must be a contiguous float32 {tuple(labels.shape)} "
                         f"tensor on {labels.device}, got {max_seen.dtype} "
                         f"{tuple(max_seen.shape)} on {max_seen.device}")


# ---------------------------------------------------------------- launch plan


def tap_tables(out_dim: int, in_dim: int) -> dict:
    """The taps of ``interp_matrix(out_dim, in_dim)`` as tables, with its
    arithmetic: per output index ``lo``, ``hi`` (int32) and ``wt`` (f32),
    the entry being ``1 - wt`` at lo plus ``wt`` at hi; per source index the
    output indices whose lo (``lo_first``..``lo_last``) or hi
    (``hi_first``..``hi_last``) it is, with a nonzero weight (first > last
    where there are none).  Output indices are in order of their source
    coordinate, so each range is contiguous."""
    coords = (np.arange(out_dim) + 0.5) * (in_dim / out_dim) - 0.5
    coords = np.clip(coords, 0, in_dim - 1)
    lo = np.floor(coords).astype(np.int64)
    hi = np.clip(lo + 1, 0, in_dim - 1)
    wt = (coords - lo).astype(np.float32)
    out = {"lo": lo.astype(np.int32), "hi": hi.astype(np.int32), "wt": wt}
    for name, src, weight in (("lo", lo, np.float32(1.0) - wt), ("hi", hi, wt)):
        first = np.full(in_dim, out_dim, np.int32)
        last = np.full(in_dim, -1, np.int32)
        o = np.flatnonzero(weight != 0)
        np.minimum.at(first, src[o], o.astype(np.int32))
        np.maximum.at(last, src[o], o.astype(np.int32))
        out[f"{name}_first"], out[f"{name}_last"] = first, last
    return out


def band_plan(ty: dict, in_dim: int, band: int) -> dict:
    """The bands of ``band`` output rows a gradient launch takes: per band
    ``y0`` (the first source row it touches) and ``rows`` (how many); per
    source row the bands that touch it (``first``..``last``, first > last
    where none); ``max_rows``, the largest band's slab."""
    out_dim = len(ty["lo"])
    starts = np.arange(0, out_dim, band)
    ends = np.minimum(starts + band, out_dim) - 1
    y0 = ty["lo"][starts]
    rows = ty["hi"][ends] - y0 + 1
    first = np.zeros(in_dim, np.int32)
    last = np.full(in_dim, -1, np.int32)
    for b in range(len(starts) - 1, -1, -1):
        first[y0[b]:y0[b] + rows[b]] = b
    for b in range(len(starts)):
        last[y0[b]:y0[b] + rows[b]] = b
    return {"y0": y0.astype(np.int32), "rows": rows.astype(np.int32), "first": first,
            "last": last, "max_rows": int(rows.max())}


def tile_span(tx: dict, tile: int) -> int:
    """The most source columns a tile of ``tile`` output columns reads."""
    starts = np.arange(0, len(tx["lo"]), tile)
    ends = np.minimum(starts + tile, len(tx["lo"])) - 1
    return int((tx["hi"][ends] - tx["lo"][starts] + 1).max())


def grad_smem_bytes(tile: int, span: int, c: int) -> int:
    """Shared memory of the gradient kernel without its accumulator, at the
    widest chunk (``grad_smem_floats`` in csrc/upsample_ce.cuh): the gradient
    tile times its two W weights, ``tile`` x 2 (CHUNK + 1) floats, and the
    stage, ``span`` x (c | 1), ``c`` the channels staged per source column
    (K7: the student's and the teacher's)."""
    return 4 * (tile * 2 * (CHUNK + 1) + span * (c | 1))


@functools.lru_cache(maxsize=64)
def _plan_numpy(n, h, w, c, H, W, c_old=0):
    tx, ty = tap_tables(W, w), tap_tables(H, h)
    band = max(1, min(H, -(-n * H // TARGET_BLOCKS)))
    staged = c + c_old
    tile = TILE
    while tile > 1 and grad_smem_bytes(tile, tile_span(tx, tile), staged) > SMEM_MAX:
        tile //= 2
    span = tile_span(tx, tile)
    if grad_smem_bytes(tile, span, staged) > SMEM_MAX:
        raise ValueError(f"{staged} channels do not fit the kernel's shared memory")
    bands = band_plan(ty, h, band)
    tables = np.concatenate([
        tx["lo"], tx["hi"], tx["wt"].view(np.int32), tx["lo_first"], tx["lo_last"],
        tx["hi_first"], tx["hi_last"], ty["lo"], ty["hi"], ty["wt"].view(np.int32),
        bands["y0"], bands["first"], bands["last"]])
    return tables, (band, tile, span, bands["max_rows"]), len(bands["y0"])


_device_tables = {}


def launch_plan(n, h, w, c, H, W, device, c_old=0):
    """(int32 tap tables on ``device``, (band, tile, span, rows), bands):
    the layout ``Plan`` in csrc/upsample_stage.cuh reads (K1-K4,
    K6-K10), cached per shape; ``c_old``, K7's teacher channels, staged
    beside the student's c."""
    tables, args, nb = _plan_numpy(n, h, w, c, H, W, c_old)
    key = (n, h, w, c, H, W, c_old, str(device))
    if key not in _device_tables:
        _device_tables[key] = torch.from_numpy(tables).to(device)
    return _device_tables[key], args, nb


def _launch_sums(entry, sem, labels, out_hw, ignore_index, extra=()):
    """One forward entry point of the family (``csrc/upsample_ce.cuh``):
    per-image ([n] first sums, [n] second sums), f32."""
    n, h, w, c, H, W = check_inputs(sem, labels, out_hw)
    tables, args, nb = launch_plan(n, h, w, c, H, W, sem.device)
    partials = torch.empty((n, nb, 2), dtype=torch.float32, device=sem.device)
    a = torch.empty((n,), dtype=torch.float32, device=sem.device)
    b = torch.empty((n,), dtype=torch.float32, device=sem.device)
    lib = build.load_library()
    with torch.cuda.device(sem.device):
        code = getattr(lib, entry)(
            sem.data_ptr(), int(sem.dtype == torch.bfloat16), labels.data_ptr(),
            int(labels.dtype == torch.int64), n, h, w, c, H, W, int(ignore_index),
            *extra, tables.data_ptr(), *args, partials.data_ptr(), a.data_ptr(),
            b.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    build.check(code, entry)
    return a, b


def _launch_grad(entry, sem, labels, out_hw, g, ignore_index, extra=(),
                 g_numel=1):
    """One gradient entry point of the family (``csrc/upsample_ce.cuh``):
    dsem in sem's dtype; ``g`` holds ``g_numel`` f32 values (1, or one per
    image)."""
    n, h, w, c, H, W = check_inputs(sem, labels, out_hw)
    _check_g(g, sem, g_numel)
    tables, args, nb = launch_plan(n, h, w, c, H, W, sem.device)
    partials = torch.empty((n, nb, args[3], w, c), dtype=torch.float32, device=sem.device)
    dsem = torch.empty_like(sem)
    lib = build.load_library()
    with torch.cuda.device(sem.device):
        code = getattr(lib, entry)(
            sem.data_ptr(), int(sem.dtype == torch.bfloat16), labels.data_ptr(),
            int(labels.dtype == torch.int64), n, h, w, c, H, W, int(ignore_index),
            *extra, g.data_ptr(), tables.data_ptr(), *args, partials.data_ptr(),
            dsem.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    build.check(code, entry)
    return dsem


# ---------------------------------------------------------------- K1: plain CE


def ce_sums_per_image(sem, labels, out_hw, ignore_index=255):
    """K1 forward: ([n] Σ NLL over valid pixels, [n] valid count), f32.
    CPU tensors take the plain version, CUDA tensors the kernel."""
    if sem.device.type == "cpu":
        return ce_sums_plain(sem, labels, out_hw, ignore_index)
    out = _launch_sums("upsample_ce_sums", sem, labels, out_hw, ignore_index)
    ce_sums_per_image.launches += 1
    return out


def ce_dsem(sem, labels, out_hw, g, ignore_index=255):
    """K1 backward: d(Σ NLL)/d(sem) times the scalar tensor ``g``, in sem's
    dtype.  CPU tensors take the plain version, CUDA tensors the kernel."""
    if sem.device.type == "cpu":
        return ce_dsem_plain(sem, labels, out_hw, g, ignore_index)
    dsem = _launch_grad("upsample_ce_grad", sem, labels, out_hw, g, ignore_index)
    ce_dsem.launches += 1
    return dsem


def ce_dsem_per_image_plain(sem, labels, out_hw, g, ignore_index=255):
    """Plain version of K8: :func:`ce_dsem_plain` with image n's pixels
    scaled by g[n]."""
    return ce_dsem_plain(sem, labels, out_hw, g.float().reshape(-1, 1, 1, 1),
                         ignore_index)


def ce_dsem_per_image(sem, labels, out_hw, g, ignore_index=255):
    """K8: d(Σ_n g[n] NLL_n)/d(sem), ``g`` f32 [n], in sem's dtype.  CPU
    tensors take the plain version, CUDA tensors the kernel."""
    if sem.device.type == "cpu":
        return ce_dsem_per_image_plain(sem, labels, out_hw, g, ignore_index)
    dsem = _launch_grad("upsample_ce_grad_per_image", sem, labels, out_hw, g,
                        ignore_index, g_numel=sem.shape[0])
    ce_dsem_per_image.launches += 1
    return dsem


ce_sums_per_image.launches = 0
ce_dsem.launches = 0
ce_dsem_per_image.launches = 0


class _UpsampledCESums(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sem, labels, out_hw, ignore_index):
        loss, count = ce_sums_per_image(sem, labels, out_hw, ignore_index)
        ctx.save_for_backward(sem, labels)
        ctx.out_hw, ctx.ignore_index = out_hw, ignore_index
        count = count.sum()
        ctx.mark_non_differentiable(count)
        return loss.sum(), count

    @staticmethod
    def backward(ctx, g_sum, _g_count):
        sem, labels = ctx.saved_tensors
        g = g_sum.float().contiguous()
        return ce_dsem(sem, labels, ctx.out_hw, g, ctx.ignore_index), None, None, None


def upsampled_ce_sums(
    sem_logits: torch.Tensor,
    labels: torch.Tensor,
    out_hw: Tuple[int, int],
    ignore_index: int = 255,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Σ CE(upsample(sem), labels) over valid pixels, valid count), both
    f32 scalars; differentiable in ``sem_logits`` only."""
    return _UpsampledCESums.apply(sem_logits, labels, tuple(int(d) for d in out_hw),
                                  int(ignore_index))


class _UpsampledCESumsPerImage(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sem, labels, out_hw, ignore_index):
        loss, count = ce_sums_per_image(sem, labels, out_hw, ignore_index)
        ctx.save_for_backward(sem, labels)
        ctx.out_hw, ctx.ignore_index = out_hw, ignore_index
        ctx.mark_non_differentiable(count)
        return loss, count

    @staticmethod
    def backward(ctx, g_loss, _g_count):
        sem, labels = ctx.saved_tensors
        dsem = ce_dsem_per_image(sem, labels, ctx.out_hw, g_loss.float().contiguous(),
                                 ctx.ignore_index)
        return dsem, None, None, None


def upsampled_ce_sums_per_image(
    sem_logits: torch.Tensor,
    labels: torch.Tensor,
    out_hw: Tuple[int, int],
    ignore_index: int = 255,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """([n] Σ CE(upsample(sem), labels) over each image's valid pixels, [n]
    valid counts), f32; differentiable in ``sem_logits`` only: the forward
    is K1's, the backward K8."""
    return _UpsampledCESumsPerImage.apply(sem_logits, labels,
                                          tuple(int(d) for d in out_hw), int(ignore_index))


def upsampled_cross_entropy(
    sem_logits: torch.Tensor,
    labels: torch.Tensor,
    out_hw: Tuple[int, int],
    ignore_index: int = 255,
) -> torch.Tensor:
    """mean CE(bilinear_upsample(sem_logits), labels) over valid pixels."""
    loss_sum, count = upsampled_ce_sums(sem_logits, labels, out_hw, ignore_index)
    return loss_sum / torch.clamp(count, min=1.0)


# ---------------------------------------------------------------- K4: class-weighted CE


def wce_sums_plain(sem, labels, weights, out_hw, ignore_index=255):
    """Plain version of K4 forward: (Σ w[y] NLL, Σ w[y]) over the valid
    pixels, f32 scalars."""
    up = upsample_plain(sem, out_hw)
    valid = labels != ignore_index
    wpix = weights.float()[torch.where(valid, labels, 0).long()] * valid
    return (cross_entropy(up, labels, ignore_index, class_weights=weights,
                          reduction="sum"), wpix.sum())


def wce_dsem_plain(sem, labels, weights, out_hw, g, ignore_index=255):
    """Plain version of K4 backward: K_H^T ((softmax - onehot) w[y] valid g)
    K_W, in sem's dtype."""
    kh, kw = (torch.from_numpy(k).to(sem.device) for k in kmats(sem.shape, out_hw))
    up = upsample_plain(sem, out_hw)
    valid = labels != ignore_index
    _, onehot = _picked(up, labels, valid)
    wpix = weights.float()[torch.where(valid, labels, 0).long()] * valid
    dup = (torch.softmax(up, dim=-1) - onehot) * (wpix * g).unsqueeze(-1)
    dsem = torch.einsum("Ww,nHWc->nHwc", kw, dup)
    return torch.einsum("Hh,nHwc->nhwc", kh, dsem).to(sem.dtype)


def wce_sums(sem, labels, weights, out_hw, ignore_index=255):
    """K4 forward: (Σ w[y] NLL, Σ w[y]) over the batch's valid pixels, f32
    scalars; ``weights`` [C] f32.  CPU tensors take the plain version, CUDA
    tensors the kernel."""
    if sem.device.type == "cpu":
        return wce_sums_plain(sem, labels, weights, out_hw, ignore_index)
    _check_weights(weights, sem)
    loss, wsum = _launch_sums("upsample_wce_sums", sem, labels, out_hw, ignore_index,
                              (weights.data_ptr(),))
    wce_sums.launches += 1
    return loss.sum(), wsum.sum()


def wce_dsem(sem, labels, weights, out_hw, g, ignore_index=255):
    """K4 backward: d(Σ w[y] NLL)/d(sem) times the scalar tensor ``g``, in
    sem's dtype.  CPU tensors take the plain version, CUDA tensors the
    kernel."""
    if sem.device.type == "cpu":
        return wce_dsem_plain(sem, labels, weights, out_hw, g, ignore_index)
    _check_weights(weights, sem)
    dsem = _launch_grad("upsample_wce_grad", sem, labels, out_hw, g, ignore_index,
                        (weights.data_ptr(),))
    wce_dsem.launches += 1
    return dsem


wce_sums.launches = 0
wce_dsem.launches = 0


class _UpsampledWCESums(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sem, labels, weights, out_hw, ignore_index):
        loss, wsum = wce_sums(sem, labels, weights, out_hw, ignore_index)
        ctx.save_for_backward(sem, labels, weights)
        ctx.out_hw, ctx.ignore_index = out_hw, ignore_index
        ctx.mark_non_differentiable(wsum)
        return loss, wsum

    @staticmethod
    def backward(ctx, g_sum, _g_wsum):
        sem, labels, weights = ctx.saved_tensors
        dsem = wce_dsem(sem, labels, weights, ctx.out_hw, g_sum.float().contiguous(),
                        ctx.ignore_index)
        return dsem, None, None, None, None


def upsampled_wce_sums(sem_logits, labels, class_weights, out_hw, ignore_index=255):
    """(Σ w[y] CE(upsample(sem), labels), Σ w[y]) over valid pixels, f32
    scalars; differentiable in ``sem_logits`` only (the weights are a
    constant, as torch's ``weight=``)."""
    return _UpsampledWCESums.apply(sem_logits, labels, class_weights,
                                   tuple(int(d) for d in out_hw), int(ignore_index))


def upsampled_weighted_cross_entropy(sem_logits, labels, class_weights, out_hw,
                                     ignore_index=255):
    """torch-semantics weighted mean CE of the upsampled logits:
    Σ w[y] NLL / max(Σ w[y], 1e-8) over valid pixels."""
    loss, wsum = upsampled_wce_sums(sem_logits, labels, class_weights, out_hw,
                                    ignore_index)
    return loss / torch.clamp(wsum, min=1e-8)


# ---------------------------------------------------------------- K3: BACS weighted CE


def bacs_sum_plain(sem, labels, max_seen, out_hw, old_classes, gamma=2.0,
                   threshold=0.5, ukd=True, ignore_index=255):
    """Plain version of K3 forward: ``weighted_cross_entropy`` of the
    upsampled logits times N H W (a sum over all pixels), f32 scalar."""
    up = upsample_plain(sem, out_hw)
    mean = weighted_cross_entropy(up, labels, max_seen.unsqueeze(-1), old_classes,
                                  gamma=gamma, threshold=threshold, ukd=ukd,
                                  ignore_index=ignore_index)
    return mean * labels.numel()


def bacs_dsem_plain(sem, labels, max_seen, out_hw, g, old_classes, gamma=2.0,
                    threshold=0.5, ukd=True, ignore_index=255):
    """Plain version of K3 backward: autograd through :func:`bacs_sum_plain`
    times ``g``, in sem's dtype."""
    with torch.enable_grad():
        s = sem.detach().requires_grad_()
        total = bacs_sum_plain(s, labels, max_seen, out_hw, old_classes, gamma,
                               threshold, ukd, ignore_index) * g
        (dsem,) = torch.autograd.grad(total, s)
    return dsem.to(sem.dtype)


def _bacs_extra(max_seen, labels, old_classes, gamma, threshold, ukd):
    _check_max_seen(max_seen, labels)
    return (max_seen.data_ptr(), int(old_classes), int(bool(ukd)), float(gamma),
            float(threshold))


def bacs_sum(sem, labels, max_seen, out_hw, old_classes, gamma=2.0,
             threshold=0.5, ukd=True, ignore_index=255):
    """K3 forward: Σ over the batch's valid pixels of the BACS terms, f32
    scalar; ``max_seen`` [N, H, W] f32.  CPU tensors take the plain
    version, CUDA tensors the kernel."""
    if sem.device.type == "cpu":
        return bacs_sum_plain(sem, labels, max_seen, out_hw, old_classes, gamma,
                              threshold, ukd, ignore_index)
    extra = _bacs_extra(max_seen, labels, old_classes, gamma, threshold, ukd)
    loss, _ = _launch_sums("upsample_bacs_sum", sem, labels, out_hw, ignore_index,
                           extra)
    bacs_sum.launches += 1
    return loss.sum()


def bacs_dsem(sem, labels, max_seen, out_hw, g, old_classes, gamma=2.0,
              threshold=0.5, ukd=True, ignore_index=255):
    """K3 backward: d(Σ BACS terms)/d(sem) times the scalar tensor ``g``, in
    sem's dtype.  CPU tensors take the plain version, CUDA tensors the
    kernel."""
    if sem.device.type == "cpu":
        return bacs_dsem_plain(sem, labels, max_seen, out_hw, g, old_classes, gamma,
                               threshold, ukd, ignore_index)
    extra = _bacs_extra(max_seen, labels, old_classes, gamma, threshold, ukd)
    dsem = _launch_grad("upsample_bacs_grad", sem, labels, out_hw, g, ignore_index,
                        extra)
    bacs_dsem.launches += 1
    return dsem


bacs_sum.launches = 0
bacs_dsem.launches = 0


class _UpsampledBACSSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sem, labels, max_seen, out_hw, old_classes, gamma, threshold,
                ukd, ignore_index):
        ctx.save_for_backward(sem, labels, max_seen)
        ctx.args = (out_hw, old_classes, gamma, threshold, ukd, ignore_index)
        return bacs_sum(sem, labels, max_seen, out_hw, old_classes, gamma,
                        threshold, ukd, ignore_index)

    @staticmethod
    def backward(ctx, g):
        sem, labels, max_seen = ctx.saved_tensors
        out_hw, *rest = ctx.args
        dsem = bacs_dsem(sem, labels, max_seen, out_hw, g.float().contiguous(), *rest)
        return (dsem,) + (None,) * 8


def upsampled_bacs_wce_sum(sem_logits, labels, max_seen, out_hw, old_classes,
                           gamma=2.0, threshold=0.5, ukd=True, ignore_index=255):
    """Σ of the BACS weighted CE terms of the upsampled logits, f32 scalar;
    differentiable in ``sem_logits`` only (``max_seen`` is a constant)."""
    return _UpsampledBACSSum.apply(
        sem_logits, labels, max_seen, tuple(int(d) for d in out_hw),
        int(old_classes), float(gamma), float(threshold), bool(ukd), int(ignore_index))


def upsampled_bacs_weighted_ce(sem_logits, labels, max_seen, out_hw, old_classes,
                               gamma=2.0, threshold=0.5, ukd=True, ignore_index=255):
    """BACS weighted CE of the upsampled logits, mean over ALL pixels
    (ignored ones count in the denominator, the reference's quirk)."""
    total = upsampled_bacs_wce_sum(sem_logits, labels, max_seen, out_hw, old_classes,
                                   gamma, threshold, ukd, ignore_index)
    return total / labels.numel()


# ---------------------------------------------------------------- K6: MiB unbiased CE


def uce_sums_plain(sem, labels, out_hw, old_classes, ignore_index=255):
    """Plain version of K6 forward: (Σ unbiased NLL over the valid pixels,
    valid count), f32 scalars."""
    up = upsample_plain(sem, out_hw)
    nll = unbiased_cross_entropy(up, labels, old_classes, ignore_index, reduction="none")
    return nll.sum(), (labels != ignore_index).sum().float()


def uce_dsem_plain(sem, labels, out_hw, g, old_classes, ignore_index=255):
    """Plain version of K6 backward: autograd through :func:`uce_sums_plain`
    times ``g``, in sem's dtype."""
    with torch.enable_grad():
        s = sem.detach().requires_grad_()
        total = uce_sums_plain(s, labels, out_hw, old_classes, ignore_index)[0] * g
        (dsem,) = torch.autograd.grad(total, s)
    return dsem.to(sem.dtype)


def uce_sums(sem, labels, out_hw, old_classes, ignore_index=255):
    """K6 forward: (Σ unbiased NLL over the batch's valid pixels, valid
    count), f32 scalars.  CPU tensors take the plain version, CUDA tensors
    the kernel."""
    if sem.device.type == "cpu":
        return uce_sums_plain(sem, labels, out_hw, old_classes, ignore_index)
    loss, count = _launch_sums("upsample_uce_sums", sem, labels, out_hw, ignore_index,
                               (int(old_classes),))
    uce_sums.launches += 1
    return loss.sum(), count.sum()


def uce_dsem(sem, labels, out_hw, g, old_classes, ignore_index=255):
    """K6 backward: d(Σ unbiased NLL)/d(sem) times the scalar tensor ``g``,
    in sem's dtype.  CPU tensors take the plain version, CUDA tensors the
    kernel."""
    if sem.device.type == "cpu":
        return uce_dsem_plain(sem, labels, out_hw, g, old_classes, ignore_index)
    dsem = _launch_grad("upsample_uce_grad", sem, labels, out_hw, g, ignore_index,
                        (int(old_classes),))
    uce_dsem.launches += 1
    return dsem


uce_sums.launches = 0
uce_dsem.launches = 0


class _UpsampledUCESums(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sem, labels, out_hw, old_classes, ignore_index):
        loss, count = uce_sums(sem, labels, out_hw, old_classes, ignore_index)
        ctx.save_for_backward(sem, labels)
        ctx.args = (out_hw, old_classes, ignore_index)
        ctx.mark_non_differentiable(count)
        return loss, count

    @staticmethod
    def backward(ctx, g_sum, _g_count):
        sem, labels = ctx.saved_tensors
        out_hw, old_classes, ignore_index = ctx.args
        dsem = uce_dsem(sem, labels, out_hw, g_sum.float().contiguous(), old_classes,
                        ignore_index)
        return dsem, None, None, None, None


def upsampled_uce_sums(sem_logits, labels, out_hw, old_classes, ignore_index=255):
    """(Σ unbiased CE(upsample(sem), labels) over valid pixels, valid count),
    f32 scalars; differentiable in ``sem_logits`` only."""
    return _UpsampledUCESums.apply(sem_logits, labels, tuple(int(d) for d in out_hw),
                                   int(old_classes), int(ignore_index))


def upsampled_unbiased_cross_entropy(sem_logits, labels, out_hw, old_classes,
                                     ignore_index=255):
    """Mean over the VALID pixels of MiB's unbiased CE of the upsampled
    logits (``losses.unbiased_cross_entropy`` semantics)."""
    loss, count = upsampled_uce_sums(sem_logits, labels, out_hw, old_classes,
                                     ignore_index)
    return loss / torch.clamp(count, min=1.0)


# ---------------------------------------------------------------- K7: MiB unbiased KD


def ukd_sum_plain(sem, sem_old, out_hw, alpha=1.0):
    """Plain version of K7 forward: the sum T over every output pixel of the
    upsampled pair, f32 scalar (the loss is -T / (N H W))."""
    up, up_old = upsample_plain(sem, out_hw), upsample_plain(sem_old, out_hw)
    n_tot = up.shape[0] * up.shape[1] * up.shape[2]
    return -unbiased_knowledge_distillation(up, up_old, alpha=alpha) * n_tot


def ukd_dsem_plain(sem, sem_old, out_hw, g, alpha=1.0):
    """Plain version of K7 backward: autograd through :func:`ukd_sum_plain`
    in the student times ``g``, in sem's dtype."""
    with torch.enable_grad():
        s = sem.detach().requires_grad_()
        (dsem,) = torch.autograd.grad(ukd_sum_plain(s, sem_old.detach(), out_hw, alpha) * g,
                                      s)
    return dsem.to(sem.dtype)


def _check_pair(sem, sem_old, out_hw):
    """Raise unless K7 takes (sem, sem_old, out_hw); returns (n, h, w, c,
    c_old, H, W)."""
    if sem.device.type != "cuda":
        raise ValueError(f"kernel needs a CUDA tensor, got {sem.device}")
    if sem.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"sem must be float32 or bfloat16, got {sem.dtype}")
    if sem_old.dtype != sem.dtype:
        raise TypeError(f"the teacher's dtype {sem_old.dtype} is not the "
                        f"student's {sem.dtype}")
    if (sem.dim() != 4 or sem_old.dim() != 4 or not sem.is_contiguous()
            or not sem_old.is_contiguous() or sem_old.device != sem.device):
        raise ValueError("sem and sem_old must be contiguous [n, h, w, c] tensors "
                         "on one device")
    n, h, w, c = sem.shape
    c_old = sem_old.shape[-1]
    if tuple(sem_old.shape[:3]) != (n, h, w) or not 1 <= c_old < c:
        raise ValueError(f"teacher {tuple(sem_old.shape)} does not pair with student "
                         f"{tuple(sem.shape)} (same n, h, w; fewer channels)")
    H, W = (int(d) for d in out_hw)
    if min(n, h, w, H, W) < 1:
        raise ValueError(f"unsupported shape {tuple(sem.shape)} -> {(H, W)}")
    return n, h, w, c, c_old, H, W


def ukd_sum(sem, sem_old, out_hw, alpha=1.0):
    """K7 forward: the sum T of the unbiased KD terms over every upsampled
    pixel, f32 scalar; ``sem_old`` has fewer channels than ``sem``.  CPU
    tensors take the plain version, CUDA tensors the kernel."""
    if sem.device.type == "cpu":
        return ukd_sum_plain(sem, sem_old, out_hw, alpha)
    n, h, w, c, c_old, H, W = _check_pair(sem, sem_old, out_hw)
    tables, args, nb = launch_plan(n, h, w, c, H, W, sem.device, c_old)
    partials = torch.empty((n, nb, 2), dtype=torch.float32, device=sem.device)
    t = torch.empty((n,), dtype=torch.float32, device=sem.device)
    count = torch.empty((n,), dtype=torch.float32, device=sem.device)
    lib = build.load_library()
    with torch.cuda.device(sem.device):
        code = lib.upsample_ukd_sum(
            sem.data_ptr(), sem_old.data_ptr(), int(sem.dtype == torch.bfloat16), n, h,
            w, c, c_old, H, W, float(alpha), tables.data_ptr(), *args, partials.data_ptr(),
            t.data_ptr(), count.data_ptr(), torch.cuda.current_stream().cuda_stream)
    build.check(code, "upsample_ukd_sum")
    ukd_sum.launches += 1
    return t.sum()


def ukd_dsem(sem, sem_old, out_hw, g, alpha=1.0):
    """K7 backward: dT/d(sem) times the scalar tensor ``g``, in sem's dtype
    (the teacher takes no gradient).  CPU tensors take the plain version,
    CUDA tensors the kernel."""
    if sem.device.type == "cpu":
        return ukd_dsem_plain(sem, sem_old, out_hw, g, alpha)
    n, h, w, c, c_old, H, W = _check_pair(sem, sem_old, out_hw)
    _check_g(g, sem)
    tables, args, nb = launch_plan(n, h, w, c, H, W, sem.device, c_old)
    partials = torch.empty((n, nb, args[3], w, c), dtype=torch.float32, device=sem.device)
    dsem = torch.empty_like(sem)
    lib = build.load_library()
    with torch.cuda.device(sem.device):
        code = lib.upsample_ukd_grad(
            sem.data_ptr(), sem_old.data_ptr(), int(sem.dtype == torch.bfloat16), n, h,
            w, c, c_old, H, W, float(alpha), g.data_ptr(), tables.data_ptr(), *args,
            partials.data_ptr(), dsem.data_ptr(), torch.cuda.current_stream().cuda_stream)
    build.check(code, "upsample_ukd_grad")
    ukd_dsem.launches += 1
    return dsem


ukd_sum.launches = 0
ukd_dsem.launches = 0


class _UpsampledUKDSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sem, sem_old, out_hw, alpha):
        ctx.save_for_backward(sem, sem_old)
        ctx.out_hw, ctx.alpha = out_hw, alpha
        return ukd_sum(sem, sem_old, out_hw, alpha)

    @staticmethod
    def backward(ctx, g):
        sem, sem_old = ctx.saved_tensors
        dsem = ukd_dsem(sem, sem_old, ctx.out_hw, g.float().contiguous(), ctx.alpha)
        return dsem, None, None, None


def upsampled_ukd_sum(sem_new, sem_old, out_hw, alpha=1.0):
    """The sum T of MiB's unbiased KD over the upsampled pair (the loss is
    -T / (N H W)); differentiable in ``sem_new`` only: the teacher is a
    constant, as the reference detaches the old model's outputs."""
    return _UpsampledUKDSum.apply(sem_new, sem_old.detach(),
                                  tuple(int(d) for d in out_hw), float(alpha))


def upsampled_unbiased_kd(sem_new, sem_old, out_hw, alpha=1.0):
    """MiB's unbiased KD of the bilinear-upsampled pair, the mean over ALL
    pixels (``losses.unbiased_knowledge_distillation`` semantics); neither
    full-resolution logit tensor exists."""
    n_tot = sem_new.shape[0] * int(out_hw[0]) * int(out_hw[1])
    return -upsampled_ukd_sum(sem_new, sem_old, out_hw, alpha) / n_tot
