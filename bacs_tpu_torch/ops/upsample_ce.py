"""Fused bilinear upsample + cross-entropy: the full-res logits never exist.

Port of the plain CE of ``bacs_tpu/ops/upsample_ce.py`` (K1).  The loss of
the CE step is CE(bilinear_upsample(sem_logits), labels), mean over the
pixels whose label is not ``ignore_index``; at 512^2, batch 16, VOC-21 the
upsampled logits alone would be 352 MB of f32.

- :func:`ce_sums_per_image` (K1 forward) gives, per image, the sum of the
  NLL over valid pixels and the valid count.  A CUDA tensor launches
  ``csrc/upsample_ce.cu`` (replacing ``_ce_sums_per_image_pallas``,
  ``bacs_tpu/ops/upsample_ce.py:787``) or raises; a CPU tensor runs
  :func:`ce_sums_plain`.
- :func:`ce_dsem` (K1 backward) gives d(sum)/d(sem) times a scalar ``g``.
  A CUDA tensor launches the same file's gradient kernel (replacing
  ``_dsem_pallas``, ``upsample_ce.py:125``) or raises; a CPU tensor runs
  :func:`ce_dsem_plain`, the jnp branch of ``_uces_bwd``
  (``upsample_ce.py:159-174``).
- :func:`upsampled_ce_sums` is the differentiable (sum, count) over the
  whole batch: a ``torch.autograd.Function`` whose forward is K1 forward
  and whose backward is K1 backward; the count takes no gradient.
- :func:`upsampled_cross_entropy` divides outside the Function, so autograd
  hands the backward g = 1 / max(count, 1) as a device scalar.

Each wrapper's ``launches`` attribute counts kernel calls.  The plain
versions upsample with the ``interp_matrix`` einsums in f32
(``upsample_tiles.py``).  Labels other than ``ignore_index`` are expected in
[0, C); one outside picks no logit, as the TPU kernel's one-hot.  Bounds and
tolerances are in the kernel's source note.
"""

from __future__ import annotations

from typing import Tuple

import torch

from bacs_tpu_torch.kernels import build
from bacs_tpu_torch.ops.upsample_tiles import kmats

BLOCKS_PER_IMAGE = 256  # forward partial sums per image (one 256-thread block each)


def upsample_plain(sem: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """f32 [n, H, W, c] bilinear upsample as the two ``interp_matrix`` einsums."""
    kh, kw = (torch.from_numpy(k).to(sem.device) for k in kmats(sem.shape, out_hw))
    up = torch.einsum("Hh,nhwc->nHwc", kh, sem.float())
    return torch.einsum("Ww,nHwc->nHWc", kw, up)


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


def _ce_sums_cuda(sem, labels, out_hw, ignore_index):
    n, h, w, c, H, W = check_inputs(sem, labels, out_hw)
    blocks = min(-(-H * W // 256), BLOCKS_PER_IMAGE)
    partials = torch.empty((n, blocks, 2), dtype=torch.float32, device=sem.device)
    loss = torch.empty((n,), dtype=torch.float32, device=sem.device)
    count = torch.empty((n,), dtype=torch.float32, device=sem.device)
    lib = build.load_library()
    with torch.cuda.device(sem.device):
        code = lib.upsample_ce_sums(
            sem.data_ptr(), int(sem.dtype == torch.bfloat16), labels.data_ptr(),
            int(labels.dtype == torch.int64), n, h, w, c, H, W, int(ignore_index),
            partials.data_ptr(), blocks, loss.data_ptr(), count.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(code, "upsample_ce_sums")
    ce_sums_per_image.launches += 1
    return loss, count


def _ce_dsem_cuda(sem, labels, out_hw, g, ignore_index):
    n, h, w, c, H, W = check_inputs(sem, labels, out_hw)
    if (g.numel() != 1 or g.dtype != torch.float32 or g.device != sem.device
            or not g.is_contiguous()):
        raise ValueError(f"g must be one float32 value on {sem.device}, got "
                         f"{g.dtype} {tuple(g.shape)} on {g.device}")
    cols = torch.empty((n, H, w, c), dtype=torch.float32, device=sem.device)
    dsem = torch.empty_like(sem)
    lib = build.load_library()
    with torch.cuda.device(sem.device):
        code = lib.upsample_ce_grad(
            sem.data_ptr(), int(sem.dtype == torch.bfloat16), labels.data_ptr(),
            int(labels.dtype == torch.int64), n, h, w, c, H, W, int(ignore_index),
            g.data_ptr(), cols.data_ptr(), dsem.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(code, "upsample_ce_grad")
    ce_dsem.launches += 1
    return dsem


def ce_sums_per_image(sem, labels, out_hw, ignore_index=255):
    """K1 forward: ([n] Σ NLL over valid pixels, [n] valid count), f32.
    CPU tensors take the plain version, CUDA tensors the kernel."""
    if sem.device.type == "cpu":
        return ce_sums_plain(sem, labels, out_hw, ignore_index)
    return _ce_sums_cuda(sem, labels, out_hw, ignore_index)


def ce_dsem(sem, labels, out_hw, g, ignore_index=255):
    """K1 backward: d(Σ NLL)/d(sem) times the scalar tensor ``g``, in sem's
    dtype.  CPU tensors take the plain version, CUDA tensors the kernel."""
    if sem.device.type == "cpu":
        return ce_dsem_plain(sem, labels, out_hw, g, ignore_index)
    return _ce_dsem_cuda(sem, labels, out_hw, g, ignore_index)


ce_sums_per_image.launches = 0
ce_dsem.launches = 0


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


def upsampled_cross_entropy(
    sem_logits: torch.Tensor,
    labels: torch.Tensor,
    out_hw: Tuple[int, int],
    ignore_index: int = 255,
) -> torch.Tensor:
    """mean CE(bilinear_upsample(sem_logits), labels) over valid pixels."""
    loss_sum, count = upsampled_ce_sums(sem_logits, labels, out_hw, ignore_index)
    return loss_sum / torch.clamp(count, min=1.0)
