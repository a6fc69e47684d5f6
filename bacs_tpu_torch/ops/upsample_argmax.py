"""Fused bilinear upsample + argmax + max-softmax confidence (serving).

Port of ``bacs_tpu/ops/upsample_argmax.py``.  The Predictor's payload, a
uint8 mask and an f16 confidence per pixel, comes from the pre-upsample
logits, so the [N, H, W, C] full-resolution logits never exist.

- :func:`argmax_conf_plain` is the plain PyTorch version: the two
  interpolation matrices of ``interp_matrix`` applied as einsums in f32,
  then argmax and ``1 / sum(exp(up - max))``.  The CPU path and the
  reference the kernel is held to.
- :func:`upsampled_argmax_conf` is the wrapper.  For a CUDA tensor it
  launches the hand-written kernel ``csrc/upsample_argmax.cu`` (replacing the
  TPU kernel ``_argmax_conf_pallas``, ``bacs_tpu/ops/upsample_argmax.py:88``)
  or raises; for a CPU tensor it runs the plain version.  Its ``launches``
  attribute counts kernel launches.  It calls the registered op
  ``bacs::upsample_argmax_conf`` (``upsample_argmax_conf_op``), which
  ``torch.export`` keeps as one node (``serve.Predictor.export``).  The
  kernel reads its bilinear taps and bands of output rows from the tables
  of ``ops/upsample_ce.py:launch_plan`` (shared with K1 at the same shape).

Tolerance of the kernel against the plain version: preds equal wherever the
top-2 margin exceeds 1e-4, confidence within 1e-3 (f16 rounding).  The bound
on the H100 is in the kernel's source note.
"""

from __future__ import annotations

from typing import Tuple

import torch

from bacs_tpu_torch.kernels import build
from bacs_tpu_torch.ops.upsample_ce import launch_plan
from bacs_tpu_torch.ops.upsample_tiles import kmats


def argmax_conf_from(up: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """argmax (uint8) + max softmax prob (f16) of f32 logits [n, H, W, c]."""
    preds = up.argmax(dim=-1).to(torch.uint8)
    m = up.amax(dim=-1, keepdim=True)
    denom = torch.exp(up - m).sum(dim=-1)
    return preds, (1.0 / denom).to(torch.float16)


def argmax_conf_plain(
    sem: torch.Tensor, out_hw: Tuple[int, int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: einsum-matrix resize in f32, then argmax + confidence.

    Heads that emit at label resolution skip the resize entirely, as in the
    JAX package (the kernel's weights reduce to a copy there).
    """
    if tuple(sem.shape[1:3]) == tuple(out_hw):
        return argmax_conf_from(sem.float())
    kh, kw = (torch.from_numpy(k).to(sem.device) for k in kmats(sem.shape, out_hw))
    up = torch.einsum("Hh,nhwc->nHwc", kh, sem.float())
    up = torch.einsum("Ww,nHwc->nHWc", kw, up)
    return argmax_conf_from(up)


def _argmax_conf_cuda(
    sem: torch.Tensor, out_hw: Tuple[int, int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    if sem.device.type != "cuda":
        raise ValueError(f"kernel needs a CUDA tensor, got {sem.device}")
    if sem.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"sem must be float32 or bfloat16, got {sem.dtype}")
    if sem.dim() != 4 or not sem.is_contiguous():
        raise ValueError("sem must be a contiguous [n, h, w, c] tensor")
    n, h, w, c = sem.shape
    H, W = (int(d) for d in out_hw)
    if not 1 <= c <= 256 or H < 1 or W < 1 or h < 1 or w < 1:
        raise ValueError(f"unsupported shape {tuple(sem.shape)} -> {(H, W)}")
    tables, args, _ = launch_plan(n, h, w, c, H, W, sem.device)
    preds = torch.empty((n, H, W), dtype=torch.uint8, device=sem.device)
    conf = torch.empty((n, H, W), dtype=torch.float16, device=sem.device)
    lib = build.load_library()
    with torch.cuda.device(sem.device):
        code = lib.upsample_argmax_conf(
            sem.data_ptr(), int(sem.dtype == torch.bfloat16), n, h, w, c, H, W,
            tables.data_ptr(), *args, preds.data_ptr(), conf.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(code, "upsample_argmax_conf")
    upsampled_argmax_conf.launches += 1
    return preds, conf


# The registered op ``bacs::upsample_argmax_conf``: the plain version for a
# CPU tensor, the kernel (or its raise) for a CUDA one.  One node of a
# ``torch.export`` graph, whose loaded program runs these functions
# (defined as ``ops/abn_core.py`` defines ``bacs::abn_eval``).
_LIB = torch.library.Library("bacs", "FRAGMENT")
_LIB.define("upsample_argmax_conf(Tensor sem, int H, int W) -> (Tensor, Tensor)")
_LIB.impl("upsample_argmax_conf", lambda sem, H, W: argmax_conf_plain(sem, (H, W)), "CPU")
_LIB.impl("upsample_argmax_conf", lambda sem, H, W: _argmax_conf_cuda(sem, (H, W)), "CUDA")
upsample_argmax_conf_op = torch.ops.bacs.upsample_argmax_conf.default


@torch.library.register_fake("bacs::upsample_argmax_conf", lib=_LIB)
def _upsample_argmax_conf_fake(sem, H, W):
    n = sem.shape[0]
    return (sem.new_empty((n, H, W), dtype=torch.uint8),
            sem.new_empty((n, H, W), dtype=torch.float16))


def upsampled_argmax_conf(
    sem_logits: torch.Tensor, out_hw: Tuple[int, int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pred uint8 [n,H,W], max-softmax confidence f16 [n,H,W]) of the
    bilinear-upsampled NHWC ``sem_logits`` (already sliced to the active
    classes), through the op ``bacs::upsample_argmax_conf``.  CPU tensors
    take the plain version, CUDA tensors the kernel.
    """
    H, W = (int(d) for d in out_hw)
    return upsample_argmax_conf_op(sem_logits, H, W)


upsampled_argmax_conf.launches = 0
