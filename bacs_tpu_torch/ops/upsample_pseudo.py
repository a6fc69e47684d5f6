"""PLOP's pseudo-labels from the teacher's upsampled logits (K9).

Port of ``upsampled_plop_pseudo_labels`` (``bacs_tpu/ops/upsample_ce.py:
931-950``).  The background and old-class pixels of the labels (label <
C_old) take the frozen previous model's prediction where its normalised
entropy is below the predicted class's threshold, and the ignore label
elsewhere; per image, ``num`` counts the pixels that took a prediction and
``den`` the pixels that could (PLOP's adaptive factor is num / max(den,
1)).  :func:`plop_pseudo_labels` launches the kernel of
``csrc/upsample_pseudo.cu`` for a CUDA tensor (replaces ``_pseudo_pallas``,
``:904``; its ``launches`` attribute counts the calls) and runs the plain
version for a CPU tensor: :func:`upsample_plain` + :func:`pseudo_labels`,
the softmax, argmax and ``losses.pixel_entropy`` of ``_plop_pseudo_jnp``
(``:837-853``), which PLOP's composed path runs on full-resolution logits.  The
three full-resolution f32 tensors of the plain version never exist on the
card; the kernel reads its bilinear taps and bands of output rows from the
tables of ``ops/upsample_ce.py:launch_plan``.  Forward only: the teacher is
detached.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from bacs_tpu_torch.kernels import build
from bacs_tpu_torch.ops.losses import pixel_entropy
from bacs_tpu_torch.ops.upsample_ce import check_inputs, launch_plan, upsample_plain


def pseudo_labels(old_logits, labels, thresholds, max_entropy, ignore_index=255):
    """PLOP's pseudo-labels of full-resolution teacher logits [N, H, W,
    C_old]: (int32 labels [N, H, W], num [N], den [N] f32)."""
    c_old = old_logits.shape[-1]
    probs = torch.softmax(old_logits.float(), dim=-1)
    pseudo = probs.argmax(dim=-1)
    mask_bg = labels < c_old
    ent = pixel_entropy(probs) / max_entropy
    valid = ent < thresholds.float()[pseudo]
    new = torch.where(~valid & mask_bg, ignore_index, labels.long())
    new = torch.where(valid & mask_bg, pseudo, new).to(torch.int32)
    num = (valid & mask_bg).sum(dim=(1, 2)).float()
    return new, num, mask_bg.sum(dim=(1, 2)).float()


def pseudo_labels_plain(sem_old, labels, thresholds, out_hw, max_entropy,
                        ignore_index=255):
    """Plain version of K9: :func:`pseudo_labels` of the upsampled logits."""
    return pseudo_labels(upsample_plain(sem_old, out_hw), labels, thresholds, max_entropy,
                         ignore_index)


def plop_pseudo_labels(sem_old, labels, thresholds, out_hw, max_entropy,
                       ignore_index=255):
    """K9: PLOP's pseudo-labels of the upsampled ``sem_old`` [N, h, w, C_old]
    for ``labels`` [N, H, W], ``thresholds`` f32 [>= C_old] and the scalar
    ``max_entropy``: (int32 labels, num [N], den [N] f32).  CPU tensors
    take the plain version, CUDA tensors the kernel."""
    if sem_old.device.type == "cpu":
        return pseudo_labels_plain(sem_old, labels, thresholds, out_hw, max_entropy,
                                   ignore_index)
    n, h, w, c, H, W = check_inputs(sem_old, labels, out_hw)
    if (thresholds.dtype != torch.float32 or thresholds.dim() != 1
            or thresholds.numel() < c or thresholds.device != sem_old.device
            or not thresholds.is_contiguous()):
        raise ValueError(f"thresholds must be a contiguous float32 vector of at least "
                         f"{c} entries on {sem_old.device}, got {thresholds.dtype} "
                         f"{tuple(thresholds.shape)} on {thresholds.device}")
    me = torch.as_tensor(max_entropy, dtype=torch.float32, device=sem_old.device)
    if me.numel() != 1:
        raise ValueError(f"max_entropy must be one value, got {tuple(me.shape)}")
    tables, args, _ = launch_plan(n, h, w, c, H, W, sem_old.device)
    out = torch.empty((n, H, W), dtype=torch.int32, device=sem_old.device)
    counts = torch.zeros((n, 2), dtype=torch.int32, device=sem_old.device)
    lib = build.load_library()
    with torch.cuda.device(sem_old.device):
        code = lib.upsample_plop_pseudo(
            sem_old.data_ptr(), int(sem_old.dtype == torch.bfloat16), labels.data_ptr(),
            int(labels.dtype == torch.int64), n, h, w, c, H, W, int(ignore_index),
            thresholds.data_ptr(), me.contiguous().data_ptr(),
            -1.0 / (c * math.log(c + 1e-8)), tables.data_ptr(), *args, out.data_ptr(),
            counts.data_ptr(), torch.cuda.current_stream().cuda_stream)
    build.check(code, "upsample_plop_pseudo")
    plop_pseudo_labels.launches += 1
    counts = counts.float()
    return out, counts[:, 0], counts[:, 1]


plop_pseudo_labels.launches = 0


def upsampled_plop_pseudo_labels(
    sem_old: torch.Tensor,
    labels: torch.Tensor,
    thresholds: torch.Tensor,
    out_hw: Tuple[int, int],
    max_entropy,
    ignore_index: int = 255,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """PLOP's pseudo-labels from the upsampled teacher logits, detached:
    (new labels [N, H, W] int32, num [N], den [N])."""
    with torch.no_grad():
        return plop_pseudo_labels(sem_old.detach(), labels, thresholds,
                                  tuple(int(d) for d in out_hw), max_entropy, ignore_index)
