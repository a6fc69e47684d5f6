"""Fused bilinear upsample + argmax + confusion matrix (the eval step).

Port of ``bacs_tpu/ops/upsample_confusion.py`` (K2).  The eval step's
confusion matrix comes straight from the pre-upsample logits: neither the
full-resolution logits nor the prediction map is stored.

- :func:`confusion_plain` is the plain version: the ``interp_matrix``
  einsums in f32, ``argmax`` (the first index wins on ties, as
  ``jnp.argmax``), then :func:`~bacs_tpu_torch.ops.confusion.confusion_matrix`.
- :func:`upsampled_confusion` is the wrapper.  A CUDA tensor launches
  ``csrc/upsample_confusion.cu`` (replacing ``_conf_pallas``,
  ``bacs_tpu/ops/upsample_confusion.py:88``) or raises; a CPU tensor runs
  the plain version.  Its ``launches`` attribute counts kernel launches.
  The kernel reads its bilinear taps and bands of output rows from the
  tables of ``ops/upsample_ce.py:launch_plan`` (shared with K1 at the same
  shape).

Rows are targets and columns predictions; labels outside
[0, num_classes) are dropped and predictions clipped into range.  Bound
and tolerance are in the kernel's source note.
"""

from __future__ import annotations

from typing import Tuple

import torch

from bacs_tpu_torch.kernels import build
from bacs_tpu_torch.ops.confusion import confusion_matrix
from bacs_tpu_torch.ops.upsample_ce import check_inputs, launch_plan, upsample_plain


# the most classes the wrapper takes; the kernel keeps a num_classes^2 int
# histogram per block in shared memory where it fits beside the stage (about
# 225 classes), else it counts in the output
MAX_CLASSES = 241


def confusion_plain(sem, labels, out_hw, num_classes):
    """Plain version: int32 [num_classes, num_classes]."""
    preds = upsample_plain(sem, out_hw).argmax(dim=-1)
    return confusion_matrix(preds, labels, num_classes)


def _confusion_cuda(sem, labels, out_hw, num_classes):
    n, h, w, c, H, W = check_inputs(sem, labels, out_hw)
    if not 1 <= num_classes <= MAX_CLASSES:
        raise ValueError(f"the CUDA kernel takes 1 to {MAX_CLASSES} classes, "
                         f"got {num_classes}")
    tables, args, _ = launch_plan(n, h, w, c, H, W, sem.device)
    conf = torch.zeros((num_classes, num_classes), dtype=torch.int32,
                       device=sem.device)
    lib = build.load_library()
    with torch.cuda.device(sem.device):
        code = lib.upsample_confusion(
            sem.data_ptr(), int(sem.dtype == torch.bfloat16), labels.data_ptr(),
            int(labels.dtype == torch.int64), n, h, w, c, H, W, int(num_classes),
            tables.data_ptr(), *args, conf.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(code, "upsample_confusion")
    upsampled_confusion.launches += 1
    return conf


def upsampled_confusion(
    sem_logits: torch.Tensor,
    labels: torch.Tensor,
    out_hw: Tuple[int, int],
    num_classes: int,
) -> torch.Tensor:
    """int32 [num_classes, num_classes] confusion of
    argmax(bilinear_upsample(sem_logits)) against ``labels``.

    ``sem_logits`` is NHWC, already sliced to the active classes.  CPU
    tensors take the plain version, CUDA tensors the kernel.
    """
    if sem_logits.device.type == "cpu":
        return confusion_plain(sem_logits, labels, out_hw, num_classes)
    return _confusion_cuda(sem_logits, labels, out_hw, num_classes)


upsampled_confusion.launches = 0
