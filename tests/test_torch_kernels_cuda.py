"""The port's hand-written kernels against their plain versions, on the card.

Every test needs a CUDA device and skips with a reason where torch sees
none; run them on a GPU machine with
``python -m pytest tests/test_torch_kernels_cuda.py -q``.  The checks are
those of ``chip_smoke.py`` (phases 2, 3, 6, 7, 11, 12, 16, 17 and 21), at
small shapes and at the serving and training shapes, and the repeatability
of the upsample+loss family (two launches bit-equal); also the registered
ops of K5 and K10 against the launches they wrap (phases 2 and 3's shapes)
and as nodes of a ``torch.export`` program.  The port-only kernels
(``chip_smoke.py`` phase 45): the threefry draws bit-equal to their plain
version and to the CPU's (the detector's dropout mask, a train transform's
crop parameters); the resize kernels against ``F.interpolate`` at the main
path's shapes, two launches bit-equal; and one CE and one BACS step at
512^2 under ``torch.use_deterministic_algorithms(True)`` (in a process of
its own: cuBLAS reads ``CUBLAS_WORKSPACE_CONFIG`` when it starts).
"""

import os
import subprocess
import sys

import pytest
import torch

from chip_smoke import (
    DRAW_SHAPE, DROPOUT_KEEP, RESIZE_CASES, check_resize)
from chip_smoke import (
    K5_SHAPES, K10_CASES, check_abn, check_argmax, check_bacs, check_ce, check_ce_per_image, check_confusion,
    check_pseudo, check_repeatable, check_stem, check_uce, check_ukd, check_wce,
    family_calls, stem_raises)
from torch_port_helpers import _one_thread  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("slope", [0.01, 1.0, 0.0])
@pytest.mark.parametrize(
    "shape", [(2, 5, 7, 64), (16, 1, 1, 256), (3, 9, 9, 24), (4, 32, 32, 2048),
              (16, 256, 256, 64)],
)
def test_abn_eval_kernel_matches_plain(cuda, shape, slope, dtype):
    check_abn(shape, slope, dtype, cuda)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "shape,out_hw",
    [((16, 32, 32, 21), (512, 512)), ((2, 33, 47, 21), (261, 373)),
     ((2, 8, 8, 150), (128, 128)), ((2, 16, 16, 4), (16, 16)),
     ((1, 4, 4, 3), (7, 5))],
)
def test_upsample_argmax_kernel_matches_plain(cuda, shape, out_hw, dtype):
    check_argmax(shape, out_hw, dtype, cuda)


# K10 and K9 (csrc/upsample_stage.cuh:pixel_kernel) at channel counts at and
# across the register chunks (16, 24, then 32 a chunk), batch 1 at the
# serving shape, an odd band, and at scale 1 (UNet's logits: each band
# stages as many source rows as it writes)
PIXEL_CASES = [((2, 8, 8, c), (128, 128)) for c in (16, 17, 24, 25, 33, 150)] + [
    ((1, 32, 32, 21), (512, 512)), ((2, 33, 47, 21), (261, 373)),
    ((2, 64, 64, 21), (64, 64)), ((1, 512, 512, 21), (512, 512))]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,out_hw", PIXEL_CASES)
def test_pixel_template_argmax_matches_plain(cuda, shape, out_hw, dtype):
    """K10 under ``check_argmax``'s rule; at the power-of-two scales also on
    integer logits, whose ties the two must break alike (the first channel
    that reaches the max, within a chunk and across chunks)."""
    check_argmax(shape, out_hw, dtype, cuda)
    if out_hw == (128, 128) or out_hw == shape[1:3]:
        check_argmax(shape, out_hw, dtype, cuda, levels=True)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,out_hw", [((n, h, w, 16 if c == 21 else c), hw)
                                          for (n, h, w, c), hw in PIXEL_CASES])
def test_pixel_template_pseudo_matches_plain(cuda, shape, out_hw, dtype):
    """K9 under the margin rule of ``chip_smoke.check_pseudo``."""
    check_pseudo(shape, out_hw, dtype, cuda)


@pytest.mark.parametrize("labels_dtype", [torch.int32, torch.int64], ids=["i32", "i64"])
@pytest.mark.parametrize("ignore_index", [255, -100])
def test_pseudo_labels_dtypes_ignore_index_and_new_class_image(cuda, labels_dtype,
                                                               ignore_index):
    """K9 with int64 labels, an ignore index other than 255, and a first
    image whose labels are all the new class (no softmax, num = den = 0)."""
    check_pseudo((3, 8, 8, 16), (128, 128), torch.bfloat16, cuda, labels_dtype=labels_dtype,
                 ignore_index=ignore_index, new_image=True)


UPSAMPLE_CASES = [((16, 32, 32, 21), (512, 512)), ((2, 33, 47, 21), (261, 373)),
                  ((2, 5, 7, 6), (37, 51)), ((2, 8, 8, 150), (128, 128)),
                  ((2, 16, 16, 4), (16, 16)), ((1, 4, 4, 3), (7, 5))]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,out_hw", UPSAMPLE_CASES)
def test_upsample_ce_kernels_match_plain(cuda, shape, out_hw, dtype):
    check_ce(shape, out_hw, dtype, cuda)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize(  # 241 classes: the most the wrapper takes
    "shape,out_hw", UPSAMPLE_CASES + [((1, 4, 4, 241), (32, 32))])
def test_upsample_confusion_kernel_matches_plain(cuda, shape, out_hw, dtype):
    check_confusion(shape, out_hw, dtype, cuda)


# K2's staged kernel: ADE's 150 classes (the histogram in shared memory
# beside the stage, fewer blocks an SM), Cityscapes' 19 at 512 x 1024, 241
# classes (the bins in the output: histogram and stage do not fit
# together), fewer and more channels than classes (predictions clipped)
CONF_CASES = [((2, 32, 32, 150), (512, 512), 150), ((2, 32, 64, 19), (512, 1024), 19),
              ((2, 8, 8, 241), (128, 128), 241), ((2, 8, 8, 21), (128, 128), 25),
              ((2, 8, 8, 30), (128, 128), 21), ((1, 32, 32, 21), (512, 512), 21)]


@pytest.mark.parametrize("labels_dtype", [torch.int32, torch.int64], ids=["i32", "i64"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,out_hw,nc", CONF_CASES)
def test_confusion_template_matches_plain(cuda, shape, out_hw, nc, dtype, labels_dtype):
    check_confusion(shape, out_hw, dtype, cuda, num_classes=nc, labels_dtype=labels_dtype)


@pytest.mark.parametrize("labels_dtype", [torch.int32, torch.int64], ids=["i32", "i64"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,out_hw", [((16, 32, 32, 21), (512, 512)),
                                          ((2, 33, 47, 21), (261, 373))])
def test_confusion_of_one_bin_counts_every_pixel(cuda, shape, out_hw, dtype, labels_dtype):
    """Every label and every prediction class 3: each warp's pixels in one
    bin, whose count must be every pixel."""
    check_confusion(shape, out_hw, dtype, cuda, labels_dtype=labels_dtype, one_bin=True)


@pytest.mark.parametrize("shape,out_hw,nc", CONF_CASES[:3])
def test_confusion_launches_are_bit_equal(cuda, shape, out_hw, nc):
    from bacs_tpu_torch.ops.upsample_confusion import upsampled_confusion

    sem = torch.randn(shape, device=cuda).to(torch.bfloat16)
    labels = torch.randint(0, nc, (shape[0], *out_hw), device=cuda, dtype=torch.int32)
    a = upsampled_confusion(sem, labels, out_hw, nc)
    b = upsampled_confusion(sem, labels, out_hw, nc)
    assert torch.equal(a, b) and int(a.sum()) == labels.numel()


WEIGHTED_CASES = [((12, 32, 32, 17), (512, 512)), ((16, 32, 32, 17), (512, 512)),
                  ((2, 33, 47, 17), (261, 373)), ((2, 5, 7, 6), (37, 51)),
                  ((2, 8, 8, 40), (128, 128)), ((1, 4, 4, 3), (7, 5))]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,out_hw", WEIGHTED_CASES)
def test_upsample_wce_kernels_match_plain(cuda, shape, out_hw, dtype):
    """K4 with the dark++ weights (0 for background and the new class)."""
    check_wce(shape, out_hw, dtype, cuda)


@pytest.mark.parametrize("kind", ["ones", "zeros", "random"])
def test_upsample_wce_kernels_other_weights(cuda, kind):
    """All-ones, all-zero (sums and gradient exactly 0, not NaN) and
    positive random weights, at the replay shape in bf16 and an odd one in
    f32."""
    w = {"ones": torch.ones(17, device=cuda), "zeros": torch.zeros(17, device=cuda),
         "random": torch.rand(17, device=cuda) + 0.1}[kind]
    check_wce((12, 32, 32, 17), (512, 512), torch.bfloat16, cuda, weights=w)
    check_wce((2, 5, 7, 17), (37, 51), torch.float32, cuda, weights=w)


@pytest.mark.parametrize("ukd", [True, False], ids=["ukd", "no-ukd"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,out_hw", WEIGHTED_CASES)
def test_upsample_bacs_kernels_match_plain(cuda, shape, out_hw, dtype, ukd):
    check_bacs(shape, out_hw, dtype, cuda, ukd=ukd)


# MiB's and PLOP's shapes at task 1 (17 classes, the teacher 16), odd ones
MIB_PLOP_CASES = [((12, 32, 32, 17), (512, 512)), ((2, 33, 47, 17), (261, 373)),
                  ((2, 5, 7, 6), (37, 51)), ((2, 8, 8, 40), (128, 128)),
                  ((1, 4, 4, 3), (7, 5))]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,out_hw", MIB_PLOP_CASES)
def test_upsample_uce_kernels_match_plain(cuda, shape, out_hw, dtype):
    """K6, old classes C - 1."""
    check_uce(shape, out_hw, dtype, cuda)


@pytest.mark.parametrize("alpha", [1.0, 0.7])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,out_hw", MIB_PLOP_CASES)
def test_upsample_ukd_kernels_match_plain(cuda, shape, out_hw, dtype, alpha):
    """K7, a teacher of C - 1 channels."""
    check_ukd(shape, out_hw, dtype, cuda, alpha=alpha)


# K7 on its redesigned template: the main shape, a downscale, a band that
# is not a multiple of the output height (512 rows in bands of 6 at batch
# 12), a teacher of one channel, students past one register chunk of 32
# (33, and 40 with a teacher of 39 past it too)
UKD_CASES = [((12, 32, 32, 17), 16, (512, 512)), ((2, 8, 8, 17), 16, (5, 7)),
             ((3, 9, 7, 17), 16, (100, 37)), ((2, 5, 7, 6), 1, (37, 51)),
             ((2, 6, 6, 33), 32, (40, 37)), ((2, 8, 8, 40), 39, (128, 128))]


@pytest.mark.parametrize("alpha", [1.0, 0.7])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,c_old,out_hw", UKD_CASES)
def test_ukd_pair_template_matches_plain(cuda, shape, c_old, out_hw, dtype, alpha):
    """K7 against its plain version (f32: value and gradient rtol 1e-4;
    bf16: value rtol 2e-3, gradient rtol 5e-2 of the largest gradient)."""
    check_ukd(shape, out_hw, dtype, cuda, alpha=alpha, c_old=c_old)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,out_hw", MIB_PLOP_CASES)
def test_upsample_ce_per_image_kernel_matches_plain(cuda, shape, out_hw, dtype):
    """K8, and K1's scalar case bit for bit."""
    check_ce_per_image(shape, out_hw, dtype, cuda)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,out_hw", [((12, 32, 32, 16), (512, 512))] + [
    ((n, h, w, c - 1), hw) for (n, h, w, c), hw in MIB_PLOP_CASES[1:]])
def test_upsample_pseudo_kernel_matches_plain(cuda, shape, out_hw, dtype):
    """K9 under the margin rule of ``chip_smoke.check_pseudo``."""
    check_pseudo(shape, out_hw, dtype, cuda)


# shapes of the forward-sums and backward-gather templates (K1, K3, K4, K6,
# K8) beyond the cases above: a downscale, a band of several output rows
# per source row at an odd scale, and channel counts past one and past four
# register chunks of 32
FAMILY_CASES = [((2, 8, 8, 21), (5, 7)), ((2, 6, 6, 33), (40, 37)),
                ((1, 5, 3, 151), (37, 20)), ((3, 9, 7, 40), (9, 7))]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,out_hw", FAMILY_CASES)
def test_upsample_loss_family_other_shapes_match_plain(cuda, shape, out_hw, dtype):
    """K1, K3 (ukd on and off), K4, K6 and K8 against their plain
    versions."""
    check_ce(shape, out_hw, dtype, cuda)
    check_bacs(shape, out_hw, dtype, cuda, ukd=True)
    check_bacs(shape, out_hw, dtype, cuda, ukd=False)
    check_wce(shape, out_hw, dtype, cuda)
    check_uce(shape, out_hw, dtype, cuda)
    check_ce_per_image(shape, out_hw, dtype, cuda)


@pytest.mark.parametrize("where", ["main", "small"])
def test_upsample_loss_family_launches_are_bit_equal(cuda, where):
    """Two launches of each forward and backward of K1, K3, K4, K6, K7, K12
    and of K2, K8, K9 and K10 on the same inputs give bit-equal outputs (no
    float atomics), at the main path's shapes and at small odd ones."""
    shapes = None if where == "main" else {
        "k1": (2, 5, 7, 21), "k3": (2, 5, 7, 17), "k4": (3, 6, 5, 17),
        "k6": (2, 7, 5, 40), "k7": (2, 5, 7, 17), "k8": (2, 5, 7, 17),
        "k9": (2, 5, 7, 33), "k10": (2, 7, 5, 25), "k2": (2, 5, 7, 21),
        "k12": (3, 6, 2, 5)}
    out_hw = (512, 512) if where == "main" else (37, 51)
    check_repeatable(family_calls(cuda, shapes=shapes, out_hw=out_hw))


def test_mib_plop_kernels_count_launches_and_reject_bad_inputs(cuda):
    from bacs_tpu_torch.ops.upsample_ce import (
        ce_dsem_per_image, ce_sums_per_image, uce_dsem, uce_sums, ukd_dsem, ukd_sum,
        upsampled_ce_sums_per_image, upsampled_unbiased_cross_entropy,
        upsampled_unbiased_kd)
    from bacs_tpu_torch.ops.upsample_pseudo import (
        plop_pseudo_labels, upsampled_plop_pseudo_labels)

    sem = torch.randn(2, 5, 7, 6, device=cuda, requires_grad=True)
    old = torch.randn(2, 5, 7, 5, device=cuda, requires_grad=True)
    labels = torch.randint(0, 6, (2, 37, 51), device=cuda)
    labels[0, :4] = 255
    counters = (uce_sums, uce_dsem, ukd_sum, ukd_dsem, ce_sums_per_image,
                ce_dsem_per_image, plop_pseudo_labels)
    before = [f.launches for f in counters]
    upsampled_unbiased_cross_entropy(sem, labels, (37, 51), 5).backward()
    upsampled_unbiased_kd(sem, old, (37, 51)).backward()
    assert old.grad is None
    thr = torch.full((21,), 0.05, device=cuda)
    me = torch.tensor(1.79, device=cuda)
    pseudo, num, den = upsampled_plop_pseudo_labels(old, labels, thr, (37, 51), me)
    sums, _ = upsampled_ce_sums_per_image(sem, pseudo, (37, 51))
    (sums * num / den.clamp(min=1)).sum().backward()
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1, 1, 1, 1, 1]
    for got, ref in (
        (upsampled_unbiased_cross_entropy(sem, labels, (37, 51), 5),
         upsampled_unbiased_cross_entropy(sem.cpu(), labels.cpu(), (37, 51), 5)),
        (upsampled_unbiased_kd(sem, old, (37, 51), 0.7),
         upsampled_unbiased_kd(sem.cpu(), old.cpu(), (37, 51), 0.7)),
    ):
        torch.testing.assert_close(got.detach().cpu(), ref.detach(), rtol=1e-5, atol=0)
    s = sem.detach()
    with pytest.raises(TypeError):
        ukd_sum(s, old.detach().bfloat16(), (37, 51))
    with pytest.raises(ValueError):  # the teacher must have fewer channels
        ukd_sum(s, s, (37, 51))
    with pytest.raises(ValueError):
        ukd_sum(s, old.detach()[:, :4].contiguous(), (37, 51))
    with pytest.raises(ValueError):  # one g per image
        ce_dsem_per_image(s, labels, (37, 51), torch.ones((), device=cuda))
    with pytest.raises(ValueError):
        plop_pseudo_labels(old.detach(), labels, thr[:4], (37, 51), me)
    with pytest.raises(TypeError):
        uce_sums(s.half(), labels, (37, 51), 5)


def test_weighted_upsample_kernels_count_launches_and_reject_bad_inputs(cuda):
    from bacs_tpu_torch.ops.upsample_ce import (
        bacs_dsem, bacs_sum, upsampled_bacs_weighted_ce,
        upsampled_weighted_cross_entropy, wce_dsem, wce_sums)

    sem = torch.randn(2, 5, 7, 6, device=cuda, requires_grad=True)
    labels = torch.randint(0, 6, (2, 37, 51), device=cuda)
    labels[0, :4] = 255
    w = torch.rand(6, device=cuda)
    ms = torch.rand(2, 37, 51, device=cuda)
    before = (wce_sums.launches, wce_dsem.launches, bacs_sum.launches,
              bacs_dsem.launches)
    upsampled_weighted_cross_entropy(sem, labels, w, (37, 51)).backward()
    upsampled_bacs_weighted_ce(sem, labels, ms, (37, 51), 5).backward()
    assert (wce_sums.launches, wce_dsem.launches, bacs_sum.launches,
            bacs_dsem.launches) == tuple(b + 1 for b in before)
    for got, ref in (
        (upsampled_weighted_cross_entropy(sem, labels, w, (37, 51)),
         upsampled_weighted_cross_entropy(sem.cpu(), labels.cpu(), w.cpu(), (37, 51))),
        (upsampled_bacs_weighted_ce(sem, labels, ms, (37, 51), 5, ukd=False),
         upsampled_bacs_weighted_ce(sem.cpu(), labels.cpu(), ms.cpu(), (37, 51), 5,
                                    ukd=False)),
    ):
        torch.testing.assert_close(got.detach().cpu(), ref.detach(), rtol=1e-5, atol=0)
    with pytest.raises(ValueError):
        wce_sums(sem.detach(), labels, w[:5], (37, 51))
    with pytest.raises(ValueError):
        wce_sums(sem.detach(), labels, w.double(), (37, 51))
    with pytest.raises(ValueError):
        bacs_sum(sem.detach(), labels, ms[:, :30], (37, 51), 5)
    with pytest.raises(ValueError):
        bacs_dsem(sem.detach(), labels, ms.half(), (37, 51), torch.ones((), device=cuda), 5)
    with pytest.raises(TypeError):
        bacs_sum(sem.detach().half(), labels, ms, (37, 51), 5)


def test_upsample_kernels_take_int64_labels_and_count_launches(cuda):
    from bacs_tpu_torch.ops.upsample_ce import (
        ce_dsem, ce_sums_per_image, upsampled_cross_entropy)
    from bacs_tpu_torch.ops.upsample_confusion import upsampled_confusion

    sem = torch.randn(2, 5, 7, 6, device=cuda, requires_grad=True)
    labels = torch.randint(0, 6, (2, 37, 51), device=cuda)
    labels[0, :4] = 255
    before = (ce_sums_per_image.launches, ce_dsem.launches)
    loss = upsampled_cross_entropy(sem, labels, (37, 51))
    loss.backward()
    assert (ce_sums_per_image.launches, ce_dsem.launches) == (before[0] + 1,
                                                              before[1] + 1)
    ref = upsampled_cross_entropy(sem.detach().cpu().requires_grad_(),
                                  labels.cpu(), (37, 51))
    torch.testing.assert_close(loss.cpu(), ref.detach(), rtol=1e-5, atol=0)
    before = upsampled_confusion.launches
    conf = upsampled_confusion(sem.detach(), labels, (37, 51), 6)
    assert upsampled_confusion.launches == before + 1
    assert int(conf.sum()) == int((labels != 255).sum())
    with pytest.raises(TypeError):
        ce_sums_per_image(sem.detach().half(), labels, (37, 51))
    with pytest.raises(TypeError):
        upsampled_confusion(sem.detach(), labels.float(), (37, 51), 6)
    with pytest.raises(ValueError):  # its histogram would not fit in shared memory
        upsampled_confusion(sem.detach(), labels, (37, 51), 242)
    with pytest.raises(ValueError):
        ce_sums_per_image(sem.detach(), labels[:, :30], (37, 51))
    with pytest.raises(ValueError):
        ce_dsem(sem.detach(), labels, (37, 51), torch.ones(2, device=cuda))


def test_wrappers_count_launches_and_reject_bad_inputs(cuda):
    from bacs_tpu_torch.ops.abn_core import fused_abn_eval
    from bacs_tpu_torch.ops.upsample_argmax import upsampled_argmax_conf

    v = [torch.ones(8, device=cuda) for _ in range(4)]
    x = torch.randn(2, 4, 4, 8, device=cuda)
    before = fused_abn_eval.launches
    fused_abn_eval(x, *v)
    assert fused_abn_eval.launches == before + 1
    with pytest.raises(TypeError):
        fused_abn_eval(x.half(), *v)
    with pytest.raises(ValueError):
        fused_abn_eval(x.transpose(1, 2), *v)
    with pytest.raises(ValueError):
        fused_abn_eval(x, v[0][:4], *v[1:])

    sem = torch.randn(1, 4, 4, 5, device=cuda)
    before = upsampled_argmax_conf.launches
    upsampled_argmax_conf(sem, (16, 16))
    assert upsampled_argmax_conf.launches == before + 1
    with pytest.raises(TypeError):
        upsampled_argmax_conf(sem.half(), (16, 16))
    with pytest.raises(ValueError):
        upsampled_argmax_conf(sem.transpose(1, 2), (16, 16))


def test_predictor_on_the_card_matches_the_cpu(cuda):
    """The Predictor's CUDA path (pinned upload, copy stream, pipelined
    predict_many) against the same Predictor on the CPU, in f32."""
    import numpy as np

    from bacs_tpu_torch.models import create_network
    from bacs_tpu_torch.serve import Predictor
    from bacs_tpu_torch.utils.flax_weights import state_dict_to_flax

    torch.manual_seed(0)
    params, stats = state_dict_to_flax(
        create_network("deeplab", 21, backbone="resnet18").state_dict())
    cfg = {"backbone": "resnet18"}
    kw = dict(crop_size=64, dtype=torch.float32, conf_dtype="uint8",
              pack_masks=True)
    allow_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        gpu = Predictor(cfg, 21, params, stats, device=cuda, **kw)
        cpu = Predictor(cfg, 21, params, stats, device="cpu", **kw)
        rs = np.random.RandomState(0)
        batches = [rs.randint(0, 256, (n, 64, 64, 3)).astype(np.uint8)
                   for n in (2, 1, 3)]
        many = list(gpu.predict_many(batches))
        for b, (preds, conf) in zip(batches, many):
            one_p, one_c = gpu.predict(b)
            np.testing.assert_array_equal(preds, one_p)
            np.testing.assert_array_equal(conf, one_c)
            ref_p, ref_c = cpu.predict(b)
            assert (preds == ref_p).mean() >= 0.999
            assert np.abs(conf.astype(int) - ref_c.astype(int)).max() <= 1
    finally:
        torch.backends.cudnn.allow_tf32 = allow_tf32


def test_train_and_eval_steps_on_the_card_match_the_cpu(cuda):
    """``make_steps`` on the card (kernels) against the CPU (plain versions),
    RN18 at 4 x 64^2 in f32 with TF32 off: the first loss within 1e-4 and
    the eval step's confusion matrix on the initial weights equal but for
    near ties; one K1 forward and backward per train step, one K1 forward
    and one K2 per eval step."""
    import numpy as np

    from bacs_tpu_torch.methods import ModelContext, create_method
    from bacs_tpu_torch.models import create_network
    from bacs_tpu_torch.ops.upsample_ce import ce_dsem, ce_sums_per_image
    from bacs_tpu_torch.ops.upsample_confusion import upsampled_confusion
    from bacs_tpu_torch.train.optim import make_optimizer, poly_schedule
    from bacs_tpu_torch.train.state import TaskInfo, TrainState
    from bacs_tpu_torch.train.step import make_steps

    torch.manual_seed(0)
    sd = create_network("deeplab", 5, backbone="resnet18").state_dict()
    rs = np.random.RandomState(0)
    labels = rs.randint(0, 5, (4, 64, 64)).astype(np.int32)
    labels[rs.rand(*labels.shape) < 0.05] = 255
    batch = {"image": rs.randn(4, 64, 64, 3).astype(np.float32), "label": labels}
    ctx = ModelContext(TaskInfo(num_classes=5))
    allow_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = {}
        for device in (cuda, torch.device("cpu")):
            model = create_network("deeplab", 5, backbone="resnet18")
            model.load_state_dict(sd)
            model.to(device)
            opt, sched = make_optimizer({"momentum": 0.9, "nesterov": True},
                                        model.parameters(), poly_schedule(0.01, 10))
            state = TrainState(model, opt, sched)
            train_step, eval_step, put_batch = make_steps(
                ctx, create_method("loss.CrossEntropy"), 5, device=device)
            b = put_batch(batch)
            counts = (ce_sums_per_image.launches, ce_dsem.launches,
                      upsampled_confusion.launches)
            cm, _ = eval_step(state, torch.zeros((5, 5), dtype=torch.int32,
                                                 device=device), b)
            state, metrics = train_step(state, b)
            launched = (ce_sums_per_image.launches - counts[0],
                        ce_dsem.launches - counts[1],
                        upsampled_confusion.launches - counts[2])
            out[device.type] = (cm.cpu(), float(metrics["loss"]), launched)
    finally:
        torch.backends.cudnn.allow_tf32 = allow_tf32
    assert out["cuda"][2] == (2, 1, 1) and out["cpu"][2] == (0, 0, 0)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-4)
    moved = int((out["cuda"][0] - out["cpu"][0]).abs().sum()) // 2
    assert int(out["cuda"][0].sum()) == int((labels != 255).sum())
    assert moved <= 0.001 * int((labels != 255).sum())


STEM_SHAPES = [(2, 8, 12, 8), (3, 6, 2, 5), (2, 10, 2, 64), (12, 256, 256, 64),
               # the redesign's tiles: a pooled height that is no multiple of
               # the band, pooled widths past one tile of columns (32 at C =
               # 64, 51 at C = 5), and the narrow path at C = 5 and 24
               (3, 22, 140, 64), (2, 18, 230, 5), (1, 30, 70, 24), (16, 256, 256, 64)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("levels", [None, 3], ids=["random", "ties"])
@pytest.mark.parametrize("shape", STEM_SHAPES)
def test_stem_pool_kernels_match_plain(cuda, shape, levels, dtype):
    """K12 forward and backward (f32: value rtol 2e-3, gradient 5e-2; bf16:
    values exact, gradients exact outside windows with a near tie), on
    random inputs and on inputs on three levels (ties)."""
    check_stem(shape, dtype, cuda, levels=levels)


def test_stem_pool_kernels_raise_and_count_launches(cuda):
    """A CUDA tensor the kernel does not take raises; the autograd function
    launches each kernel once per call on the card and agrees with its CPU
    run (the plain versions) to f32 rounding of the statistics."""
    from bacs_tpu_torch.ops.stem_pool import fused_abn_pool, stem_pool_fwd, stem_pool_grad

    stem_raises(cuda)
    g = torch.Generator().manual_seed(0)
    c = torch.randn((2, 16, 12, 8), generator=g)
    scale, bias = torch.rand(8, generator=g) + 0.5, torch.randn(8, generator=g) * 0.1
    w = torch.randn((2, 8, 6, 8), generator=g)
    out = {}
    for device in (cuda, torch.device("cpu")):
        x = c.to(device).requires_grad_()
        f0, b0 = stem_pool_fwd.launches, stem_pool_grad.launches
        p, mean, var = fused_abn_pool(x, scale.to(device), bias.to(device))
        (p * w.to(device)).sum().backward()
        if device.type == "cuda":
            assert (stem_pool_fwd.launches - f0, stem_pool_grad.launches - b0) == (1, 1)
        out[device.type] = [t.detach().cpu() for t in (p, mean, var, x.grad)]
    for got, ref in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)


@pytest.fixture
def world1(cuda):
    """A world-1 gloo group (it carries CUDA and CPU tensors alike),
    destroyed after the test."""
    import torch.distributed as dist

    from bacs_tpu_torch import parallel

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{parallel.free_port()}",
                            rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kernel", ["k5", "k12"])
def test_kernels_fed_all_reduced_statistics_match_plain(cuda, world1, kernel):
    """The train ABN apply (K5) and the fused stem (K12, forward and
    backward) with their statistics all-reduced over a world-1 group, on
    the card, against their plain versions on the CPU through the same
    group: values rtol 2e-3, gradients rtol 5e-2 (of the largest)."""
    from bacs_tpu_torch.ops.abn_core import fused_abn
    from bacs_tpu_torch.ops.stem_pool import fused_abn_pool, stem_pool_fwd

    g = torch.Generator().manual_seed(3)
    c = torch.randn((4, 32, 24, 64), generator=g)
    scale, bias = torch.rand(64, generator=g) + 0.5, torch.randn(64, generator=g) * 0.1
    w = torch.randn((4, 32, 24, 64) if kernel == "k5" else (4, 16, 12, 64), generator=g)
    out = {}
    for device in (cuda, torch.device("cpu")):
        x = c.to(device).requires_grad_()
        s, b = (t.to(device).requires_grad_() for t in (scale, bias))
        before = (fused_abn if kernel == "k5" else stem_pool_fwd).launches
        if kernel == "k5":
            y, mean, var = fused_abn(x, s, b, 1e-5, 0.01, world1)
        else:
            y, mean, var = fused_abn_pool(x, s, b, 1e-5, 0.01, world1)
        (y * w.to(device)).sum().backward()
        if device.type == "cuda":
            assert (fused_abn if kernel == "k5" else stem_pool_fwd).launches == before + 1
        out[device.type] = [t.detach().cpu() for t in (y, mean, var, x.grad, s.grad, b.grad)]
    for i, (got, ref) in enumerate(zip(out["cuda"], out["cpu"])):
        tol = 2e-3 if i < 3 else 5e-2
        torch.testing.assert_close(got, ref, rtol=0, atol=tol * float(ref.abs().max()))


# the registered ops (bacs::abn_eval, bacs::upsample_argmax_conf) that keep
# K5 and K10 as nodes of a torch.export program (serve.Predictor.export)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", K5_SHAPES)
def test_abn_eval_op_equals_its_launch(cuda, shape, dtype):
    """``bacs::abn_eval`` on CUDA tensors, bit-equal to the Triton launch
    it wraps, counted once on ``fused_abn_eval.launches``."""
    import types

    from bacs_tpu_torch.ops.abn_core import _abn_apply_triton, fused_abn_eval

    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    v = [torch.rand(shape[-1], generator=g, device=cuda) + 0.5 for _ in range(4)]
    before = fused_abn_eval.launches
    y = torch.ops.bacs.abn_eval(x, *v, 1e-5, 0.01)
    assert fused_abn_eval.launches == before + 1
    ref = _abn_apply_triton(x, *v, 1e-5, 0.01, types.SimpleNamespace(launches=0))
    assert torch.equal(y, ref)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,out_hw", K10_CASES)
def test_upsample_argmax_op_equals_its_launch(cuda, shape, out_hw, dtype):
    """``bacs::upsample_argmax_conf`` on CUDA tensors, bit-equal to the
    kernel's launch, counted once on ``upsampled_argmax_conf.launches``."""
    from bacs_tpu_torch.ops.upsample_argmax import _argmax_conf_cuda, upsampled_argmax_conf

    g = torch.Generator(device=cuda).manual_seed(6)
    sem = (torch.randn(shape, generator=g, device=cuda) * 4).to(dtype)
    before = upsampled_argmax_conf.launches
    preds, conf = torch.ops.bacs.upsample_argmax_conf(sem, *out_hw)
    assert upsampled_argmax_conf.launches == before + 1
    ref_p, ref_c = _argmax_conf_cuda(sem, out_hw)
    assert torch.equal(preds, ref_p) and torch.equal(conf, ref_c)


def test_export_keeps_each_op_as_a_node(cuda):
    """``torch.export`` of one eval ABN followed by the upsample+argmax
    keeps one node of each op, and the loaded program launches both
    kernels and equals the module."""
    from bacs_tpu_torch.ops.abn_core import fused_abn_eval
    from bacs_tpu_torch.ops.upsample_argmax import upsampled_argmax_conf

    class OneLayer(torch.nn.Module):
        def __init__(self, c):
            super().__init__()
            for name in ("mean", "var", "scale", "bias"):
                self.register_buffer(name, torch.rand(c, device=cuda) + 0.5)

        def forward(self, x):
            y = fused_abn_eval(x, self.mean, self.var, self.scale, self.bias, 1e-5, 0.01)
            return upsampled_argmax_conf(y, (128, 128))

    m = OneLayer(21)
    x = torch.randn((2, 16, 16, 21), device=cuda).to(torch.bfloat16)
    program = torch.export.export(m, (x,))
    ops = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert ops.count("bacs.abn_eval.default") == ops.count(
        "bacs.upsample_argmax_conf.default") == 1, ops
    before = (fused_abn_eval.launches, upsampled_argmax_conf.launches)
    got = program.module()(x)
    assert (fused_abn_eval.launches, upsampled_argmax_conf.launches) == (
        before[0] + 1, before[1] + 1)
    ref = m(x)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


# ---------------------------------------------------------------- port-only kernels


@pytest.mark.parametrize("shape", [DRAW_SHAPE, (7,), (3, 5, 33), (1, 1)],
                         ids=["mask", "1d", "3d", "one"])
@pytest.mark.parametrize("mode", [0, 1, 2], ids=["bits", "uniform", "bernoulli"])
def test_threefry_kernel_equals_plain(cuda, shape, mode):
    from bacs_tpu_torch.ops import rng

    kw = ({}, dict(lo=-0.3, span=2.8), dict(p=DROPOUT_KEEP))[mode]
    k = rng.fold_in(rng.key(11), mode)
    before = rng.threefry_fill.launches
    got = rng.threefry_fill(k, shape, mode, cuda, **kw)
    assert rng.threefry_fill.launches == before + 1
    assert torch.equal(got, rng.fill_plain(k, shape, mode, cuda, **kw))
    assert torch.equal(got.cpu(), rng.fill_plain(k, shape, mode, "cpu", **kw))
    assert torch.equal(got, rng.threefry_fill(k, shape, mode, cuda, **kw))


def test_card_draws_are_the_cpus(cuda):
    """The same key draws the same dropout mask and crops on the card as on
    the CPU, through the public draws the main path takes."""
    from bacs_tpu_torch.data import transforms
    from bacs_tpu_torch.ops import rng

    k = rng.key(42)
    assert torch.equal(rng.bernoulli(k, DROPOUT_KEEP, DRAW_SHAPE, cuda).cpu(),
                       rng.bernoulli(k, DROPOUT_KEEP, DRAW_SHAPE, "cpu"))
    crops = [transforms.sample_crop_params(16, (512, 512), k, d)
             for d in (cuda, "cpu")]
    for f in crops[1]:
        assert torch.equal(crops[0][f].cpu(), crops[1][f]), f
    assert torch.equal(rng.uniform(k, (64,), -1.0, 3.0, cuda).cpu(),
                       rng.uniform(k, (64,), -1.0, 3.0, "cpu"))


@pytest.mark.parametrize("name,shape,dtype,size,align", RESIZE_CASES,
                         ids=[c[0] for c in RESIZE_CASES])
def test_resize_kernels_match_interpolate(cuda, name, shape, dtype, size, align):
    check_resize(shape, dtype, size, align, cuda)


@pytest.mark.parametrize("shape,size,align", [((2, 5, 7, 3), (16, 20), False),
                                              ((2, 9, 7, 4), (5, 3), True),
                                              ((1, 3, 3, 2), (1, 7), True)])
def test_resize_kernels_at_odd_shapes(cuda, shape, size, align):
    for dtype in DTYPES:
        check_resize(shape, dtype, size, align, cuda)


def test_ce_and_bacs_steps_run_deterministically(cuda):
    """One CE and one BACS step at 512^2 (``chip_smoke.deterministic_states``)
    under ``torch.use_deterministic_algorithms(True)``, each from two copies
    of one state: no op raises and the copies end bit-equal."""
    script = (
        "import torch, chip_smoke as cs\n"
        "dev = torch.device('cuda', 0)\n"
        "cfg = cs.network_cfg()\n"
        "params, stats = cs.seeded_variables(cfg, 0)\n"
        "b = dict(cs.deterministic_states(cfg, params, stats, 0, dev))\n"
        "torch.use_deterministic_algorithms(True)\n"
        "for name in ('ce', 'bacs'):\n"
        "    print(name, cs.steps_twice_equal(*b[name]()), flush=True)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    res = subprocess.run([sys.executable, "-c", script], cwd=root, env=env,
                         capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    assert "ce equal" in lines and "bacs equal" in lines, res.stdout
