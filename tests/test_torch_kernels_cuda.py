"""The port's hand-written kernels against their plain versions, on the card.

Every test needs a CUDA device and skips with a reason where torch sees
none; run them on a GPU machine with
``python -m pytest tests/test_torch_kernels_cuda.py -q``.  The checks are
those of ``chip_smoke.py`` (phases 2 and 3), at small and at serving shapes.
"""

import pytest
import torch

from chip_smoke import check_abn, check_argmax

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
