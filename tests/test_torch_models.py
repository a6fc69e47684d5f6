"""Port networks against Flax on the same (randomised) variables, on the CPU.

The Flax variables are initialised by the JAX package, then every ABN
vector is redrawn with numpy (``randomize_abn``); ``flax_weights`` carries
them across.
"""

import functools

import numpy as np
import pytest
import torch

import jax

from bacs_tpu.models import create_network as jax_create_network
from bacs_tpu_torch.models import ABN, create_network
from bacs_tpu_torch.utils.flax_weights import (
    flax_to_state_dict,
    load_flax_variables,
    state_dict_to_flax,
)
from torch_port_helpers import _one_thread, randomize_abn  # noqa: F401

CROP = 64
NUM_CLASSES = 5


def jax_model(backbone, output_stride):
    return jax_create_network(
        "networks.DeepLabV3", num_classes=NUM_CLASSES, norm="iabn_sync",
        axis_name=None, backbone=backbone, output_stride=output_stride,
    )


@functools.lru_cache(maxsize=None)
def flax_variables(backbone):
    """Randomised (params, batch_stats); the shapes do not depend on the
    output stride, so one init serves both."""
    x = np.zeros((1, CROP, CROP, 3), np.float32)
    m = jax_model(backbone, 16)
    v = jax.jit(lambda k, x: m.init(k, x, train=False))(jax.random.PRNGKey(0), x)
    rs = np.random.RandomState(7)
    return randomize_abn(v["params"], rs), randomize_abn(v["batch_stats"], rs)


def images(seed=0, n=2):
    return np.random.RandomState(seed).randn(n, CROP, CROP, 3).astype(np.float32)


def run_both(backbone, output_stride):
    params, stats = flax_variables(backbone)
    x = images()
    ref = jax.jit(
        lambda p, s, x: jax_model(backbone, output_stride).apply(
            {"params": p, "batch_stats": s}, x, train=False)
    )(params, stats, x)
    model = create_network(
        "networks.DeepLabV3", NUM_CLASSES, backbone=backbone,
        output_stride=output_stride,
    ).eval()
    load_flax_variables(model, params, stats)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    return ref, got, model, x


@pytest.mark.parametrize("output_stride", [16, 8])
@pytest.mark.parametrize("backbone", ["resnet18", "resnet50"])
def test_sem_logits_match_flax(backbone, output_stride):
    ref, got, model, x = run_both(backbone, output_stride)
    ref_sem = np.asarray(ref.sem_logits)
    assert got.sem_logits.shape == ref_sem.shape == (
        2, CROP // output_stride, CROP // output_stride, NUM_CLASSES)
    scale = np.abs(ref_sem).max()
    np.testing.assert_allclose(
        got.sem_logits.numpy(), ref_sem, rtol=1e-4, atol=1e-4 * scale
    )
    # the Predictor's entry point gives the same tensor
    with torch.no_grad():
        direct = model.sem_logits(torch.from_numpy(x))
    torch.testing.assert_close(direct, got.sem_logits, rtol=0, atol=0)


def test_net_output_contract_matches_flax():
    ref, got, _, _ = run_both("resnet18", 16)
    for name in ("logits", "penultimate"):
        r = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(
            getattr(got, name).numpy(), r, rtol=1e-4, atol=1e-4 * np.abs(r).max()
        )
    assert len(got.attentions) == len(ref.attentions) == 5
    for g, r in zip(got.attentions, ref.attentions):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max())


def test_flax_state_dict_round_trip():
    params, stats = flax_variables("resnet18")
    sd = flax_to_state_dict(params, stats)
    assert sd["backbone.conv1.weight"].shape == (64, 3, 7, 7)
    assert sd["backbone.mod2_block1.bn1.running_var"].shape == (64,)
    assert sd["classifier_head.bias"].shape == (NUM_CLASSES,)
    p2, s2 = state_dict_to_flax(sd)
    sd2 = flax_to_state_dict(p2, s2)
    assert sd2.keys() == sd.keys()
    for k in sd:
        torch.testing.assert_close(sd2[k], sd[k], rtol=0, atol=0)


def test_load_flax_variables_rejects_missing_and_extra_keys():
    params, stats = flax_variables("resnet18")
    model = create_network("deeplab", NUM_CLASSES, backbone="resnet18")
    short = {k: v for k, v in params.items() if k != "classifier_head"}
    with pytest.raises(KeyError, match="missing"):
        load_flax_variables(model, short, stats)
    extra = dict(params, extra_head={"kernel": np.zeros((1, 1, 2, 2), np.float32)})
    with pytest.raises(KeyError, match="extra"):
        load_flax_variables(model, extra, stats)


def test_bf16_network_keeps_abn_in_float32():
    model = create_network("deeplab", NUM_CLASSES, backbone="resnet18",
                           dtype=torch.bfloat16)
    assert model.backbone.conv1.weight.dtype == torch.bfloat16
    assert model.backbone.conv1.weight.is_contiguous(memory_format=torch.channels_last)
    assert model.backbone.bn1.running_var.dtype == torch.float32
    with torch.no_grad():
        out = model.eval().sem_logits(torch.zeros(1, 32, 32, 3, dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16 and out.shape == (1, 2, 2, NUM_CLASSES)


def test_unported_networks_raise():
    """Every network builds: the atrous encoder (held to Flax by
    ``tests/test_torch_atrous.py``) with six attention maps; UNet and
    TranSeg (held to Flax by ``tests/test_torch_unet.py`` and
    ``tests/test_torch_transeg.py``), TranSeg emitting full-width logits
    with its inactive channels filled."""
    with torch.no_grad():
        out = create_network("networks.UNet", NUM_CLASSES).eval()(torch.zeros(1, 32, 32, 3))
        assert out.sem_logits.shape == (1, 32, 32, NUM_CLASSES)
        net = create_network("networks.TranSeg", NUM_CLASSES, active_classes=3,
                             backbone="resnet18", crop_size=32,
                             transformer=dict(hidden_dim=16, dim_feedforward=32))
        out = net.eval()(torch.zeros(1, 32, 32, 3))
    assert out.sem_logits.shape == (1, 2, 2, NUM_CLASSES)
    assert bool((out.sem_logits[..., 3:] == -1e9).all())
    with torch.no_grad():
        out = create_network("deeplab", NUM_CLASSES, atrous_encoder=True,
                             backbone="resnet50").eval()(torch.zeros(1, 32, 32, 3))
    assert len(out.attentions) == 6 and out.sem_logits.shape == (1, 2, 2, NUM_CLASSES)
    net = create_network("networks.TranSeg", NUM_CLASSES, atrous_encoder=True,
                         backbone="resnet18", crop_size=32)
    assert all(m.sync for m in net.modules() if isinstance(m, ABN))
