"""The port's initial weights for a seed against JAX's ``model.init`` for
the same seed, on the CPU (``bacs_tpu_torch/utils/flax_init.py``).

JAX's Trainer draws them eagerly, ``model.init({"params": r_param,
"dropout": r_drop}, ...)`` with ``r_param, r_drop, r_state =
split(PRNGKey(seed), 3)`` (``bacs_tpu/train/loop.py:253-260``); here JAX
draws them by ``model.lazy_init`` (the same eager initializers, without
the dummy forward's compute).  Every parameter tensor of the port's
network, read back in Flax's layout, is held bit-equal to JAX's (no ulp
tolerance is needed: the port's normals take XLA's CPU ``erf_inv``,
``ops/rng.py``), for DeepLabV3 on ResNet-18 (with the detector, through
both packages' Trainers on ``conf/continual_debug``), ResNet-50 and
ResNet-101, the SDR atrous encoder, UNet (4 levels, transpose
convolutions, the detector) and TranSeg (ResNet-18, the detector).  The
native host draws (``csrc/host/fastdraw.cpp``) equal their plain torch
version bit for bit.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bacs_tpu.config import load_config as jax_load_config
from bacs_tpu.models import create_network as jax_create_network
from bacs_tpu.train import loop as jax_loop
from bacs_tpu_torch.config import load_config
from bacs_tpu_torch.models import create_network
from bacs_tpu_torch.ops import rng
from bacs_tpu_torch.train import loop
from bacs_tpu_torch.utils.flax_init import init_weights, trainer_keys
from bacs_tpu_torch.utils.flax_weights import state_dict_to_flax
from torch_port_helpers import _one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 5
TR = dict(hidden_dim=32, dim_feedforward=64)
# (name, create_network arguments shared by both packages, crop)
NETWORKS = {
    "deeplab_resnet50": (dict(name="deeplab", backbone="resnet50"), 32),
    "deeplab_resnet101": (dict(name="deeplab", backbone="resnet101"), 32),
    "deeplab_atrous_resnet50": (dict(name="deeplab", backbone="resnet50",
                                     atrous_encoder=True), 32),
    "unet4_tconv_detector": (dict(name="unet", num_layers=4, bilinear=False,
                                  use_bg_detector=True), 32),
    "transeg_resnet18_detector": (dict(name="transeg", backbone="resnet18",
                                       use_bg_detector=True, transformer=TR), 64),
}


def leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, path + (k,))
        else:
            yield "/".join(path + (k,)), np.asarray(v)


def jax_init(model, seed, crop):
    """JAX's initial parameters of ``model`` for ``seed``, as the Trainer
    draws them."""
    r_param, r_drop, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
    v = model.lazy_init({"params": r_param, "dropout": r_drop},
                        jax.ShapeDtypeStruct((1, crop, crop, 3), jnp.float32), train=True)
    return dict(leaves(jax.device_get(v["params"])))


def port_params(model):
    params, _ = state_dict_to_flax(model.state_dict())
    return dict(leaves(params))


def assert_bit_equal(got, ref):
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("net", list(NETWORKS))
def test_network_init_equals_jax_model_init(net):
    kw, crop = NETWORKS[net]
    kw = dict(kw, num_classes=21, n_tasks=3)
    name = kw.pop("name")
    if name == "transeg":
        kw["crop_size"] = crop
    ref = jax_init(jax_create_network(name, axis_name=None, **kw), SEED, crop)
    model = create_network(name, **kw)
    init_weights(model, SEED)
    assert_bit_equal(port_params(model), ref)


@functools.lru_cache(maxsize=None)
def jax_trainer_init():
    overrides = ["network=deep_lab", "dataset.dataset.crop_size=32",
                 "training.bg_detector=true", f"training.seed={SEED}"]
    trainer = jax_loop.Trainer(jax_load_config(os.path.join(ROOT, "conf", "continual_debug"),
                                               "config", overrides))
    task = trainer._task_info(0)
    state = trainer._init_state(trainer._make_model(task), trainer._make_tx(task), task)
    return (dict(leaves(jax.device_get(state.params))),
            tuple(int(v) for v in np.asarray(state.rng)), overrides)


def test_trainer_init_and_key_equal_jax_trainer():
    """DeepLabV3-RN18 with the detector through both Trainers: the same
    parameters bit for bit and the same state key (JAX's ``r_state``)."""
    ref, ref_key, overrides = jax_trainer_init()
    trainer = loop.Trainer(load_config(os.path.join(ROOT, "conf", "continual_debug"),
                                       "config", overrides), device="cpu")
    state = trainer._init_state(trainer._task_info(0))
    assert trainer.seed == SEED and trainer.use_bg_detector
    assert_bit_equal(port_params(state.model), ref)
    assert state.key == ref_key == trainer_keys(SEED)[2]


@pytest.mark.parametrize("truncated", [False, True], ids=["normal", "truncated"])
def test_native_draws_equal_the_plain_version(truncated):
    """The host library's normals (``csrc/host/fastdraw.cpp``, built here
    with g++) equal the torch plain version bit for bit, on one thread and
    on four."""
    assert rng._native() is not None
    shape = (3, 5, 7, 700)  # past the size the library splits among threads
    plain = rng._normal_plain(rng.key(3), shape, truncated)
    try:
        for threads in (1, 4):
            torch.set_num_threads(threads)
            assert torch.equal(rng._normal_host(rng.key(3), shape, truncated), plain)
    finally:
        torch.set_num_threads(1)
