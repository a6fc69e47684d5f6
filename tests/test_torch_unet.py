"""The port's UNet against the Flax UNet, on the CPU.

UNet-3 and UNet-4 at 32^2, 5 classes, bilinear and transpose, with and
without the background detector (four networks that hold every pair of
those choices; the detector's dropout at rate 0 on both sides, its
masks held in ``tests/test_torch_seed_keys.py``), from the
same Flax variables: initialised by the JAX package, every norm vector
and convolution bias redrawn by ``randomize_abn``, carried across by
``utils/flax_weights.py``.  Also the ``flax_weights`` round trip of the
transpose convolutions, the distributions of ``init_weights`` (JAX's
``model.init`` draws for a seed, ``utils/flax_init.py``) and the
Predictor on UNet against the JAX Predictor.  The steps on UNet are in
``tests/test_torch_unet_steps.py``.

Tolerances are stated per test.  A forward holds to f32 rounding (1e-4
of each output's largest value; measured below 7e-6).  Gradients pass
two kinks, UNet's ReLU and the max-pool's choice of a window's largest:
where a pre-activation or a window's top two lie within rounding, the
packages may take different branches, and the batch norm's backward
spreads that pixel over its channel.
"""

import contextlib
import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

import bacs_tpu.models.unet as jax_unet
from bacs_tpu.models import create_network as jax_create_network
from bacs_tpu.serve import Predictor as JaxPredictor
from bacs_tpu_torch.models import create_network
from bacs_tpu_torch.models.unet import ConvTranspose2d, DoubleConv, UNet
from bacs_tpu_torch.serve import Predictor
from bacs_tpu_torch.utils.flax_init import init_weights
from bacs_tpu_torch.utils.flax_weights import (
    flax_to_state_dict,
    load_flax_variables,
    state_dict_to_flax,
)
from torch_port_helpers import _one_thread, randomize_abn  # noqa: F401

CROP, NUM_CLASSES, N_TASKS, BATCH = 32, 5, 3, 2
# UNet-3 and UNet-4, bilinear and transpose, with and without the detector:
# every level of each factor and every pair of levels of two factors
NETS = [(3, True, False), (3, False, True), (4, True, True), (4, False, False)]
NET_IDS = [f"unet{layers}-{'bilinear' if b else 'tconv'}{'-det' if d else ''}"
           for layers, b, d in NETS]


class SmoothDoubleConv(jax_unet.DoubleConv):
    """The Flax block without its ReLUs."""

    @nn.compact
    def __call__(self, x, train: bool = True):
        mid = self.mid_channels or self.out_channels
        for i, ch in enumerate((mid, self.out_channels)):
            x = nn.Conv(ch, (3, 3), padding=[(1, 1), (1, 1)], dtype=self.dtype,
                        name=f"conv{i + 1}")(x)
            x = nn.BatchNorm(use_running_average=not train, momentum=0.9,
                             name=f"bn{i + 1}")(x)
        return x


def smooth_forward(self, x):
    return self.bn2(self.conv2(self.bn1(self.conv1(x))))


@contextlib.contextmanager
def variant(smooth):
    """The JAX detector without dropout (the port's is set to 0 alike) and,
    with ``smooth``, both packages' UNet blocks
    without their ReLUs: no kink, so gradients agree to rounding."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(
            jax_unet, "BgDetector", functools.partial(jax_unet.BgDetector, dropout_rate=0.0)))
        if smooth:
            stack.enter_context(mock.patch.object(jax_unet, "DoubleConv", SmoothDoubleConv))
            stack.enter_context(mock.patch.object(DoubleConv, "forward", smooth_forward))
        yield


def jax_model(layers, bilinear, det):
    return jax_create_network("unet", NUM_CLASSES, n_tasks=N_TASKS, use_bg_detector=det,
                              axis_name=None, num_layers=layers, bilinear=bilinear)


def port_model(layers, bilinear, det):
    model = create_network("unet", NUM_CLASSES, n_tasks=N_TASKS, use_bg_detector=det,
                           num_layers=layers, bilinear=bilinear)
    if det:
        model.seen_fg_network.dropout_rate = 0.0
    load_flax_variables(model, *flax_variables(layers, bilinear, det))
    return model


@functools.lru_cache(maxsize=None)
def flax_variables(layers, bilinear, det):
    x = np.zeros((1, CROP, CROP, 3), np.float32)
    m = jax_model(layers, bilinear, det)
    v = jax.jit(lambda k, x: m.init(k, x, train=False))(jax.random.PRNGKey(0), x)
    rs = np.random.RandomState(7)
    return randomize_abn(v["params"], rs), randomize_abn(v["batch_stats"], rs)


def flat(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float32)


def outputs(out):
    return (out.sem_logits, out.penultimate, *out.attentions)


def cotangents(out, seed=1):
    """Seeded weights for each output, so that one scalar reaches all."""
    rs = np.random.RandomState(seed)
    return [rs.randn(*np.shape(t)).astype(np.float32) for t in outputs(out)]


def close(got, ref, rel=1e-4, msg="", scale=None):
    ref = np.asarray(ref, np.float32)
    scale = np.abs(ref).max() if scale is None else scale
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=rel * max(scale, 1e-30), err_msg=msg)


def images(seed=0, n=BATCH):
    return np.random.RandomState(seed).randn(n, CROP, CROP, 3).astype(np.float32)


def both_runs(net, smooth):
    """JAX and port: the eval forward, the train forward with the gradients
    of a scalar of all outputs, and the running statistics after it (one
    JAX compilation for all of it)."""
    params, stats = flax_variables(*net)
    x = images()
    with variant(smooth):
        model = port_model(*net)
        with torch.no_grad():
            got_eval = model.eval()(torch.from_numpy(x))
        w = cotangents(got_eval)
        jm = jax_model(*net)

        def loss(p, x):
            out, upd = jm.apply({"params": p, "batch_stats": stats}, x, train=True,
                                mutable=["batch_stats"])
            return sum(jnp.sum(t.astype(jnp.float32) * c)
                       for t, c in zip(outputs(out), w)), (out, upd["batch_stats"])

        @jax.jit
        def run(p, x):
            ev = jm.apply({"params": p, "batch_stats": stats}, x, train=False)
            return ev, jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(p, x)

        ref_eval, ((_, (ref_train, ref_stats)), (g_p, g_x)) = run(params, x)
        xt = torch.from_numpy(x).requires_grad_(True)
        got_train = model.train()(xt)
        sum(torch.sum(t.float() * torch.from_numpy(c))
            for t, c in zip(outputs(got_train), w)).backward()
    # the detector's heads take no gradient from these outputs (zero in JAX)
    grads = dict(flat(state_dict_to_flax(
        {k: torch.zeros_like(p) if p.grad is None else p.grad
         for k, p in model.named_parameters()})[0]))
    got_stats = dict(flat(state_dict_to_flax(dict(model.named_buffers()))[1]))
    return (dict(eval=ref_eval, train=ref_train, grads=dict(flat(g_p)), dx=np.asarray(g_x),
                 stats=dict(flat(ref_stats)), model=jm),
            dict(eval=got_eval, train=got_train, grads=grads, dx=xt.grad.numpy(),
                 stats=got_stats, model=model))


@pytest.mark.parametrize("net", NETS, ids=NET_IDS)
def test_unet_matches_flax(net):
    """The configured network (ReLU): every output in eval and train mode
    to 1e-4 of its largest value, the running statistics after the train
    forward to 1e-5 of theirs, and the gradients by the norm rule of
    ``chip_smoke.py`` phase [8], ||g - g_jax|| <= 5e-2 ||g_jax|| over all
    parameters (a ReLU kink within rounding moves a channel's gradient
    through its batch norm).  The network without its ReLUs keeps one
    kink, the max-pool's choice where a window's top two lie within
    rounding: every gradient whose path does not pass a pool's backward
    (the decoder, the head, the bottom stage, the detector) to 1e-4 of
    its tensor's largest value, the convolution biases before a batch
    norm (exact gradient 0, both packages' rounding noise) to 1e-4 of
    their kernel's largest gradient; the stages above the bottom and the
    input, whose gradients pass a pool, by the norm rule (measured: one
    flipped window of UNet-4 moves ``down1/conv2``'s kernel gradient by
    5.7 % of its largest value, the stages' norm by under 1 %)."""
    layers, bilinear, det = net
    ref, got = both_runs(net, smooth=False)
    for mode in ("eval", "train"):
        r, g = ref[mode], got[mode]
        assert len(g.attentions) == len(r.attentions) == layers - 2
        for name in ("sem_logits", "logits", "penultimate"):
            assert getattr(g, name).shape == getattr(r, name).shape, name
            close(getattr(g, name).detach(), getattr(r, name), msg=f"{mode} {name}")
        for a, b in zip(g.attentions, r.attentions):
            close(a.detach(), b, msg=f"{mode} attention")
    assert got["eval"].logits.dtype == torch.float32
    assert got["eval"].logits.shape == (BATCH, CROP, CROP, NUM_CLASSES)
    assert got["stats"].keys() == ref["stats"].keys()
    for k, r in ref["stats"].items():
        close(got["stats"][k], r, rel=1e-5, msg=k)
    assert got["grads"].keys() == ref["grads"].keys()
    assert norm_error(got["grads"], ref["grads"]) <= 5e-2
    # the properties the methods read
    jm, model = ref["model"], got["model"]
    assert model.encoder_output_dim == jm.encoder_output_dim
    assert model.penultimate_dim == jm.penultimate_dim == got["eval"].penultimate.shape[-1]
    assert model.out_in_planes == jm.out_in_planes
    assert model.penultimate_stats_keys == jm.penultimate_stats_keys

    ref, got = both_runs(net, smooth=True)
    pooled = ("inc",) + tuple(f"down{i}" for i in range(1, layers - 1))
    assert norm_error(got["grads"], ref["grads"], pooled) <= 5e-2
    assert np.linalg.norm(got["dx"] - ref["dx"]) <= 5e-2 * np.linalg.norm(ref["dx"])
    for k, r in ref["grads"].items():
        stem, leaf = k.rsplit("/", 1)
        if k.startswith(pooled):
            continue
        pre_bn = leaf == "bias" and f"{stem}/kernel" in ref["grads"] and "/conv" in f"/{stem}"
        close(got["grads"][k], r, msg=k,
              scale=np.abs(ref["grads"][f"{stem}/kernel"]).max() if pre_bn else None)
    for k, r in ref["stats"].items():
        close(got["stats"][k], r, rel=1e-5, msg=k)


def norm_error(got, ref, prefixes=("",)):
    """||got - ref|| / ||ref|| over the tensors whose names start with one
    of ``prefixes``."""
    keys = [k for k in ref if k.startswith(tuple(f"{p}/" if p else p for p in prefixes))]
    diff = sum(float(np.sum((got[k] - ref[k]) ** 2)) for k in keys)
    return (diff / sum(float(np.sum(ref[k] ** 2)) for k in keys)) ** 0.5


def test_flax_state_dict_round_trip_with_transpose_convolutions():
    """``up_tconv`` kernels become torch's [in, out, kh, kw] flipped in
    both spatial axes, and come back unchanged."""
    params, stats = flax_variables(3, False, True)
    sd = flax_to_state_dict(params, stats)
    k = np.asarray(params["up_tconv1"]["kernel"])
    assert k.shape == (2, 2, 256, 128)
    np.testing.assert_array_equal(sd["up_tconv1.weight"].numpy(),
                                  k[::-1, ::-1].transpose(2, 3, 0, 1))
    assert sd["up1.conv1.weight"].shape == (128, 256, 3, 3)
    assert sd["up1.bn2.running_var"].shape == (128,)
    p2, s2 = state_dict_to_flax(sd)
    for a, b in ((params, p2), (stats, s2)):
        fa, fb = dict(flat(a)), dict(flat(b))
        assert fa.keys() == fb.keys()
        for key in fa:
            np.testing.assert_array_equal(fb[key], fa[key], err_msg=key)


@pytest.mark.parametrize("bilinear", [True, False], ids=["bilinear", "tconv"])
def test_init_weights_draws_flax_defaults(bilinear):
    """JAX's initial weights for a seed (``utils/flax_init.py``): every
    UNet convolution, transpose convolution and the classifier LeCun
    normal truncated at two deviations over the fan-in kh kw in, biases 0
    (Flax's defaults; the JAX UNet sets no initialiser)."""
    model = create_network("unet", 21, n_tasks=3, use_bg_detector=True, num_layers=4,
                           bilinear=bilinear)
    init_weights(model, 3)
    n_conv = 0
    for name, m in model.named_modules():
        if not isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            continue
        n_conv += 1
        w = m.weight.detach().float()
        if isinstance(m, ConvTranspose2d):
            fan_in = w.shape[0] * w.shape[2] * w.shape[3]
        else:
            fan_in = w.shape[1] * w.shape[2] * w.shape[3]
        std = fan_in ** -0.5
        assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 * (1 + 1e-6), name
        if w.numel() >= 2000:  # the sample's std within 10 %
            assert abs(float(w.std()) / std - 1) < 0.1, (name, float(w.std()), std)
        if m.bias is not None:
            assert not m.bias.any(), name
    assert n_conv == 2 * (1 + 3 + 3) + (0 if bilinear else 3) + 1 + 1
    assert isinstance(model, UNet)


@pytest.mark.parametrize("bilinear", [True, False], ids=["bilinear", "tconv"])
def test_predictor_on_unet_matches_jax(bilinear):
    """The Predictor with a UNet config (``n_channels``, ``bilinear``,
    ``num_layers`` passed through, as ``bacs_tpu/serve.py`` does), f32 on
    the CPU: masks equal on at least 99.9 % of the pixels (a top-2 tie
    within rounding may flip), the f16 confidence within 2e-3, as
    ``tests/test_torch_serve.py`` holds DeepLabV3's."""
    params, stats = flax_variables(3, bilinear, False)
    cfg = {"_target_": "networks.UNet", "n_channels": 3, "bilinear": bilinear,
           "num_layers": 3}
    imgs = np.random.RandomState(4).randint(0, 256, (2, CROP, CROP, 3)).astype(np.uint8)
    ref_p, ref_c = JaxPredictor(cfg, NUM_CLASSES, params, stats, crop_size=CROP,
                                dtype=jnp.float32).predict(imgs)
    got_p, got_c = Predictor(cfg, NUM_CLASSES, params, stats, crop_size=CROP,
                             dtype=torch.float32, device="cpu").predict(imgs)
    assert got_p.dtype == np.uint8 and got_p.shape == (2, CROP, CROP)
    assert (got_p == np.asarray(ref_p)).mean() >= 0.999
    np.testing.assert_allclose(got_c.astype(np.float32), np.asarray(ref_c, np.float32),
                               atol=2e-3)


def test_init_weights_keeps_deeplab_he_and_flax_defaults_elsewhere():
    """JAX's initial weights for a seed (``utils/flax_init.py``, held bit
    for bit in ``tests/test_torch_seed_init.py``), DeepLabV3: the
    backbone's and ASPP's convolutions He normal over the fan-out
    (``bacs_tpu/models/resnet.py:59``); the classifier and the
    detector's trunk convolution Flax's default, LeCun normal truncated
    over the fan-in (``bacs_tpu/models/bg_detector.py:44-51`` sets no
    initialiser); the detector's heads LeCun over D x T, truncated."""
    model = create_network("deeplab", 21, n_tasks=3, use_bg_detector=True,
                           backbone="resnet18")
    init_weights(model, 5)
    trunc = 0.87962566103423978
    cases = {"backbone.mod5_block1.conv2": "he", "base_classifier.map_conv1": "he",
             "classifier_head": "lecun", "seen_fg_network.base_conv": "lecun"}
    modules = dict(model.named_modules())
    for name, kind in cases.items():
        w = modules[name].weight.detach().float()
        out_c, in_c, kh, kw = w.shape
        if kind == "he":
            std = (2.0 / (out_c * kh * kw)) ** 0.5
        else:
            std = (in_c * kh * kw) ** -0.5
            assert float(w.abs().max()) <= 2 * std / trunc * (1 + 1e-6), name
        assert abs(float(w.std()) / std - 1) < 0.1, (name, float(w.std()), std)
    head = model.seen_fg_network.head_kernel.detach()
    std = (head.shape[0] * head.shape[1]) ** -0.5
    assert float(head.abs().max()) <= 2 * std / trunc * (1 + 1e-6)
