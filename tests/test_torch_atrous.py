"""The non-fused norms and the SDR atrous encoder against Flax, on the CPU.

- ``bn`` (ReLU, momentum 3e-4), ``abn`` with ``fused=False`` (leaky 0.01),
  ``abr`` (batch renorm, r and d clipped and stopped) and ``bn`` with the
  stem's max-pool, in train mode against the Flax ``ABN`` of the same
  ``make_norm``: outputs, input and parameter gradients of a seeded
  weighted sum, and the running statistics, within 1e-5.  (Their
  synchronized forms on two ranks: ``tests/test_torch_ddp.py``.)
- The atrous DeepLabV3 (ResNet-50 atrous, the synchronized ``bn`` on the
  whole model) at output stride 16 and 8, from the same Flax variables
  (ABN vectors redrawn), in two set-ups:
  - as configured (ReLU), 64^2, batch 4: in train mode the six attention
    maps (five of the encoder, the head's) and the logits, and the
    running statistics; in eval mode the logits; every value tensor held
    to VALUE_TOL of its largest value.  Its gradients only by a norm
    rule, ||port - JAX|| / ||JAX|| over all parameters and the input
    <= GRAD_NORM_TOL: the ReLUs make this random network's gradients
    ill-conditioned (moving the port's own weights by 1e-6, relative and
    seeded, moves its gradients by 5.4 % by that rule and by up to 37 %
    of a tensor's largest value at os16).  The weights round trip through
    ``utils/flax_weights.py``.
  - smooth, 32^2, batch 8: every norm an identity-activation non-fused
    ``bn`` and no ReLU after the residual add, on both sides, so the only
    kink left is the stem's max-pool.  Every parameter gradient and the
    input's to GRAD_TOL of its tensor's largest value, a norm's scale and
    bias to GRAD_TOL of the larger of the two (with identity activations
    a norm's bias that feeds a convolution and then a batch norm has an
    exact gradient of 0, which both packages round to noise); the logits
    and the running statistics to GRAD_TOL of their largest value.
    Measured: at most 9.7e-6 (os16) and 7.4e-6 (os8) from JAX, while a
    1e-6 move of the port's weights moves them by up to 3.2e-5.  (At
    64^2, batch 4 the head's global-pooling norm normalizes over 4 rows
    and the same move reaches 5.5e-5.)
- The atrous reference converter against JAX's on a reference-layout state
  dict (``backbone.layer{s}.{b}``, ``downsample.0/1``, signed BatchNorm
  scales): the same trees and count.
- ``network.fused_abn=false`` through ``create_network``: DeepLabV3-RN18's
  every ABN takes the non-fused branch, held to Flax's ``fused_abn=False``
  network in train mode.
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

import bacs_tpu.models as jax_models
import bacs_tpu.models.resnet_atrous as jax_resnet_atrous
import bacs_tpu_torch.models as models_mod
from bacs_tpu.models import create_network as jax_create_network
from bacs_tpu.models.norm import make_norm as jax_make_norm
from bacs_tpu.utils import torch_weights as jax_tw
from bacs_tpu_torch.models import create_network
from bacs_tpu_torch.models.norm import make_norm
from bacs_tpu_torch.models.resnet_atrous import AtrousBottleneck, ResNetAtrous
from bacs_tpu_torch.utils import torch_weights as tw
from bacs_tpu_torch.utils.flax_weights import load_flax_variables, state_dict_to_flax
from torch_port_helpers import _one_thread, randomize_abn  # noqa: F401

# case -> (norm, make_norm options, the layer's options)
NORMS = {"bn": ("bn", {}, {}), "abn_plain": ("abn", {"fused": False}, {}),
         "abr": ("abr", {}, {}), "bn_pool": ("bn", {}, {"pool": True})}
CROP, BATCH, N_CLASSES = 64, 4, 5
SMOOTH_CROP, SMOOTH_BATCH = 32, 8
VALUE_TOL, GRAD_NORM_TOL, GRAD_TOL = 1e-3, 0.1, 1e-4


def flat(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float32)


def close(got, ref, rel, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=rel * float(np.abs(ref).max()), err_msg=what)


# ---------------------------------------------------------------- one layer


@pytest.mark.parametrize("kind", list(NORMS))
def test_non_fused_norm_train_mode_matches_flax(kind):
    norm, kw, layer = NORMS[kind]
    rs = np.random.RandomState(len(kind))
    c = 8
    x = (rs.randn(3, 6, 4, c) * 2 + 0.5).astype(np.float32)
    v = dict(scale=rs.uniform(0.5, 1.5, c), bias=rs.uniform(-0.3, 0.3, c),
             mean=rs.uniform(-0.3, 0.3, c), var=rs.uniform(0.5, 2.0, c))
    v = {k: a.astype(np.float32) for k, a in v.items()}
    jm = jax_make_norm(norm, **kw)(c, **layer)
    y_shape = jax.eval_shape(lambda: jm.apply(
        {"params": {"scale": v["scale"], "bias": v["bias"]},
         "batch_stats": {"mean": v["mean"], "var": v["var"]}}, x,
        mutable=["batch_stats"])[0]).shape
    w = rs.randn(*y_shape).astype(np.float32)

    def loss(params, x):
        y, mut = jm.apply({"params": params,
                           "batch_stats": {"mean": v["mean"], "var": v["var"]}},
                          x, use_running_average=False, mutable=["batch_stats"])
        return jnp.sum(y * w), (y, mut["batch_stats"])

    (_, (ref_y, ref_bs)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        {"scale": v["scale"], "bias": v["bias"]}, x)

    m = make_norm(norm, **kw)(c, **layer).train()
    assert not m.fusable
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(v["scale"]))
        m.bias.copy_(torch.from_numpy(v["bias"]))
        m.running_mean.copy_(torch.from_numpy(v["mean"]))
        m.running_var.copy_(torch.from_numpy(v["var"]))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y = m(xt).permute(0, 2, 3, 1)
    (y * torch.from_numpy(w)).sum().backward()
    for got, ref, what in (
            (y.detach(), ref_y, "y"), (xt.grad.permute(0, 2, 3, 1), gx, "dx"),
            (m.weight.grad, gp["scale"], "dscale"), (m.bias.grad, gp["bias"], "dbias"),
            (m.running_mean, ref_bs["mean"], "mean"), (m.running_var, ref_bs["var"], "var")):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5,
                                   err_msg=what)


# ---------------------------------------------------------------- the encoder


def jax_atrous(output_stride):
    return jax_create_network("deeplab", num_classes=N_CLASSES, axis_name=None,
                              atrous_encoder=True, backbone="resnet50", crop_size=CROP,
                              output_stride=output_stride)


class SmoothAtrousBottleneck(jax_resnet_atrous.AtrousBottleneck):
    """The Flax block without its ReLU after the add."""

    @nn.compact
    def __call__(self, x):
        train, p, conv = self.is_training, self.planes, jax_resnet_atrous.conv
        out_ch = p * 4
        y = conv(p, 1, dtype=self.dtype, name="conv1")(x)
        y = self.norm(p, name="bn1")(y, use_running_average=not train)
        y = conv(p, 3, self.stride, self.atrous, dtype=self.dtype, name="conv2")(y)
        y = self.norm(p, name="bn2")(y, use_running_average=not train)
        y = conv(out_ch, 1, dtype=self.dtype, name="conv3")(y)
        y = self.norm(out_ch, activation="identity", name="bn3")(
            y, use_running_average=not train)
        if self.stride != 1 or x.shape[-1] != out_ch:
            x = conv(out_ch, 1, self.stride, dtype=self.dtype, name="downsample_conv")(x)
            x = self.norm(out_ch, activation="identity", name="downsample_bn")(
                x, use_running_average=not train)
        return y + x


def smooth_forward(self, x):
    """The port's block without its ReLU after the add."""
    y = self.bn3(self.conv3(self.bn2(self.conv2(self.bn1(self.conv1(x))))))
    return y + (self.downsample_bn(self.downsample_conv(x)) if self.needs_proj else x)


@contextlib.contextmanager
def variant(smooth):
    """Both packages' atrous networks as configured, or ``smooth``: every
    norm an identity-activation non-fused one, no ReLU after the add."""
    with contextlib.ExitStack() as stack:
        if smooth:
            for mod in (jax_models, models_mod):
                stack.enter_context(mock.patch.object(
                    mod, "make_norm",
                    lambda *a, _make=mod.make_norm, **k: functools.partial(
                        _make(*a, **k), activation="identity", fused=False)))
            stack.enter_context(mock.patch.object(
                jax_resnet_atrous, "AtrousBottleneck", SmoothAtrousBottleneck))
            stack.enter_context(mock.patch.object(AtrousBottleneck, "forward", smooth_forward))
        yield


@functools.lru_cache(maxsize=None)
def atrous_variables():
    """Randomised Flax variables; the tree does not depend on the stride."""
    m = jax_atrous(16)
    v = jax.jit(lambda k, x: m.init(k, x, train=False))(
        jax.random.PRNGKey(0), np.zeros((1, CROP, CROP, 3), np.float32))
    rs = np.random.RandomState(13)
    return randomize_abn(v["params"], rs), randomize_abn(v["batch_stats"], rs)


def images(crop=CROP, batch=BATCH):
    return np.random.RandomState(4).randn(batch, crop, crop, 3).astype(np.float32)


def shape_of(smooth):
    return (SMOOTH_CROP, SMOOTH_BATCH) if smooth else (CROP, BATCH)


@functools.lru_cache(maxsize=None)
def jax_encoder_run(output_stride, smooth=False):
    params, stats = atrous_variables()
    crop, batch = shape_of(smooth)
    x = images(crop, batch)
    w = np.random.RandomState(5).randn(batch, crop // output_stride, crop // output_stride,
                                       N_CLASSES).astype(np.float32)
    with variant(smooth):
        m = jax_atrous(output_stride)

        @jax.jit
        def run(params, x):
            def loss(params, x):
                out, mut = m.apply({"params": params, "batch_stats": stats}, x, train=True,
                                   mutable=["batch_stats"])
                return jnp.sum(out.sem_logits * w), (out, mut["batch_stats"])

            (_, (out, bs)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                                          has_aux=True)(params, x)
            ev = m.apply({"params": params, "batch_stats": stats}, x, train=False)
            return out.sem_logits, out.attentions, bs, gp, gx, ev.sem_logits

        sem, atts, bs, gp, gx, ev = run(params, x)
    return dict(sem=np.asarray(sem), atts=[np.asarray(a) for a in atts],
                stats=dict(flat(bs)), grads=dict(flat(gp)), dx=np.asarray(gx),
                eval=np.asarray(ev), w=w)


def port_encoder_run(output_stride, smooth=False):
    """The port's train forward and backward on JAX's inputs; returns
    (network, output, parameter gradients by Flax path, input gradient)."""
    ref = jax_encoder_run(output_stride, smooth)
    params, stats = atrous_variables()
    with variant(smooth):
        net = create_network("deeplab", N_CLASSES, atrous_encoder=True, backbone="resnet50",
                             output_stride=output_stride)
        assert isinstance(net.backbone, ResNetAtrous)
        load_flax_variables(net, params, stats)
        x = torch.from_numpy(images(*shape_of(smooth))).requires_grad_()
        out = net.train()(x)
        (out.sem_logits * torch.from_numpy(ref["w"])).sum().backward()
    grads = dict(flat(state_dict_to_flax(
        {k: p.grad for k, p in net.named_parameters()})[0]))
    assert grads.keys() == ref["grads"].keys()
    return net, out, grads, x.grad.numpy()


def port_stats(net):
    # copies: state_dict_to_flax's arrays share the tensors' memory
    return {k: v.copy() for k, v in flat(state_dict_to_flax(net.state_dict())[1])}


@pytest.mark.parametrize("output_stride", [16, 8])
def test_atrous_encoder_matches_flax(output_stride):
    ref = jax_encoder_run(output_stride)
    params, stats = atrous_variables()
    net, out, grads, dx = port_encoder_run(output_stride)
    assert len(out.attentions) == len(ref["atts"]) == 6
    values = {f"attention {i}": (a.detach(), r)
              for i, (a, r) in enumerate(zip(out.attentions, ref["atts"]))}
    values["sem_logits"] = (out.sem_logits.detach(), ref["sem"])
    gradients = {k: (grads[k], r) for k, r in ref["grads"].items()}
    gradients["dx"] = (dx, ref["dx"])
    got_stats = port_stats(net)
    assert got_stats.keys() == ref["stats"].keys()
    values.update({k: (got_stats[k], r) for k, r in ref["stats"].items()})
    with torch.no_grad():
        load_flax_variables(net, params, stats)
        values["eval"] = (net.eval().sem_logits(torch.from_numpy(images())), ref["eval"])
    errs = {k: float(np.abs(np.asarray(g) - r).max() / np.abs(r).max())
            for k, (g, r) in values.items()}
    worst = max(errs, key=errs.get)
    num = sum(float(np.sum((np.asarray(g) - r) ** 2)) for g, r in gradients.values())
    den = sum(float(np.sum(r ** 2)) for _, r in gradients.values())
    print(f"os{output_stride}: worst value {worst} {errs[worst]:.2e} of its largest; "
          f"gradients {(num / den) ** 0.5:.2e} by the norm rule")
    assert errs[worst] <= VALUE_TOL, (worst, errs[worst])
    assert (num / den) ** 0.5 <= GRAD_NORM_TOL
    # the weights round trip
    back_p, back_s = state_dict_to_flax(net.state_dict())
    for tree, want in ((back_p, params), (back_s, stats)):
        b, w_ = dict(flat(tree)), dict(flat(want))
        assert b.keys() == w_.keys() and all(np.array_equal(b[k], w_[k]) for k in w_)


@pytest.mark.parametrize("output_stride", [16, 8])
def test_atrous_encoder_gradients_match_flax(output_stride):
    """The smooth set-up: every gradient per tensor (see the module's
    docstring), the logits and the running statistics."""
    ref = jax_encoder_run(output_stride, smooth=True)
    net, out, grads, dx = port_encoder_run(output_stride, smooth=True)
    grads["dx"], want = dx, dict(ref["grads"], dx=ref["dx"])
    errs = {}
    for k, r in want.items():
        stem, leaf = k.rsplit("/", 1) if "/" in k else (k, "")
        scale = float(np.abs(r).max())
        if leaf in ("scale", "bias") and f"{stem}/scale" in want:
            scale = max(float(np.abs(want[f"{stem}/{v}"]).max()) for v in ("scale", "bias"))
        errs[k] = float(np.abs(grads[k] - r).max()) / scale
    got_stats = port_stats(net)
    for k, r in list(ref["stats"].items()) + [("sem_logits", ref["sem"])]:
        g = out.sem_logits.detach().numpy() if k == "sem_logits" else got_stats[k]
        errs[k] = float(np.abs(g - r).max() / np.abs(r).max())
    worst = max(errs, key=errs.get)
    print(f"os{output_stride} smooth: worst {worst} {errs[worst]:.2e}")
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])


def reference_atrous_state_dict(params, stats, rs):
    """A reference-layout (``networks/resnet_atrous.py``, ``deeplab_v3.py``)
    state dict of the atrous DeepLabV3's tree, seeded values, norm scales
    of both signs."""
    sd = {}
    for path, v in list(flat(params)) + [(p, v) for p, v in flat(stats)]:
        mod, leaf = path.rsplit("/", 1)
        parts = mod.split("/")
        name = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean",
                "var": "running_var"}[leaf]
        if parts[0] == "backbone" and parts[1].startswith("layer"):
            s, b = parts[1].split("_block")
            layer = parts[2]
            if layer == "downsample_conv":
                key = f"backbone.{s}.{int(b) - 1}.downsample.0.{name}"
            elif layer == "downsample_bn":
                key = f"backbone.{s}.{int(b) - 1}.downsample.1.{name}"
            else:
                key = f"backbone.{s}.{int(b) - 1}.{layer}.{name}"
        elif parts[0] == "base_classifier" and parts[1].startswith("map_conv"):
            key = f"base_classifier.map_convs.{parts[1][len('map_conv'):]}.{name}"
        else:
            key = ".".join(parts + [name])
        a = rs.randn(*v.shape).astype(np.float32) * 0.1
        if leaf == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a
        if leaf == "var":
            a = np.abs(a) + 0.5
        sd[key] = a
    return sd


def test_atrous_reference_converter_matches_jax():
    params, stats = atrous_variables()
    sd = reference_atrous_state_dict(params, stats, np.random.RandomState(17))
    assert any(k.startswith("backbone.layer1.0.downsample.1.") for k in sd)
    variables = {"params": params, "batch_stats": stats}
    got_p, got_s, n = tw.convert_reference_deeplab(sd, variables)
    ref_p, ref_s, n_ref = jax_tw.convert_reference_deeplab(sd, variables)
    assert n == n_ref == len(sd)
    for got, ref in ((got_p, ref_p), (got_s, ref_s)):
        g, r = dict(flat(got)), dict(flat(ref))
        assert g.keys() == r.keys()
        for k in r:
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
    # signed scales, not the ABN's magnitudes
    scale = sd["backbone.layer1.0.bn1.weight"]
    assert (scale < 0).any()
    np.testing.assert_array_equal(dict(flat(got_p))["backbone/layer1_block1/bn1/scale"], scale)
    net = create_network("deeplab", N_CLASSES, atrous_encoder=True, backbone="resnet50")
    load_flax_variables(net, got_p, got_s)


def test_fused_abn_false_through_create_network():
    """DeepLabV3-RN18 with ``fused_abn=False``: every ABN non-fused, train
    mode against Flax's ``fused_abn=False`` network (logits and running
    statistics within 1e-4 of their largest value)."""
    jm = jax_create_network("deeplab", num_classes=N_CLASSES, axis_name=None,
                            backbone="resnet18", fused_abn=False)
    x = images()[:, :32, :32]
    v = jax.jit(lambda k, x: jm.init(k, x, train=False))(jax.random.PRNGKey(1), x[:1])
    rs = np.random.RandomState(3)
    params, stats = randomize_abn(v["params"], rs), randomize_abn(v["batch_stats"], rs)
    out, mut = jax.jit(lambda p, s, x: jm.apply({"params": p, "batch_stats": s}, x,
                                                train=True, mutable=["batch_stats"]))(
        params, stats, x)
    net = create_network("deeplab", N_CLASSES, backbone="resnet18", fused_abn=False)
    abns = [m for m in net.modules() if hasattr(m, "fusable")]
    assert abns and not any(m.fusable for m in abns)
    load_flax_variables(net, params, stats)
    with torch.no_grad():
        got = net.train()(torch.from_numpy(x))
    close(got.sem_logits, out.sem_logits, VALUE_TOL, "sem_logits")
    ref_s = dict(flat(mut["batch_stats"]))
    got_s = dict(flat(state_dict_to_flax(net.state_dict())[1]))
    for k, r in ref_s.items():
        close(got_s[k], r, VALUE_TOL, k)
