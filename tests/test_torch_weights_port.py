"""The port's weight loaders (``bacs_tpu_torch/utils/torch_weights.py``)
against the JAX package's (``bacs_tpu/utils/torch_weights.py``), on the CPU.

- A release-layout backbone file (every key of the PLOP release,
  ``mod1.conv1``, ``modK.blockJ.convs.convI``/``bnI``, ``proj_*``, with ABN
  weights of both signs), for a ResNet-18 (basic blocks) and a ResNet-101
  (bottlenecks), loaded by both packages: equal counts, every backbone
  leaf equal to JAX's, and the eval forwards of DeepLabV3 on them within
  1e-5 of the largest logit (the rest of the network is JAX's initial
  weights on both sides: the port's own initial weights come from another
  generator).
- Whole reference state dicts, their keys generated from what the JAX
  converters read (DeepLabV3 with a per-task classifier and the detector,
  ``utils/torch_weights.py:reference_deeplab_shapes``; TranSeg; UNet with
  transpose convolutions): JAX's and the port's converters give equal
  trees and counts, every Flax leaf is filled, and the forwards agree.
- ``export_backbone_release`` writes JAX's file and round-trips; an atrous
  backbone raises.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from bacs_tpu.models import create_network as jax_create_network
from bacs_tpu.utils import torch_weights as jax_tw
from bacs_tpu_torch.models import create_network
from bacs_tpu_torch.utils import torch_weights as tw
from bacs_tpu_torch.utils.flax_weights import load_flax_variables
from torch_port_helpers import _one_thread  # noqa: F401

NUM_CLASSES = 6
HEADS = (4, 1, 1)  # classes per task: the padded head's 6
CROP = 32
TR = dict(hidden_dim=32, dim_feedforward=64, nheads=2, num_layers=2)


NETS = {
    "rn18": ("deeplab", dict(backbone="resnet18")),
    "rn101": ("deeplab", dict(backbone="resnet101")),
    "deeplab_det": ("deeplab", dict(backbone="resnet18", n_tasks=3, use_bg_detector=True)),
    "transeg": ("transeg", dict(backbone="resnet18", crop_size=CROP, transformer=TR)),
    "unet": ("unet", dict(num_layers=3, bilinear=False)),
}


@functools.lru_cache(maxsize=None)
def jax_net(net):
    name, kw = NETS[net]
    m = jax_create_network(name, NUM_CLASSES, axis_name=None, **kw)
    v = jax.jit(lambda k, x: m.init(k, x, train=False))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        np.zeros((1, CROP, CROP, 3), np.float32))
    return m, jax.tree.map(np.asarray, v["params"]), jax.tree.map(
        np.asarray, v.get("batch_stats", {}))


def port_net(net, params, stats):
    name, kw = NETS[net]
    model = create_network(name, NUM_CLASSES, **kw)
    load_flax_variables(model, params, stats)
    return model.eval()


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float32)


def assert_trees_equal(got, ref):
    g, r = dict(leaves(got)), dict(leaves(ref))
    assert sorted(g) == sorted(r)
    for k in r:
        assert np.array_equal(g[k], r[k]), k


def forwards_agree(net, model, params, stats, rel):
    """The eval forward's logits, port against JAX, to ``rel`` of the
    largest."""
    m = jax_net(net)[0]
    x = np.random.RandomState(5).randn(2, CROP, CROP, 3).astype(np.float32)
    ref = jax.jit(lambda v, x: m.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for a, b in ((got.sem_logits, ref.sem_logits), (got.penultimate, ref.penultimate)):
        a, b = a.numpy(), np.asarray(b)
        active = a > -1e8  # TranSeg's inactive channels
        scale = np.abs(b[active]).max()
        assert np.isfinite(scale) and scale > 0
        assert np.abs(a[active] - b[active]).max() <= rel * scale


def release_file(net, path, seed=3):
    """A release-layout backbone file for ``net``'s backbone: the JAX initial
    kernels scaled per tensor, ABN vectors redrawn (weights of both
    signs)."""
    _, params, stats = jax_net(net)
    rs = np.random.RandomState(seed)
    sd = {}
    for k, shape in tw.release_backbone_shapes(params["backbone"]).items():
        if k.endswith("running_var"):
            v = rs.uniform(0.5, 2.0, shape)
        elif len(shape) == 4:
            v = rs.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif k.endswith("weight"):
            v = rs.uniform(0.5, 1.5, shape) * rs.choice([-1.0, 1.0], shape)
        else:
            v = rs.uniform(-0.3, 0.3, shape)
        sd[f"module.{k}"] = torch.from_numpy(v.astype(np.float32))
    sd["module.classifier.fc.weight"] = torch.zeros(1000, 8)
    sd["module.classifier.fc.bias"] = torch.zeros(1000)
    torch.save({"state_dict": sd}, path)
    return len(sd) - 2


@pytest.mark.parametrize("net", ["rn18", "rn101"])
def test_release_backbone_loads_as_jax(net, tmp_path):
    path = str(tmp_path / "resnet_iabn_sync.pth.tar")
    n_file = release_file(net, path)
    _, params, stats = jax_net(net)
    r_params, r_stats, r_n = jax_tw.load_pretrained_backbone(
        path, {"params": params, "batch_stats": stats})
    model = port_net(net, params, stats)
    n = tw.load_backbone_into(model, path)
    assert n == r_n == n_file
    got = tw.model_variables(model)
    assert_trees_equal(got["params"], jax.tree.map(np.asarray, r_params))
    assert_trees_equal(got["batch_stats"], jax.tree.map(np.asarray, r_stats))
    # every backbone tensor came from the file; ABN scales as magnitudes
    sd = tw.load_torch_state_dict(path)
    assert np.array_equal(got["params"]["backbone"]["bn1"]["scale"],
                          np.abs(sd["mod1.bn1.weight"]))
    assert (sd["mod1.bn1.weight"] < 0).any()
    forwards_agree(net, model, r_params, r_stats, 1e-5)


def transeg_shapes(params):
    """{key: shape} of a reference TranSeg: the release backbone under
    ``backbone.`` and the TransformerHead's keys the JAX converter reads."""
    hd = params["base_classifier"]
    d = hd["proj_patch"].shape[0]
    _, h, w, _ = hd["pos_embed"].shape
    c = hd["class_tokens"].shape[0]
    cin = hd["feature_embedding"]["kernel"].shape[2]
    out = {f"backbone.{k}": s for k, s in tw.release_backbone_shapes(params["backbone"]).items()}
    out.update({
        "base_classifier.feature_embedding.weight": (d, cin, 1, 1),
        "base_classifier.feature_embedding.bias": (d,),
        "base_classifier.pos_embed": (1, d, h, w),
        "base_classifier.class_tokens": (1, c, d),
        "base_classifier.mask_norm.weight": (c,), "base_classifier.mask_norm.bias": (c,),
        "base_classifier.proj_patch": (d, d), "base_classifier.proj_classes": (d, d),
        "base_classifier.decoder_norm.weight": (d,), "base_classifier.decoder_norm.bias": (d,),
        # the inherited classifier, which the reference forward never calls
        "classifier_head.weight": (c, d, 1, 1)})
    for i in range(sum(k.startswith("block") for k in hd)):
        blk = hd[f"block{i}"]
        f = blk["mlp_fc1"]["kernel"].shape[1]
        for sub, shape in (("norm1", (d,)), ("norm2", (d,))):
            out[f"base_classifier.blocks.{i}.{sub}.weight"] = shape
            out[f"base_classifier.blocks.{i}.{sub}.bias"] = shape
        for sub, (o, n) in (("attn.qkv", (3 * d, d)), ("attn.proj", (d, d)),
                            ("mlp.fc1", (f, d)), ("mlp.fc2", (d, f))):
            out[f"base_classifier.blocks.{i}.{sub}.weight"] = (o, n)
            out[f"base_classifier.blocks.{i}.{sub}.bias"] = (o,)
    return out


def unet_shapes(params):
    """{key: shape} of a reference UNet with transpose convolutions."""
    out = {}

    def double(prefix, node):
        for j, (conv, bn) in enumerate((("conv1", "bn1"), ("conv2", "bn2"))):
            kh, kw, cin, cout = node[conv]["kernel"].shape
            out[f"{prefix}.{3 * j}.weight"] = (cout, cin, kh, kw)
            out[f"{prefix}.{3 * j}.bias"] = (cout,)
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                out[f"{prefix}.{3 * j + 1}.{leaf}"] = (cout,)
            out[f"{prefix}.{3 * j + 1}.num_batches_tracked"] = ()

    double("inc.double_conv", params["inc"])
    for name, node in params.items():
        if name.startswith("down"):
            double(f"downsample.{int(name[4:]) - 1}.maxpool_conv.1.double_conv", node)
        elif name.startswith("up_tconv"):
            kh, kw, cin, cout = node["kernel"].shape
            out[f"upsample.{int(name[8:]) - 1}.up.weight"] = (cin, cout, kh, kw)
            out[f"upsample.{int(name[8:]) - 1}.up.bias"] = (cout,)
        elif name.startswith("up"):
            double(f"upsample.{int(name[2:]) - 1}.conv.double_conv", node)
    kh, kw, cin, cout = params["classifier_head"]["kernel"].shape
    out["classifier_head.weight"] = (cout, cin, kh, kw)
    out["classifier_head.bias"] = (cout,)
    return out


def reference_sd(net):
    _, params, stats = jax_net(net)
    if net == "deeplab_det":
        shapes = tw.reference_deeplab_shapes({"params": params, "batch_stats": stats}, HEADS)
        assert any("_bn.bn." in k for k in shapes)  # BNReLUAct's level
    elif net == "transeg":
        shapes = transeg_shapes(params)
    else:
        shapes = unet_shapes(params)
    sd = {k: v.numpy() for k, v in tw.seeded_state_dict(shapes, seed=11).items()}
    if net == "unet":  # the reference's BatchNorm2d counts its batches
        sd.update({k: np.zeros((), np.int64) for k in shapes if k.endswith("tracked")})
    return sd


@pytest.mark.parametrize("net", ["deeplab_det", "transeg", "unet"])
def test_reference_converters_match_jax(net):
    sd = reference_sd(net)
    _, params, stats = jax_net(net)
    variables = {"params": params, "batch_stats": stats}
    ref_fn = {"deeplab_det": jax_tw.convert_reference_deeplab,
              "transeg": jax_tw.convert_reference_transeg,
              "unet": jax_tw.convert_reference_unet}[net]
    r_params, r_stats, r_n = ref_fn(dict(sd), variables)
    model = port_net(net, params, stats)
    target = {"deeplab_det": "networks.DeepLabV3", "transeg": "networks.TranSeg",
              "unet": "networks.UNet"}[net]
    g_params, g_stats, n = tw.convert_reference(dict(sd), tw.model_variables(model), target)
    assert n == r_n > 0
    r_params, r_stats = jax.tree.map(np.asarray, (r_params, r_stats))
    assert_trees_equal(g_params, r_params)
    assert_trees_equal(g_stats, r_stats)
    # every Flax leaf was filled from the dict
    for tree, init in ((r_params, params), (r_stats, stats)):
        before = dict(leaves(init))
        for k, v in leaves(tree):
            assert not np.array_equal(v, before[k]), f"{k} kept its initial value"
    load_flax_variables(model, g_params, g_stats)
    forwards_agree(net, model, r_params, r_stats, 1e-4)
    # a torch tensor lands in the port's network in torch's own layout
    own = model.state_dict()
    if net == "unet":
        assert np.array_equal(own["up_tconv1.weight"].numpy(), sd["upsample.0.up.weight"])
        assert np.array_equal(own["up1.bn1.weight"].numpy(),
                              sd["upsample.0.conv.double_conv.1.weight"])
    else:
        assert np.array_equal(own["backbone.conv1.weight"].numpy(),
                              sd["backbone.mod1.conv1.weight"])
    if net == "deeplab_det":
        w = np.concatenate([sd[f"classifier_head.{t}.weight"] for t in range(3)])
        assert np.array_equal(own["classifier_head.weight"].numpy(), w)
        assert np.array_equal(own["base_classifier.map_bn.weight"].numpy(),
                              np.abs(sd["base_classifier.map_bn.bn.weight"]))
        # the detector's BatchNorm2d keeps its sign
        assert np.array_equal(own["seen_fg_network.base_bn.weight"].numpy(),
                              sd["seen_fg_network.base_layers.1.weight"])


def test_export_backbone_release_round_trips(tmp_path):
    _, params, stats = jax_net("rn18")
    rs = np.random.RandomState(2)
    params = jax.tree.map(lambda a: a * rs.uniform(0.5, 1.5, a.shape).astype(np.float32),
                          params)
    variables = {"params": params, "batch_stats": stats}
    got_path, ref_path = str(tmp_path / "port.pth.tar"), str(tmp_path / "jax.pth.tar")
    n = tw.export_backbone_release(variables, got_path)
    assert n == jax_tw.export_backbone_release(variables, ref_path)
    got = torch.load(got_path, weights_only=False)["state_dict"]
    ref = torch.load(ref_path, weights_only=False)["state_dict"]
    assert list(got) == list(ref) and all(torch.equal(got[k], ref[k]) for k in ref)
    assert "module.mod2.block1.convs.conv1.weight" in got
    back, back_stats, m = tw.load_pretrained_backbone(got_path, variables)
    assert m == n
    assert_trees_equal(back["backbone"], params["backbone"])
    assert_trees_equal(back_stats["backbone"], stats["backbone"])


def test_atrous_backbone_raises():
    """An atrous-layout state dict no longer raises: it takes the atrous
    converter (held to JAX's on a whole network by
    ``tests/test_torch_atrous.py``); here one tensor onto an ABN network's
    tree, where JAX's converter too finds no atrous target."""
    _, params, stats = jax_net("rn18")
    sd = {"backbone.layer1.0.conv1.weight": np.zeros((64, 64, 3, 3), np.float32)}
    got = tw.convert_reference_deeplab(sd, {"params": params, "batch_stats": stats})
    ref = jax_tw.convert_reference_deeplab(sd, {"params": params, "batch_stats": stats})
    assert got[2] == ref[2] == 0
