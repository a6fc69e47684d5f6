"""Reference torch checkpoints into the port's networks, and back.

Port of ``bacs_tpu/utils/torch_weights.py``: the PLOP release backbone
(``resnet101_iabn_sync.pth.tar``; reference: networks/resnet.py:432-488,
networks/deeplab_v3.py:36-49 ``backbone_weights_path``) and whole
reference DeepLabV3, TranSeg and UNet state dicts, and the inverse
``export_backbone_release``.

The route is the JAX converters' own, in numpy: a network's weights as
Flax-shaped trees (``model_variables``: ``utils/flax_weights.py``'s
``state_dict_to_flax``), the reference keys mapped onto those trees
exactly as JAX maps them, then the trees copied back into the network
(``flax_weights.load_flax_variables``).  So the port fills the same tensors as JAX from the
same file, and these rules hold as they do there:

- conv weight [out, in, kh, kw] -> kernel [kh, kw, in, out] (and back by
  ``flax_weights``: a torch conv lands in the port's network unchanged);
- an ABN weight -> its magnitude ``|weight|`` (inplace-ABN stores the
  scale's magnitude); a plain BatchNorm2d's (the detector's trunk, UNet)
  is signed;
- UNet's ConvTranspose2d: flipped in both spatial axes into Flax's layout,
  flipped back by ``flax_weights`` (the port's transpose conv is torch's);
- ``BNReLUAct``'s ``_bn.bn.`` level collapses;
- per-task ``classifier_head.<t>`` and detector ``seen_not_seen_clf.<t>``
  heads are concatenated into the padded head.

A tensor whose shape does not match its target is skipped, as in JAX (the
count says how many were taken).  A DeepLabV3 state dict with the SDR
atrous backbone (``backbone.layer1.*``) takes that layout's converter
(``_convert_atrous``), and every norm scale of it, the head's too, is a
plain BatchNorm2d's, signed (``bacs_tpu/utils/torch_weights.py:127-190,
246-249``).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch

from bacs_tpu_torch.utils.flax_weights import load_flax_variables, state_dict_to_flax

Tree = Dict[str, Any]


def _to_flax_conv(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))


def _to_torch_conv(k: np.ndarray) -> np.ndarray:
    # kernel [kh, kw, in, out] -> weight [out, in, kh, kw]
    return np.transpose(np.asarray(k), (3, 2, 0, 1))


def _clone(t):
    if isinstance(t, Mapping):
        return {k: _clone(v) for k, v in t.items()}
    return t


def _set_leaf(tree: Tree, path: Sequence[str], value) -> bool:
    """Put ``value`` at ``path`` if the leaf exists with its shape."""
    node = tree
    for p in path[:-1]:
        if p not in node:
            return False
        node = node[p]
    leaf = path[-1]
    if leaf in node and tuple(np.shape(node[leaf])) == tuple(np.shape(value)):
        node[leaf] = np.asarray(value, np.float32)
        return True
    return False


def _put(tree: Tree, path: Sequence[str], value) -> int:
    """Put ``value`` at ``path``; a missing leaf or another shape raises."""
    node = tree
    for p in path[:-1]:
        node = node[p]
    leaf = path[-1]
    assert tuple(np.shape(node[leaf])) == tuple(np.shape(value)), (
        path, np.shape(node[leaf]), np.shape(value))
    node[leaf] = np.asarray(value, np.float32)
    return 1


def _set_norm(tree_p: Tree, tree_s: Tree, path: Sequence[str], leaf: str, value,
              magnitude: bool = True) -> bool:
    path = list(path)
    if leaf == "weight":
        return _set_leaf(tree_p, path + ["scale"], np.abs(value) if magnitude else value)
    if leaf == "bias":
        return _set_leaf(tree_p, path + ["bias"], value)
    if leaf == "running_mean":
        return _set_leaf(tree_s, path + ["mean"], value)
    if leaf == "running_var":
        return _set_leaf(tree_s, path + ["var"], value)
    return False


# ---------------------------------------------------------------- the network's trees


def model_variables(model: torch.nn.Module) -> Dict[str, Tree]:
    """``{"params", "batch_stats"}``: the network's weights as Flax-shaped
    trees of float32 numpy arrays."""
    params, stats = state_dict_to_flax(model.state_dict())
    return {"params": params, "batch_stats": stats}


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A torch checkpoint's tensors as numpy: ``state_dict``, ``model`` or
    ``model_state`` unwrapped, every ``module.`` dropped."""
    ckpt = torch.load(os.path.expanduser(path), map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict):
        for key in ("state_dict", "model", "model_state"):
            if key in ckpt and isinstance(ckpt[key], dict):
                ckpt = ckpt[key]
                break
    out = {}
    for k, v in ckpt.items():
        if isinstance(v, torch.Tensor):
            out[k.replace("module.", "")] = v.detach().cpu().numpy()
    return out


# ---------------------------------------------------------------- the release backbone


def _convert(sd: Mapping[str, np.ndarray], params: Tree, batch_stats: Tree):
    """The release backbone's keys (``mod1.conv1``, ``modK.blockJ.convs.
    convI``/``bnI``, ``proj_conv``/``proj_bn``) onto ``params["backbone"]``
    and ``batch_stats["backbone"]``: (params, batch_stats, count)."""
    params, batch_stats = _clone(params), _clone(batch_stats)
    bb_p = params.get("backbone", {})
    bb_s = batch_stats.get("backbone", {})
    sd = {re.sub(r"^(body|module)\.", "", k): v for k, v in sd.items()}
    loaded = 0
    for key, value in sd.items():
        parts = key.replace(".convs.", ".").split(".")
        if parts[0] == "mod1":
            # stem: mod1.conv1.weight, mod1.bn1.*
            if len(parts) >= 3 and parts[1] == "conv1" and parts[2] == "weight":
                loaded += _set_leaf(bb_p, ["conv1", "kernel"], _to_flax_conv(value))
            elif len(parts) >= 3 and parts[1] == "bn1":
                loaded += _set_norm(bb_p, bb_s, ["bn1"], parts[2], value)
            continue
        m = re.match(r"mod(\d+)$", parts[0])
        b = re.match(r"block(\d+)$", parts[1]) if len(parts) > 2 else None
        if not (m and b):
            continue
        mod = f"{parts[0]}_block{b.group(1)}"
        layer = parts[2]
        leaf = parts[3] if len(parts) > 3 else None
        if (layer.startswith("conv") or layer == "proj_conv") and leaf == "weight":
            loaded += _set_leaf(bb_p, [mod, layer, "kernel"], _to_flax_conv(value))
        elif layer.startswith("bn") or layer == "proj_bn":
            loaded += _set_norm(bb_p, bb_s, [mod, layer], leaf, value)
    params["backbone"] = bb_p
    batch_stats["backbone"] = bb_s
    return params, batch_stats, loaded


def load_pretrained_backbone(path: str, variables: Mapping[str, Tree]):
    """The release file at ``path`` onto ``variables``' backbone:
    (params, batch_stats, count of tensors loaded)."""
    sd = load_torch_state_dict(path)
    return _convert(sd, variables["params"], variables.get("batch_stats", {}))


def load_backbone_into(model: torch.nn.Module, path: str) -> int:
    """Load the release backbone file at ``path`` into ``model`` in place;
    returns the count of tensors loaded."""
    params, stats, n = load_pretrained_backbone(path, model_variables(model))
    load_flax_variables(model, params, stats)
    return n


def export_backbone_release(variables: Mapping[str, Tree], path: str,
                            n_fc_classes: int = 1000) -> int:
    """Write a backbone as a ``resnet101_iabn_sync.pth.tar``-style release
    file: ``{"state_dict": ...}``, keys ``module.``-prefixed, block convs
    under ``.convs.``, and the ImageNet ``classifier.fc`` the reference
    loader deletes (networks/resnet.py:455-488).  The inverse of
    ``load_pretrained_backbone`` up to ABN's ``|weight|``.  Returns the
    count of backbone tensors written (the fc excluded)."""
    bb_p = variables["params"]["backbone"]
    bb_s = variables.get("batch_stats", {}).get("backbone", {})
    sd: Dict[str, torch.Tensor] = {}

    def put(key: str, value):
        sd[f"module.{key}"] = torch.from_numpy(np.array(value, np.float32, copy=True))

    def put_norm(tkey: str, mod_p, mod_s):
        put(f"{tkey}.weight", mod_p["scale"])
        put(f"{tkey}.bias", mod_p["bias"])
        put(f"{tkey}.running_mean", mod_s["mean"])
        put(f"{tkey}.running_var", mod_s["var"])

    for name in sorted(bb_p):
        node_p, node_s = bb_p[name], bb_s.get(name, {})
        if name == "conv1":
            put("mod1.conv1.weight", _to_torch_conv(node_p["kernel"]))
        elif name == "bn1":
            put_norm("mod1.bn1", node_p, node_s)
        else:
            m = re.match(r"mod(\d+)_block(\d+)$", name)
            if not m:
                raise ValueError(f"unexpected backbone module {name!r}")
            base = f"mod{m.group(1)}.block{m.group(2)}"
            for sub in sorted(node_p):
                if sub.startswith("conv"):
                    put(f"{base}.convs.{sub}.weight", _to_torch_conv(node_p[sub]["kernel"]))
                elif sub.startswith("bn"):
                    put_norm(f"{base}.convs.{sub}", node_p[sub], node_s[sub])
                elif sub == "proj_conv":
                    put(f"{base}.proj_conv.weight", _to_torch_conv(node_p[sub]["kernel"]))
                elif sub == "proj_bn":
                    put_norm(f"{base}.proj_bn", node_p[sub], node_s[sub])
                else:
                    raise ValueError(f"unexpected leaf {name}.{sub}")
    n_bb = len(sd)
    # the release file's ImageNet fc, which the reference loader deletes
    # (networks/resnet.py:480-481)
    out_ch = int(np.shape(bb_p["bn1"]["scale"])[0])
    for name, node in bb_p.items():
        if re.match(r"mod(\d+)_block(\d+)$", name):
            last = "conv3" if "conv3" in node else "conv2"
            out_ch = max(out_ch, int(np.shape(node[last]["kernel"])[-1]))
    put("classifier.fc.weight", np.zeros((n_fc_classes, out_ch), np.float32))
    put("classifier.fc.bias", np.zeros((n_fc_classes,), np.float32))
    torch.save({"state_dict": sd}, os.path.expanduser(path))
    return n_bb


# ---------------------------------------------------------------- whole networks


def _backbone_sd(sd: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {k[len("backbone."):]: v for k, v in sd.items() if k.startswith("backbone.")}


def _convert_atrous(sd: Mapping[str, np.ndarray], params: Tree, batch_stats: Tree):
    """The SDR ResNet_Atrous keys (``conv1``, ``bn1``, ``layer{s}.{b}.conv{i}``
    / ``bn{i}``, ``downsample.0`` / ``.1``; reference: networks/resnet_atrous.py)
    onto the ``layer{s}_block{b+1}`` tree, the norm scales signed:
    (params, batch_stats, count)."""
    params, batch_stats = _clone(params), _clone(batch_stats)
    bb_p = params.get("backbone", {})
    bb_s = batch_stats.get("backbone", {})
    loaded = 0
    for key, value in sd.items():
        parts = key.split(".")
        if parts[0] == "conv1" and parts[-1] == "weight":
            loaded += _set_leaf(bb_p, ["conv1", "kernel"], _to_flax_conv(value))
        elif parts[0] == "bn1":
            loaded += _set_norm(bb_p, bb_s, ["bn1"], parts[1], value, magnitude=False)
        elif parts[0].startswith("layer"):
            mod = f"{parts[0]}_block{int(parts[1]) + 1}"
            layer = parts[2]
            if layer.startswith("conv") and parts[-1] == "weight":
                loaded += _set_leaf(bb_p, [mod, layer, "kernel"], _to_flax_conv(value))
            elif layer.startswith("bn"):
                loaded += _set_norm(bb_p, bb_s, [mod, layer], parts[3], value,
                                    magnitude=False)
            elif layer == "downsample":
                # downsample.0 is the 1x1 conv, downsample.1 its BatchNorm2d
                if parts[3] == "0" and parts[-1] == "weight":
                    loaded += _set_leaf(bb_p, [mod, "downsample_conv", "kernel"],
                                        _to_flax_conv(value))
                elif parts[3] == "1":
                    loaded += _set_norm(bb_p, bb_s, [mod, "downsample_bn"], parts[4], value,
                                        magnitude=False)
    params["backbone"], batch_stats["backbone"] = bb_p, bb_s
    return params, batch_stats, loaded


def convert_reference_deeplab(sd: Mapping[str, np.ndarray], variables: Mapping[str, Tree]):
    """A whole reference DeepLabV3 state dict (backbone, ASPP
    ``base_classifier``, one or per-task ``classifier_head``, the BACS
    detector ``seen_fg_network``; reference: networks/deeplab_v3.py:175-305,
    base_network.py:99-118, bg_detector.py) onto ``variables``:
    (params, batch_stats, count)."""
    # BNReLUAct wraps a BatchNorm2d in a `.bn` submodule
    # (reference: deeplab_v3.py:308-332): that level collapses
    sd = {k.replace("_bn.bn.", "_bn."): v for k, v in sd.items()}
    backbone = _backbone_sd(sd)
    atrous = any(k.startswith("layer1.") for k in backbone)
    params, batch_stats, loaded = (_convert_atrous if atrous else _convert)(
        backbone, variables["params"], variables.get("batch_stats", {}))
    hd_p = params.get("base_classifier", {})
    hd_s = batch_stats.get("base_classifier", {})
    det_p = params.get("seen_fg_network", {})
    det_s = batch_stats.get("seen_fg_network", {})
    head_rows: Dict[int, list] = {}
    det_rows: Dict[int, list] = {}
    for key, value in sd.items():
        parts = key.split(".")
        if parts[0] == "base_classifier":
            if parts[1] == "map_convs" and parts[3] == "weight":
                loaded += _set_leaf(hd_p, [f"map_conv{parts[2]}", "kernel"],
                                    _to_flax_conv(value))
            elif parts[1].endswith("_conv") and parts[2] == "weight":
                loaded += _set_leaf(hd_p, [parts[1], "kernel"], _to_flax_conv(value))
            elif parts[1].endswith("_bn"):
                # the atrous model's head norms are BatchNorm2d's too: signed
                loaded += _set_norm(hd_p, hd_s, [parts[1]], parts[2], value,
                                    magnitude=not atrous)
        elif parts[0] == "classifier_head":
            # one conv (classifier_head.weight) or a ModuleList (.<t>.weight)
            idx = 0 if parts[1] in ("weight", "bias") else int(parts[1])
            row = head_rows.setdefault(idx, [None, None])
            row[parts[-1] == "bias"] = value
        elif parts[0] == "seen_fg_network":
            if parts[1] == "base_layers":
                if parts[2] == "0" and parts[3] == "weight":
                    loaded += _set_leaf(det_p, ["base_conv", "kernel"], _to_flax_conv(value))
                elif parts[2] == "1":
                    # a torch BatchNorm2d: its scale signed
                    loaded += _set_norm(det_p, det_s, ["base_bn"], parts[3], value,
                                        magnitude=False)
            elif parts[1] == "seen_not_seen_clf":
                idx = 0 if parts[2] == "conv" else int(parts[2])
                row = det_rows.setdefault(idx, [None, None])
                row[parts[-1] == "bias"] = value
    if head_rows:
        w = np.concatenate([head_rows[i][0] for i in sorted(head_rows)], axis=0)
        b = np.concatenate([head_rows[i][1] for i in sorted(head_rows)], axis=0)
        hp = params["classifier_head"]
        n = min(hp["kernel"].shape[-1], w.shape[0])
        kernel, bias = np.array(hp["kernel"]), np.array(hp["bias"])
        kernel[..., :n] = _to_flax_conv(w)[..., :n]
        bias[:n] = b[:n]
        hp["kernel"], hp["bias"] = kernel, bias
        loaded += 2 * len(head_rows)
    if det_rows:
        hk, hb = np.array(det_p["head_kernel"]), np.array(det_p["head_bias"])
        for i, (w, b) in det_rows.items():
            hk[i] = w[:, :, 0, 0].T  # [1, D, 1, 1] -> [D, 1]
            hb[i] = b
        det_p["head_kernel"], det_p["head_bias"] = hk, hb
        loaded += 2 * len(det_rows)
    return params, batch_stats, loaded


def convert_reference_transeg(sd: Mapping[str, np.ndarray], variables: Mapping[str, Tree]):
    """A reference TranSeg state dict (the backbone and the
    TransformerHead: feature_embedding, pos_embed, class_tokens, the
    decoder blocks, proj_patch/proj_classes, decoder_norm, mask_norm;
    reference: networks/transeg.py:85-175, networks/layers.py:39-95) onto
    ``variables``: (params, batch_stats, count).  The unused inherited
    ``classifier_head`` is skipped, as the reference's forward skips it."""
    params, batch_stats, loaded = _convert(
        _backbone_sd(sd), variables["params"], variables.get("batch_stats", {}))
    hd = params["base_classifier"]
    for key, v in sd.items():
        if not key.startswith("base_classifier."):
            continue
        parts = key.split(".")[1:]
        name, leaf = parts[0], parts[-1]
        if name == "feature_embedding":
            loaded += _put(hd, ["feature_embedding", "kernel" if leaf == "weight" else "bias"],
                           _to_flax_conv(v) if leaf == "weight" else v)
        elif name == "pos_embed":
            loaded += _put(hd, ["pos_embed"], np.transpose(v, (0, 2, 3, 1)))
        elif name == "class_tokens":
            loaded += _put(hd, ["class_tokens"], v[0])
        elif name == "mask_norm":
            loaded += _put(hd, ["mask_norm_scale" if leaf == "weight" else "mask_norm_bias"], v)
        elif name in ("proj_patch", "proj_classes"):
            loaded += _put(hd, [name], v)
        elif name == "decoder_norm":
            loaded += _put(hd, ["decoder_norm", "scale" if leaf == "weight" else "bias"], v)
        elif name == "blocks":
            blk = hd[f"block{parts[1]}"]
            sub = parts[2]
            if sub in ("norm1", "norm2"):
                loaded += _put(blk, [sub, "scale" if leaf == "weight" else "bias"], v)
            elif sub in ("attn", "mlp"):  # linear layers: qkv, proj, fc1, fc2
                which = parts[3] if sub == "attn" else f"mlp_{parts[3]}"
                path = ["attn", which] if sub == "attn" else [which]
                loaded += _put(blk, path + ["kernel" if leaf == "weight" else "bias"],
                               v.T if leaf == "weight" else v)
    return params, batch_stats, loaded


def convert_reference_unet(sd: Mapping[str, np.ndarray], variables: Mapping[str, Tree]):
    """A reference UNet state dict (DoubleConv stacks, Down/Up blocks, plain
    BatchNorm2d, the 1 x 1 classifier; reference: networks/unet.py:10-180)
    onto ``variables``: (params, batch_stats, count)."""
    params = _clone(variables["params"])
    batch_stats = _clone(variables.get("batch_stats", {}))
    # torch DoubleConv indices -> (Flax name, is a norm)
    dc_map = {"0": ("conv1", False), "1": ("bn1", True),
              "3": ("conv2", False), "4": ("bn2", True)}

    def put_dc(blk, idx, leaf, value):
        name, is_bn = dc_map[idx]
        if not is_bn:
            if leaf == "weight":
                return _put(params, blk + [name, "kernel"], _to_flax_conv(value))
            return _put(params, blk + [name, "bias"], value)
        # plain BatchNorm2d: signed scale
        target = {"weight": (params, "scale"), "bias": (params, "bias"),
                  "running_mean": (batch_stats, "mean"),
                  "running_var": (batch_stats, "var")}.get(leaf)
        if target is None:
            return 0  # num_batches_tracked
        return _put(target[0], blk + [name, target[1]], value)

    loaded = 0
    for key, v in sd.items():
        parts = key.split(".")
        if parts[0] == "inc":
            loaded += put_dc(["inc"], parts[2], parts[3], v)
        elif parts[0] == "downsample":
            # downsample.<i>.maxpool_conv.1.double_conv.<j>.<leaf>
            loaded += put_dc([f"down{int(parts[1]) + 1}"], parts[5], parts[6], v)
        elif parts[0] == "upsample":
            i = int(parts[1])
            if parts[2] == "up":  # ConvTranspose2d [in, out, kh, kw]
                if parts[3] == "weight":
                    # Flax's transpose kernel is torch's flipped in both
                    # spatial axes (lax.conv_transpose against the conv's
                    # gradient)
                    loaded += _put(params, [f"up_tconv{i + 1}", "kernel"],
                                   np.transpose(v[..., ::-1, ::-1], (2, 3, 0, 1)))
                else:
                    loaded += _put(params, [f"up_tconv{i + 1}", "bias"], v)
            else:  # upsample.<i>.conv.double_conv.<j>.<leaf>
                loaded += put_dc([f"up{i + 1}"], parts[4], parts[5], v)
        elif parts[0] == "classifier_head":
            hp = params["classifier_head"]
            if parts[-1] == "weight":
                k = _to_flax_conv(v)
                n = min(hp["kernel"].shape[-1], k.shape[-1])
                kernel = np.array(hp["kernel"])
                kernel[..., :n] = k[..., :n]
                hp["kernel"] = kernel
            else:
                n = min(hp["bias"].shape[0], v.shape[0])
                bias = np.array(hp["bias"])
                bias[:n] = v[:n]
                hp["bias"] = bias
            loaded += 1
    return params, batch_stats, loaded


def convert_reference(sd: Mapping[str, np.ndarray], variables: Mapping[str, Tree],
                      network_target: str):
    """The converter of ``network._target_``'s network."""
    if network_target.endswith("UNet"):
        return convert_reference_unet(sd, variables)
    if network_target.endswith("TranSeg"):
        return convert_reference_transeg(sd, variables)
    return convert_reference_deeplab(sd, variables)


def release_backbone_shapes(backbone: Tree) -> Dict[str, tuple]:
    """{key: shape} of the release layout (``mod1.conv1.weight``,
    ``modK.blockJ.convs.convI.weight``, ``...bnI.{weight, bias,
    running_mean, running_var}``, ``proj_conv``/``proj_bn``) for a backbone
    tree of ``backbone``'s structure: the keys ``_convert`` reads."""

    def conv(k):
        kh, kw, cin, cout = np.shape(k)
        return (cout, cin, kh, kw)

    shapes: Dict[str, tuple] = {}
    for name in sorted(backbone):
        node = backbone[name]
        if name == "conv1":
            shapes["mod1.conv1.weight"] = conv(node["kernel"])
            continue
        if name == "bn1":
            base, subs = "mod1", {"bn1": node}
        else:
            m = re.match(r"mod(\d+)_block(\d+)$", name)
            base, subs = f"mod{m.group(1)}.block{m.group(2)}", node
        for sub, leafs in sorted(subs.items()):
            where = base if sub.startswith("proj") or name == "bn1" else f"{base}.convs"
            if "kernel" in leafs:
                shapes[f"{where}.{sub}.weight"] = conv(leafs["kernel"])
            else:
                for leaf in ("weight", "bias", "running_mean", "running_var"):
                    shapes[f"{where}.{sub}.{leaf}"] = tuple(np.shape(leafs["scale"]))
    return shapes


def reference_deeplab_shapes(variables: Mapping[str, Tree],
                             head_sizes: Sequence[int]) -> Dict[str, tuple]:
    """{key: shape} of a reference DeepLabV3 state dict for a network of
    ``variables``' structure, with one classifier conv per task of
    ``head_sizes`` classes and, where the network has the detector, one
    detector head per task: the keys ``convert_reference_deeplab`` reads,
    so a state dict of these keys fills every tensor.  Each ASPP norm
    appears as ``BNReLUAct``'s ``<name>_bn.bn.*``."""
    params = variables["params"]

    def conv(k):
        kh, kw, cin, cout = np.shape(k)
        return (cout, cin, kh, kw)

    shapes = {f"backbone.{k}": v for k, v in release_backbone_shapes(params["backbone"]).items()}
    for name, node in sorted(params["base_classifier"].items()):
        m = re.fullmatch(r"map_conv(\d+)", name)
        if m:
            shapes[f"base_classifier.map_convs.{m.group(1)}.weight"] = conv(node["kernel"])
        elif "kernel" in node:
            shapes[f"base_classifier.{name}.weight"] = conv(node["kernel"])
        else:
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                shapes[f"base_classifier.{name}.bn.{leaf}"] = tuple(np.shape(node["scale"]))
    d = np.shape(params["classifier_head"]["kernel"])[2]
    for t, c in enumerate(head_sizes):
        shapes[f"classifier_head.{t}.weight"] = (c, d, 1, 1)
        shapes[f"classifier_head.{t}.bias"] = (c,)
    det = params.get("seen_fg_network")
    if det is not None:
        shapes["seen_fg_network.base_layers.0.weight"] = conv(det["base_conv"]["kernel"])
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"seen_fg_network.base_layers.1.{leaf}"] = tuple(
                np.shape(det["base_bn"]["scale"]))
        dd = np.shape(det["head_kernel"])[1]
        for t in range(len(head_sizes)):
            shapes[f"seen_fg_network.seen_not_seen_clf.{t}.weight"] = (1, dd, 1, 1)
            shapes[f"seen_fg_network.seen_not_seen_clf.{t}.bias"] = (1,)
    return shapes


def seeded_state_dict(shapes: Mapping[str, tuple], seed: int) -> Dict[str, torch.Tensor]:
    """Seeded float32 values for ``shapes``, at scales a forward keeps
    finite: conv and linear weights normal over the fan-in (1 / fan_in
    variance), norm weights of magnitude 0.5-1.5 and random sign (the ABN
    magnitude rule is exercised), running variances 0.5-2, everything else
    normal at 0.1."""
    rs = np.random.RandomState(seed)
    out = {}
    for k, shape in shapes.items():
        if k.endswith("running_var"):
            v = rs.uniform(0.5, 2.0, shape)
        elif k.endswith("weight") and len(shape) >= 2:
            v = rs.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        elif k.endswith("weight"):
            v = rs.uniform(0.5, 1.5, shape) * rs.choice([-1.0, 1.0], shape)
        else:
            v = rs.standard_normal(shape) * 0.1
        out[k] = torch.from_numpy(np.asarray(v, np.float32))
    return out
