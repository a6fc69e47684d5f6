"""Flax variables <-> the port's torch state_dict.

The port keeps the Flax module names as torch submodule names
(``backbone.conv1``, ``backbone.mod2_block1.bn1``,
``base_classifier.map_conv0``, ``classifier_head``), so a Flax variable path
joined with dots is a state_dict key.  Leaves map as follows (the conv
transpose is the one of ``bacs_tpu/utils/torch_weights.py:515``):

    params      kernel [kh, kw, in, out] -> weight [out, in, kh, kw]
    params      scale  [C]               -> weight        (ABN)
    params      bias   [C]               -> bias          (ABN, classifier_head)
    batch_stats mean   [C]               -> running_mean
    batch_stats var    [C]               -> running_var
    params      head_kernel [T, D, 1], head_bias [T, 1] -> the same names,
                no transpose (the background detector's task heads,
                ``seen_fg_network``)

The trees are nested mappings of numpy-convertible arrays, as the JAX
package's ``variables["params"]`` and ``variables["batch_stats"]`` are; no
JAX import is needed.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

# leaves that keep their name and layout
_RAW_PARAMS = ("head_kernel", "head_bias", "pos_embed", "class_tokens", "proj_patch",
               "proj_classes", "mask_norm_scale", "mask_norm_bias")
_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
                 **{k: k for k in _RAW_PARAMS}}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _is_transpose(mod) -> bool:
    """A transpose convolution's module path (UNet's ``up_tconv<i>``)."""
    return bool(mod) and mod[-1].startswith("up_tconv")


def _leaves(tree: Mapping, path: Tuple[str, ...] = ()) -> Iterator:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (str(k),))
        else:
            yield path + (str(k),), v


def flax_to_state_dict(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """Flax (params, batch_stats) -> {state_dict key: float32 tensor}."""
    sd: Dict[str, torch.Tensor] = {}
    for tree, names in ((params, _PARAM_LEAVES), (batch_stats, _STAT_LEAVES)):
        for path, leaf in _leaves(tree):
            *mod, name = path
            if name not in names:
                raise KeyError(f"unknown Flax leaf {'/'.join(path)}")
            arr = np.asarray(leaf, np.float32)
            if name == "kernel":
                if arr.ndim not in (2, 4):
                    raise ValueError(f"{'/'.join(path)}: expected a 4-D conv or 2-D "
                                     "Dense kernel")
                if arr.ndim == 2:
                    arr = arr.T
                elif _is_transpose(mod):
                    arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
                else:
                    arr = arr.transpose(3, 2, 0, 1)
            key = ".".join(mod + [names[name]])
            if key in sd:
                raise KeyError(f"two Flax leaves map to {key}")
            sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Tuple[Dict, Dict]:
    """Inverse of :func:`flax_to_state_dict`: -> (params, batch_stats) of
    nested dicts of float32 numpy arrays."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for key, t in state_dict.items():
        *mod, name = key.split(".")
        arr = t.detach().float().cpu().numpy()
        if name == "weight":
            tree, leaf = params, "scale" if arr.ndim == 1 else "kernel"
            if arr.ndim == 4 and _is_transpose(mod):
                arr = arr.transpose(2, 3, 0, 1)[::-1, ::-1]
            elif arr.ndim == 4:
                arr = arr.transpose(2, 3, 1, 0)
            elif arr.ndim == 2:
                arr = arr.T
        elif name == "bias" or name in _RAW_PARAMS:
            tree, leaf = params, name
        elif name in ("running_mean", "running_var"):
            tree, leaf = stats, name[len("running_"):]
        else:
            raise KeyError(f"no Flax counterpart for {key}")
        for m in mod:
            tree = tree.setdefault(m, {})
        tree[leaf] = np.ascontiguousarray(arr)
    return params, stats


def load_flax_variables(model: nn.Module, params: Mapping, batch_stats: Mapping) -> None:
    """Copy Flax variables into ``model``; a missing or extra key raises."""
    sd = flax_to_state_dict(params, batch_stats)
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(
            f"Flax variables do not match the model: missing {missing[:8]}"
            f"{'...' if len(missing) > 8 else ''}, extra {extra[:8]}"
            f"{'...' if len(extra) > 8 else ''}"
        )
    for k, v in sd.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: Flax shape {tuple(v.shape)} vs model "
                             f"{tuple(own[k].shape)}")
    model.load_state_dict(sd, strict=True)
