"""A network's initial weights as the JAX package's ``model.init`` draws them.

``bacs_tpu/train/loop.py:253-260`` splits ``PRNGKey(seed)`` into
``r_param, r_drop, r_state`` and calls ``model.init({"params": r_param,
"dropout": r_drop}, ...)``.  Flax gives each parameter its own key
(``flax/core/scope.py``: ``LazyRng``, ``_fold_in_static``, ``make_rng``;
``rng.scope_key``): the names of the module path from the root and then
the module scope's count of ``params`` draws so far (1 for its first
parameter, 2 for its second), hashed by SHA-1 and folded into ``r_param``.
The parameter is its initializer's draw from that key, in Flax's layout
([kh, kw, in, out] kernels), and :func:`..flax_weights.load_flax_variables`
turns the tree into the port's layout, the one conversion the tests hold.

The port keeps the Flax module names as its own, so a state_dict key names
the path.  The initializers (the draws bit for bit those of ``jax.random``
on the CPU, ``ops/rng.py``):

- the ResNet's and the ASPP's convolutions: He-normal over the fan-out,
  ``variance_scaling(2, "fan_out", "normal")`` (``bacs_tpu/models/
  resnet.py:59``);
- every other convolution, transpose convolution and ``Dense``: Flax's
  default, ``lecun_normal`` (a normal truncated to [-2, 2], scaled to
  variance 1 / fan-in); the detector's task heads [T, D, 1] too (fan-in
  D x T);
- TranSeg's head (``bacs_tpu/models/transeg.py``): ``pos_embed``
  normal(1), ``class_tokens`` 0.02 x truncated normal, ``proj_patch`` and
  ``proj_classes`` normal(D^-1/2), the 3rd to 6th draws of the head's scope
  after ``pos_embed`` and ``class_tokens``;
- biases 0 and norm scales 1 (their keys are drawn and unused).

The draws run on the host and the tensors are copied to the model's
device, so the card's weights equal the CPU's bit for bit.  The batch
statistics keep the model's own (mean 0, variance 1, as Flax's).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from bacs_tpu_torch.ops import rng
from bacs_tpu_torch.utils.flax_weights import load_flax_variables, state_dict_to_flax

# convolutions of DeepLabV3 and TranSeg that keep Flax's default initializer
FLAX_DEFAULT_CONVS = ("classifier_head", "seen_fg_network.base_conv",
                      "base_classifier.feature_embedding")
# a parameter leaf's place among its scope's draws, where not first
_COUNT = {"bias": 2, "head_bias": 2, "pos_embed": 1, "class_tokens": 2, "proj_patch": 3,
          "proj_classes": 4, "mask_norm_scale": 5, "mask_norm_bias": 6}
_STATS = ("running_mean", "running_var")
# lecun_normal's truncated normal has this standard deviation
_TRUNC_STD = np.float32(0.87962566103423978)


def trainer_keys(seed: int) -> Tuple[rng.Key, rng.Key, rng.Key]:
    """``r_param, r_drop, r_state = split(PRNGKey(seed), 3)``, the
    Trainer's keys (``bacs_tpu/train/loop.py:253-254``)."""
    r_param, r_drop, r_state = rng.split(rng.key(seed), 3)
    return r_param, r_drop, r_state


def _lecun(k: rng.Key, shape, fan_in: int) -> np.ndarray:
    """``lecun_normal()``: truncated normal x sqrt(1 / fan_in) / 0.8796."""
    std = np.sqrt(np.float32(1.0 / fan_in)) / _TRUNC_STD
    return rng.truncated_normal(k, shape, scale=std).numpy()


def _draw(path: Tuple[str, ...], leaf: str, shape, k: rng.Key, he: bool) -> np.ndarray:
    """One parameter as its Flax initializer draws it from ``k``."""
    if leaf in ("bias", "head_bias", "mask_norm_bias"):
        return np.zeros(shape, np.float32)
    if leaf in ("scale", "mask_norm_scale"):
        return np.ones(shape, np.float32)
    if leaf == "pos_embed":
        return rng.normal(k, shape).numpy()
    if leaf == "class_tokens":
        return rng.truncated_normal(k, shape, scale=0.02).numpy()
    if leaf in ("proj_patch", "proj_classes"):
        return rng.normal(k, shape, scale=shape[0] ** -0.5).numpy()
    if leaf == "head_kernel":  # [T, D, 1]
        return _lecun(k, shape, shape[0] * shape[1])
    if leaf != "kernel":
        raise KeyError(f"no initializer for {'/'.join(path + (leaf,))}")
    if len(shape) == 2:  # Dense [in, out]
        return _lecun(k, shape, shape[0])
    kh, kw, c_in, c_out = shape
    if he:
        std = np.sqrt(np.float32(2.0 / (c_out * kh * kw)))
        return rng.normal(k, shape, scale=std).numpy()
    return _lecun(k, shape, c_in * kh * kw)


def flax_params(model: torch.nn.Module, r_param: rng.Key) -> Dict:
    """The Flax parameter tree (nested dicts of f32 numpy arrays, Flax
    layout) that ``model.init`` draws from ``r_param`` for the JAX network
    that ``model`` ports."""
    from bacs_tpu_torch.models.unet import UNet

    # the tree's layout from the parameters' shapes alone (zero-stride
    # stand-ins: no copy of the model's values off its device)
    params, _ = state_dict_to_flax({k: torch.zeros(()).expand(v.shape)
                                    for k, v in model.state_dict().items()
                                    if not k.endswith(_STATS)})
    flax_default = isinstance(model, UNet)

    def fill(tree: Dict, path: Tuple[str, ...]) -> None:
        for name, v in tree.items():
            if isinstance(v, dict):
                fill(v, path + (name,))
                continue
            dotted = ".".join(path)
            he = not flax_default and dotted not in FLAX_DEFAULT_CONVS
            k = rng.scope_key(r_param, path, _COUNT.get(name, 1))
            tree[name] = np.ascontiguousarray(_draw(path, name, v.shape, k, he))

    fill(params, ())
    return params


def init_weights(model: torch.nn.Module, seed: int) -> None:
    """Set ``model``'s parameters to the JAX package's initial weights for
    ``seed`` (``model.init`` with ``r_param`` of :func:`trainer_keys`),
    drawn on the host and copied to the model's device; the batch
    statistics stay the model's own."""
    r_param, _, _ = trainer_keys(seed)
    _, stats = state_dict_to_flax({k: v for k, v in model.state_dict().items()
                                   if k.endswith(_STATS)})
    load_flax_variables(model, flax_params(model, r_param), stats)
