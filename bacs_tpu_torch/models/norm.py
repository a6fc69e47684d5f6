"""ABN: batch norm fused with its activation.

Port of ``bacs_tpu/models/norm.py`` (``ABN`` and ``make_norm``).  The
activation is a slope: leaky_relu -> its parameter, relu -> 0, identity
-> 1.  ``pool=True`` (the ResNet stem) follows the apply with a 3x3/2
max-pool padded by 1, padding counting as -inf as in Flax.

- Eval mode: every layer runs the K5 wrapper ``fused_abn_eval``
  (``ops/abn_core.py``, Triton on the card) with the running statistics.
  Renorm changes nothing there (the JAX module skips it with running
  statistics), so the renorm norms build the same layer as the plain ones.
- Train mode, fused branch (``norm.py:102-139``), taken for an invertible
  activation without renorm while ``fused`` (``network.fused_abn``) is on:
  ``fused_abn`` (in-place-ABN backward) on the batch statistics, then the
  torch-style running update with momentum and the n/(n-1) Bessel factor
  on the variance (``norm.py:65-72``).  With ``fused_stem`` (off by
  default, as in JAX) the stem's ABN + max-pool on an even H and W is one
  kernel, K12 (``ops/stem_pool.py``), its running update counting the
  unpooled rows.
- Train mode, non-fused branch (``norm.py:141-185``): ReLU (``bn``), the
  renorm/ABR variants, and any norm with ``fused=False``.  Plain PyTorch
  with autograd: the f32 moments, the folded affine in the activations'
  dtype, then the activation; batch renorm corrects toward the running
  statistics (read after this step's update, as the Flax variables are)
  with r and d clipped to [1/3, 3] and [-5, 5] (Flax's ``rmax``/``dmax``
  defaults) and no gradient.

A synchronized layer (``sync``: the ``*_sync`` norms, and ``bn`` with
``sync=True``, the atrous encoder's) averages its moments across the
ranks of the group that ``parallel.synchronized`` names while a train step
runs, and Bessel-corrects over the global rows (``norm.py:64-72``); the
others keep each rank's statistics, which the step then averages with the
rest of the running statistics (``bacs_tpu/train/step.py:45-50``).

Also Flax's plain ``nn.BatchNorm`` (:class:`BatchNorm`: UNet's and the
background detector's norm, synchronized whenever a group is named, as
both JAX modules pass their ``axis_name``), and :func:`recomputing`, under
which no norm layer updates its running statistics: a block that
``torch.utils.checkpoint`` recomputes in the backward (``network.remat``)
must not update them a second time, as JAX's functional ``batch_stats``
update once.
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn.functional as F
from torch import nn

from bacs_tpu_torch.ops.abn_core import fused_abn, fused_abn_eval
from bacs_tpu_torch.ops.stem_pool import fused_abn_pool
from bacs_tpu_torch.parallel import pmean, sync_group, world_size


def activation_slope(activation: str, param: float) -> float:
    """The leaky slope that expresses ``activation``."""
    if activation == "leaky_relu":
        return float(param)
    if activation == "relu":
        return 0.0
    if activation == "identity":
        return 1.0
    raise ValueError(f"activation {activation!r} has no eval-mode ABN kernel")


def activate(x: torch.Tensor, activation: str, param: float) -> torch.Tensor:
    """The block-output activation (after a residual add), plain PyTorch."""
    slope = activation_slope(activation, param)
    return x if slope == 1.0 else F.leaky_relu(x, slope)


def _activate(y: torch.Tensor, slope: float) -> torch.Tensor:
    """JAX's ``_activate``: ``where(y >= 0, y, y * slope)`` (the gradient
    at 0 is 1, where torch's leaky_relu takes the slope); ReLU is
    ``maximum(y, 0)``."""
    if slope == 1.0:
        return y
    if slope == 0.0:
        return torch.relu(y)
    return torch.where(y >= 0, y, y * slope)


def _moments(x: torch.Tensor, dims, group):
    """(mean, mean of squares) in f32 over ``dims``, squares in x's dtype,
    averaged across ``group`` differentiably (JAX's ``pmean``)."""
    mean = torch.mean(x, dims, dtype=torch.float32)
    mean_sq = torch.mean(x * x, dims, dtype=torch.float32)
    if group is None:
        return mean, mean_sq
    return pmean(torch.stack([mean, mean_sq]), group).unbind(0)


_recomputing = False


@contextlib.contextmanager
def recomputing():
    """The running statistics stay as they are within the block.  A global,
    not a thread-local: the autograd engine recomputes a CUDA block in its
    own thread."""
    global _recomputing
    before, _recomputing = _recomputing, True
    try:
        yield
    finally:
        _recomputing = before


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm`` (momentum 0.9, eps 1e-5) over NCHW, in f32.

    It differs from ``torch.nn.BatchNorm2d``: statistics in float32 with
    var = E[x^2] - E[x]^2 (clipped at 0), the running variance updated with
    that biased batch variance, and Flax's momentum convention,
    running = 0.9 running + 0.1 batch.  The output is float32 whatever
    the input's dtype, as Flax promotes a bf16 input against its f32
    parameters.
    """

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.training:
            mean, mean_sq = _moments(x, (0, 2, 3), sync_group())
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            if not _recomputing:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
                    self.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


# batch renorm's clips of r and d: the defaults of the Flax ABN, which no
# caller overrides
RENORM_RMAX = 3.0
RENORM_DMAX = 5.0


class ABN(nn.Module):
    """Activated batch norm on NCHW tensors in channels_last memory.

    Parameters and buffers carry the torch names (``weight``, ``bias``,
    ``running_mean``, ``running_var``) of the Flax ``scale``, ``bias``,
    ``mean`` and ``var``, all float32.  ``momentum`` is torch's:
    running = (1 - m) * running + m * batch.
    """

    def __init__(
        self,
        features: int,
        eps: float = 1e-5,
        momentum: float = 0.1,
        activation: str = "leaky_relu",
        activation_param: float = 0.01,
        renorm: bool = False,
        pool: bool = False,
        fused: bool = True,
        fused_stem: bool = False,
        sync: bool = False,
    ):
        super().__init__()
        self.features = features
        self.eps = eps
        self.momentum = momentum
        self.activation = activation
        self.activation_param = activation_param
        self.renorm = renorm
        self.pool = pool
        self.fused_stem = fused_stem
        self.sync = sync
        self.slope = activation_slope(activation, activation_param)
        # the JAX module's fused branch: an invertible activation, no renorm
        self.fusable = fused and not renorm and (
            activation == "identity"
            or (activation == "leaky_relu" and activation_param > 0))
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        group = sync_group() if self.sync else None
        if not self.training:
            y = fused_abn_eval(x, self.running_mean, self.running_var,
                               self.weight, self.bias, self.eps, self.slope)
        elif not self.fusable:
            y = self._train_plain(x, group)
        elif self.pool and self.fused_stem and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0:
            p, mean, var = fused_abn_pool(x, self.weight, self.bias, self.eps, self.slope,
                                          group)
            self._update_running(x, mean, var, group)
            return p.permute(0, 3, 1, 2)
        else:
            y, mean, var = fused_abn(x, self.weight, self.bias, self.eps, self.slope, group)
            self._update_running(x, mean, var, group)
        y = y.permute(0, 3, 1, 2)
        if self.pool:
            y = F.max_pool2d(y, kernel_size=3, stride=2, padding=1)
        return y

    def _train_plain(self, x: torch.Tensor, group) -> torch.Tensor:
        """The non-fused train branch on NHWC ``x`` (``norm.py:141-185``)."""
        dt = x.dtype
        mean, mean_sq = _moments(x, (0, 1, 2), group)
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        self._update_running(x, mean.detach(), var.detach(), group)
        if self.renorm:
            sigma_b = torch.sqrt(var + self.eps)
            sigma_r = torch.sqrt(self.running_var + self.eps)
            r = torch.clamp(sigma_b / sigma_r, 1.0 / RENORM_RMAX, RENORM_RMAX).detach()
            d = torch.clamp((mean - self.running_mean) / sigma_r,
                            -RENORM_DMAX, RENORM_DMAX).detach()
            a = (r / sigma_b * self.weight).to(dt)
            b = ((d - mean * r / sigma_b) * self.weight + self.bias).to(dt)
        else:
            inv = torch.rsqrt(var + self.eps)
            a = (inv * self.weight).to(dt)
            b = (self.bias - mean * inv * self.weight).to(dt)
        return _activate(x * a + b, self.slope)

    @torch.no_grad()
    def _update_running(self, x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                        group=None):
        """Torch-style momentum update, the variance Bessel-corrected over
        the rows of the (unpooled) input across ``group``'s ranks; none
        under :func:`recomputing`."""
        if _recomputing:
            return
        n = x.numel() // self.features * world_size(group)
        m = self.momentum
        self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
        self.running_var.mul_(1.0 - m).add_(var, alpha=m * n / max(n - 1, 1))

    def extra_repr(self) -> str:
        return (f"{self.features}, activation={self.activation}, "
                f"slope={self.slope}, renorm={self.renorm}, pool={self.pool}, "
                f"fused={self.fusable}, fused_stem={self.fused_stem}, sync={self.sync}")


_RENORMS = ("iabr_sync", "abr_sync", "iabr", "abr")
_LEAKY_NORMS = ("iabn_sync", "abn_sync", "iabn", "abn") + _RENORMS


def make_norm(norm: str, fused_stem: bool = False, fused: bool = True,
              sync: bool = False):
    """Norm-layer factory from the reference's norm strings
    (``bacs_tpu/models/norm.py:188-232``).

    Returns ``f(features, **overrides) -> ABN``.  ``iabn_sync``,
    ``abn_sync``, ``iabr_sync`` and ``abr_sync`` synchronize their
    statistics across ranks, ``iabn``, ``abn``, ``iabr`` and ``abr`` do not,
    and ``bn`` (ReLU, the reference's momentum 3e-4) only with ``sync``
    (the atrous encoder's).  ``fused`` is ``network.fused_abn`` and
    ``fused_stem`` ``network.fused_stem``.
    """
    if norm == "bn":
        cfg = dict(activation="relu", activation_param=0.0, momentum=0.0003)
    elif norm in _LEAKY_NORMS:
        cfg = dict(activation="leaky_relu", activation_param=0.01, renorm=norm in _RENORMS)
        sync = norm.endswith("_sync")
    else:
        raise NotImplementedError(f"Selected Norm {norm} is not supported")
    return functools.partial(ABN, fused=fused, fused_stem=fused_stem, sync=sync, **cfg)
