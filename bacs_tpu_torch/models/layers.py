"""Transformer decoder blocks for TranSeg.

Port of ``bacs_tpu/models/layers.py`` (``Attention``, ``Block``,
``_drop_path``): pre-LayerNorm multi-head self-attention and an exact-erf
GELU MLP, each on a residual branch with stochastic depth.  Submodule names
are the Flax module names (``norm1``, ``attn.qkv``, ``attn.proj``,
``norm2``, ``mlp_fc1``, ``mlp_fc2``), so a Flax variable path is a
state_dict key (``utils/flax_weights.py``).

Dtypes follow Flax's promotion under mixed precision: each :class:`Linear`
computes in its ``compute_dtype`` on weights of any dtype (as a Flax
``nn.Dense(dtype=...)`` does, and ``models/resnet.py:Conv2d`` for
convolutions); the LayerNorms return float32; the residual stream stays
float32.  The attention is a plain matrix product and softmax, the softmax
in float32 and cast back to the input's dtype before it weighs the values,
as ``bacs_tpu/models/layers.py:32-36`` computes it outside any Pallas
kernel.

Stochastic depth draws its masks from the keys Flax's ``make_rng`` gives
the block's scope (``ops/rng.scope_key``);
the shipped TranSeg head sets its rate to 0.  The Flax blocks' dropout is
not ported: no module of the JAX package sets a rate other than 0.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from bacs_tpu_torch.ops import rng


class Linear(nn.Linear):
    """``nn.Linear`` that computes in ``compute_dtype`` whatever dtype its
    parameters hold (``None``: the weight's dtype); autograd casts the
    gradients back to the parameters' dtype."""

    compute_dtype = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def _drop_path(x: torch.Tensor, rate: float, train: bool,
               key: Optional[rng.Key] = None) -> torch.Tensor:
    """Stochastic depth: the whole branch of a sample is dropped with
    probability ``rate`` (reference: networks/utils.py DropPath), its mask
    drawn from ``key``."""
    if rate == 0.0 or not train:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = rng.bernoulli(rng.given(key), keep, shape, x.device)
    return x * mask / keep


class Attention(nn.Module):
    """Multi-head self-attention over [B, N, D] tokens."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        hd = self.dim // self.heads
        # the 3 D outputs split as [3, heads, head_dim] (layers.py:31)
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # [b, n, h, d]
        attn = torch.einsum("bnhd,bmhd->bhnm", q, k) * hd ** -0.5
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        # an f32 map weighs bf16 values in f32, as JAX promotes the pair
        dt = torch.promote_types(attn.dtype, v.dtype)
        y = torch.einsum("bhnm,bmhd->bnhd", attn.to(dt), v.to(dt)).reshape(b, n, c)
        return self.proj(y)


class Block(nn.Module):
    """Pre-LN transformer block: x + attn(LN(x)), then x + MLP(LN(x))."""

    def __init__(self, dim: int, heads: int, mlp_dim: int, drop_path: float = 0.0):
        super().__init__()
        self.drop_path = drop_path
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)  # torch's eps, as Flax is given
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp_fc1 = Linear(dim, mlp_dim)
        self.mlp_fc2 = Linear(mlp_dim, dim)

    def forward(self, x: torch.Tensor, key: Optional[rng.Key] = None,
                scope: Tuple[str, ...] = ()) -> torch.Tensor:
        """``key`` is the forward's dropout key and ``scope`` this block's
        Flax module path: the two stochastic-depth masks take the scope's
        first and second ``make_rng`` keys, as JAX's ``_drop_path`` does."""
        train = self.training
        keys = (None, None) if key is None else (
            rng.scope_key(key, scope, 1), rng.scope_key(key, scope, 2))
        y = self.attn(self.norm1(x.float()))
        x = x + _drop_path(y, self.drop_path, train, keys[0])
        y = self.mlp_fc1(self.norm2(x.float()))
        y = self.mlp_fc2(F.gelu(y, approximate="none"))  # exact erf (layers.py:63)
        return x + _drop_path(y, self.drop_path, train, keys[1])
