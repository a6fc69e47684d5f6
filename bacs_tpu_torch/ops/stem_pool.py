"""Fused stem: train-mode ABN apply + leaky-ReLU + 3x3/2 max-pool (K12).

Port of ``bacs_tpu/ops/stem_pool.py``.  The ResNet stem's ABN in train mode
(``network.fused_stem``) normalises its conv output with the batch
statistics, activates it and max-pools it 3x3/2 with padding 1; fused, the
full-resolution activation is never written and the backward keeps only
the conv output ``c`` and the pooled ``p``.

- :func:`fused_abn_pool` is the ``torch.autograd.Function`` (the JAX
  ``custom_vjp``, ``stem_pool.py:394-481``): the f32 batch mean and mean of
  squares (squares in c's dtype), then the pooling pass, returning
  (p, mean, var).  Its backward takes ``dap`` (dp through the leaky slope at
  each window's max), ``dscale = sum(dap * x_hat_max)`` and ``dbias =
  sum(dap)`` outside the kernel, ``x_hat_max`` recovered from ``p`` by
  inverting the leaky and the affine (``:437-478``), then the gather pass.
- :func:`stem_pool_fwd` and :func:`stem_pool_grad` are the two passes'
  wrappers.  A CUDA tensor launches the hand-written kernel of
  ``csrc/stem_pool.cu`` (replacing ``_fwd_pallas``, ``stem_pool.py:232``,
  and ``_bwd_pallas``, ``:338``) or raises; a CPU tensor takes the plain
  version.  Each wrapper's ``launches`` counts its kernel launches.
- :func:`stem_pool_plain` and :func:`stem_pool_grad_plain` are the plain
  versions: y = leaky(c * a + b) in f32 from ``a`` and ``b`` rounded to c's
  dtype (the TPU kernel's arithmetic), the window's first max (scan order
  ky*3+kx, strict >, padding -1e30), and for the backward each window's
  ``dap`` added to its argmax cell in that scan order, then ``dc = g * da -
  g_mean_da - g_mean_da_xhat * (c - mean) * inv`` in f32 from vectors
  rounded to c's dtype.

Pool semantics match a 3x3/2 max-pool with padding 1 on even H and W; the
ABN module takes this path only then (``models/norm.py``).  Bound on the
H100 and the kernels' tolerance: see ``csrc/stem_pool.cu``.  Cross-GPU
statistics (the JAX ``axis_name``) are ROADMAP.md queue 1 item 10.
"""

from __future__ import annotations

import torch

from bacs_tpu_torch.kernels import build
from bacs_tpu_torch.ops.abn_core import _safe_scale

_NEG = -1e30  # the padding value of the JAX kernel


def _activate(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor, slope: float):
    y = c.float() * a + b
    return torch.where(y >= 0, y, y * slope)


def _pool_codes(y: torch.Tensor):
    """3x3/2 max of f32 NHWC ``y`` and each window's first-max code ky*3+kx
    (``_pool_codes_jnp``, ``stem_pool.py:53-65``)."""
    n, h, w, c = y.shape
    yp = torch.nn.functional.pad(y, (0, 0, 1, 1, 1, 1), value=_NEG)
    best = torch.full((n, h // 2, w // 2, c), _NEG, dtype=y.dtype, device=y.device)
    code = torch.zeros(best.shape, dtype=torch.int64, device=y.device)
    for ky in range(3):
        for kx in range(3):
            cand = yp[:, ky:ky + h:2, kx:kx + w:2, :]
            take = cand > best  # strict: the first max wins
            best = torch.where(take, cand, best)
            code = torch.where(take, ky * 3 + kx, code)
    return best, code


def stem_pool_plain(c: torch.Tensor, vec: torch.Tensor, slope: float) -> torch.Tensor:
    """Plain forward: ``vec`` is f32 [2, C] (a, b), rounded to c's dtype."""
    best, _ = _pool_codes(_activate(c, vec[0], vec[1], slope))
    return best.to(c.dtype)


def stem_pool_grad_plain(c: torch.Tensor, dap: torch.Tensor, vec: torch.Tensor,
                         slope: float) -> torch.Tensor:
    """Plain gather backward: ``vec`` is f32 [7, C] (a, b, g, g_mean_da,
    g_mean_da_xhat, mean, inv), rounded to c's dtype."""
    n, h, w, ch = c.shape
    _, code = _pool_codes(_activate(c, vec[0], vec[1], slope))
    d = dap.float()
    da = torch.zeros((n, h + 2, w + 2, ch), dtype=torch.float32, device=c.device)
    for k in range(9):  # each window's dap to its argmax cell, in scan order
        ky, kx = divmod(k, 3)
        da[:, ky:ky + h:2, kx:kx + w:2, :] += torch.where(code == k, d, 0.0)
    da = da[:, 1:h + 1, 1:w + 1, :]
    g, gmda, gmdax, mean, inv = vec[2:]
    x_hat = (c.float() - mean) * inv
    return (g * da - gmda - gmdax * x_hat).to(c.dtype)


def _check(name: str, c: torch.Tensor, vec: torch.Tensor, rows: int, dap=None) -> None:
    if c.device.type != "cuda":
        raise ValueError(f"kernel needs a CUDA tensor, got {c.device}")
    if c.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: c must be float32 or bfloat16, got {c.dtype}")
    if c.dim() != 4 or not c.is_contiguous():
        raise ValueError(f"{name}: c must be a contiguous [n, H, W, C] tensor")
    n, h, w, ch = c.shape
    if h % 2 or w % 2:
        raise ValueError(f"{name}: H and W must be even, got {tuple(c.shape)}")
    if (vec.shape != (rows, ch) or vec.dtype != torch.float32
            or vec.device != c.device or not vec.is_contiguous()):
        raise ValueError(f"{name}: vec must be a contiguous float32 [{rows}, {ch}] "
                         f"tensor on {c.device}")
    if dap is not None and (dap.shape != (n, h // 2, w // 2, ch) or dap.dtype != c.dtype
                            or dap.device != c.device or not dap.is_contiguous()):
        raise ValueError(f"{name}: dap must be a contiguous {c.dtype} "
                         f"[{n}, {h // 2}, {w // 2}, {ch}] tensor on {c.device}")


def stem_pool_fwd(c: torch.Tensor, vec: torch.Tensor, slope: float) -> torch.Tensor:
    """p = maxpool3x3/2(leaky(c * a + b)) of NHWC ``c``; ``vec`` = (a, b)."""
    if c.device.type == "cpu":
        return stem_pool_plain(c, vec, slope)
    _check("stem_pool_fwd", c, vec, 2)
    n, h, w, ch = c.shape
    p = torch.empty((n, h // 2, w // 2, ch), dtype=c.dtype, device=c.device)
    lib = build.load_library()
    with torch.cuda.device(c.device):
        code = lib.stem_pool_fwd(
            c.data_ptr(), int(c.dtype == torch.bfloat16), vec.data_ptr(), float(slope),
            n, h, w, ch, p.data_ptr(), torch.cuda.current_stream().cuda_stream)
    build.check(code, "stem_pool_fwd")
    stem_pool_fwd.launches += 1
    return p


stem_pool_fwd.launches = 0


def stem_pool_grad(c: torch.Tensor, dap: torch.Tensor, vec: torch.Tensor,
                   slope: float) -> torch.Tensor:
    """dc of the fused stem, given ``dap`` and the seven vectors ``vec``."""
    if c.device.type == "cpu":
        return stem_pool_grad_plain(c, dap, vec, slope)
    _check("stem_pool_grad", c, vec, 7, dap)
    n, h, w, ch = c.shape
    dc = torch.empty_like(c)
    lib = build.load_library()
    with torch.cuda.device(c.device):
        code = lib.stem_pool_grad(
            c.data_ptr(), dap.data_ptr(), int(c.dtype == torch.bfloat16), vec.data_ptr(),
            float(slope), n, h, w, ch, dc.data_ptr(), torch.cuda.current_stream().cuda_stream)
    build.check(code, "stem_pool_grad")
    stem_pool_grad.launches += 1
    return dc


stem_pool_grad.launches = 0


def _rounded(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """f32 values of ``v`` rounded to ``dtype`` (the JAX kernel's inputs)."""
    return v.to(dtype).float()


def forward_vectors(c: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5):
    """(mean, var, inv, vec) of the forward (``_fwd_impl``, ``stem_pool.py:
    408-425``): the f32 batch mean and mean of squares of NHWC ``c`` (squares
    in c's dtype, as the JAX function), the biased variance, its rsqrt, and
    ``vec`` = [a, b] [2, C], the folded affine rounded to c's dtype."""
    dims = (0, 1, 2)
    mean = torch.mean(c, dims, dtype=torch.float32)
    mean_sq = torch.mean(c * c, dims, dtype=torch.float32)
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    a = _rounded(inv * scale, c.dtype)
    b = _rounded(bias - mean * inv * scale, c.dtype)
    return mean, var, inv, torch.stack([a, b])


def backward_vectors(c, p, dp, scale, bias, mean, inv, vec, slope):
    """(dap, vec7, dscale, dbias) of the backward outside the kernel
    (``_fused_abn_pool_bwd``, ``stem_pool.py:437-478``): ``dap`` is dp
    through the leaky slope at each window's max; x_hat at the max is
    recovered from p by inverting the leaky and the affine; ``vec7`` =
    [a, b, g, g_mean_da, g_mean_da_xhat, mean, inv] rounded to c's dtype."""
    dt = c.dtype
    n = c.numel() // c.shape[-1]
    dims = (0, 1, 2)
    pos = p >= 0
    dap = torch.where(pos, dp, dp * slope).to(dt).contiguous()
    z = torch.where(pos, p, p * (1.0 / slope))
    x_hat_max = (z - bias.to(dt)) * (1.0 / _safe_scale(scale)).to(dt)
    sum_da = torch.sum(dap, dims, dtype=torch.float32)
    sum_da_xhat = torch.sum(dap * x_hat_max, dims, dtype=torch.float32)
    g = scale * inv
    vec7 = torch.cat([vec, torch.stack([
        _rounded(g, dt), _rounded(g * (sum_da / n), dt), _rounded(g * (sum_da_xhat / n), dt),
        _rounded(mean, dt), _rounded(inv, dt)])])
    return dap, vec7, sum_da_xhat, sum_da


class _FusedAbnPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, c, scale, bias, eps, slope):
        mean, var, inv, vec = forward_vectors(c, scale, bias, eps)
        p = stem_pool_fwd(c, vec, slope)
        ctx.save_for_backward(c, p, scale, bias, mean, inv, vec)
        ctx.slope = slope
        ctx.mark_non_differentiable(mean, var)
        return p, mean, var

    @staticmethod
    def backward(ctx, dp, _dmean, _dvar):
        c, p, scale, bias, mean, inv, vec = ctx.saved_tensors
        dap, vec7, dscale, dbias = backward_vectors(c, p, dp, scale, bias, mean, inv, vec,
                                                    ctx.slope)
        return stem_pool_grad(c, dap, vec7, ctx.slope), dscale, dbias, None, None


def fused_abn_pool(c: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-5, slope: float = 0.01):
    """(pooled, batch mean, batch var) = maxpool3x3/2(leaky(BN(c))) of NHWC
    ``c`` with even H and W; the statistics f32 and not differentiable."""
    return _FusedAbnPool.apply(c, scale, bias, float(eps), float(slope))
