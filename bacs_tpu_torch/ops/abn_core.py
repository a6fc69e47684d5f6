"""ABN: batch norm fused with leaky-ReLU, in eval and train mode.

Port of ``fused_abn_eval`` (``bacs_tpu/ops/abn_core.py:131``) and of the TPU
kernel it names, ``abn_apply_pallas`` (``bacs_tpu/ops/abn_pallas.py:45``,
pallas_call at :67).  In the port every eval-mode ABN layer goes through
:func:`fused_abn_eval`: 107 launches per ResNet-101 DeepLabV3 forward.
Train mode is :func:`fused_abn` (``bacs_tpu/ops/abn_core.py:52-128``), whose
apply is the same Triton kernel fed the batch statistics (see its
docstring).

- :func:`abn_eval_plain`: ``(x - mean) * (rsqrt(var + eps) * scale) + bias``,
  then leaky with ``slope`` (1 = identity, 0 = ReLU), computed in f32 and
  stored in the input dtype.  The CPU path and the kernel's reference.
- :func:`fused_abn_eval`: the wrapper.  A CUDA tensor launches the Triton
  kernel below or raises; a CPU tensor runs the plain version.  Its
  ``launches`` attribute counts kernel launches.

The kernel views the channels-last input as ``[rows, C]`` and walks masked 2-D
blocks (rows x channels), so every channel count and row count is taken,
the [N, 1, 1, 256] global-pool tensor and C = 64 included (the TPU kernel
sent those to jnp, ``abn_pallas.py:55-59``).  The [C] vectors are read once
per block and ``rsqrt`` is taken in the kernel, so one launch does the
whole layer.

Bound on the H100: device-memory bandwidth, one read and one write of every
element.  The largest layer of the serving forward at batch 16, the stem's
[16, 256, 256, 64] in bf16, moves 2 x 134 MB: at least 80 us at the
published 3.35 TB/s.  The arithmetic is a subtract, an FMA and a select per
element, far below the card's rate.  Measured on an NVIDIA H100 80GB HBM3
at 700 W: 2.1 ms of device time for the 107 layers of a batch-16 forward
(2.6-2.9 TB/s on the large layers), against 36 ms for the plain version;
launched from Python each call also costs ~45 us of host time (PERF.md).

Tolerance against the plain version: f32 within rtol = atol = 1e-5 (the
kernel's ``rsqrt`` is the hardware approximation); bf16 within one bf16 ulp
(rtol 8e-3) and the same atol 1e-5, which covers results near 0 where the
f32 terms cancel and the two f32 roundings differ by ~1e-8.
"""

from __future__ import annotations

import functools

import torch

tl = None  # triton.language, bound at the first launch (CPU builds lack triton)


def abn_eval_plain(
    x: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    eps: float = 1e-5,
    slope: float = 0.01,
) -> torch.Tensor:
    """Plain version over the last (channel) axis of ``x``."""
    a = torch.rsqrt(var.float() + eps) * scale.float()
    y = (x.float() - mean.float()) * a + bias.float()
    return torch.where(y >= 0, y, y * slope).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _abn_eval_kernel():
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def abn_eval_kernel(
        x_ptr, y_ptr, mean_ptr, var_ptr, scale_ptr, bias_ptr,
        rows, C, eps, slope,
        BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr,
    ):
        r = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        c = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = c < C
        mean = tl.load(mean_ptr + c, mask=cmask, other=0.0)
        var = tl.load(var_ptr + c, mask=cmask, other=1.0)
        scale = tl.load(scale_ptr + c, mask=cmask, other=0.0)
        bias = tl.load(bias_ptr + c, mask=cmask, other=0.0)
        a = tl.rsqrt(var + eps) * scale
        offs = r.to(tl.int64)[:, None] * C + c[None, :]
        mask = (r < rows)[:, None] & cmask[None, :]
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        y = (x - mean[None, :]) * a[None, :] + bias[None, :]
        y = tl.where(y >= 0, y, y * slope)
        tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

    return abn_eval_kernel


def _abn_apply_triton(x, mean, var, scale, bias, eps, slope, counter):
    """Launch the kernel on a CUDA tensor; ``counter.launches`` counts it."""
    if x.device.type != "cuda":
        raise ValueError(f"kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() < 1 or not x.is_contiguous():
        raise ValueError("x must be contiguous with channels on the last axis")
    c = x.shape[-1]
    for name, v in (("mean", mean), ("var", var), ("scale", scale),
                    ("bias", bias)):
        if (v.shape != (c,) or v.dtype != torch.float32
                or v.device != x.device or not v.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous float32 [{c}] tensor on "
                f"{x.device}, got {v.dtype} {tuple(v.shape)} on {v.device}"
            )
    y = torch.empty_like(x)
    rows = x.numel() // c if c else 0
    if rows == 0:
        return y
    block_c = min(128, 1 << (c - 1).bit_length())  # power of two, as Triton needs
    block_r = 4096 // block_c
    grid = (-(-rows // block_r), -(-c // block_c))
    with torch.cuda.device(x.device):
        _abn_eval_kernel()[grid](
            x, y, mean, var, scale, bias, rows, c, float(eps), float(slope),
            BLOCK_R=block_r, BLOCK_C=block_c, num_warps=4,
        )
    counter.launches += 1
    return y


def fused_abn_eval(
    x: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    eps: float = 1e-5,
    slope: float = 0.01,
) -> torch.Tensor:
    """Inference ABN over the last axis of ``x`` (channels last), one pass.

    CPU tensors take the plain version, CUDA tensors the Triton kernel.
    """
    if x.device.type == "cpu":
        return abn_eval_plain(x, mean, var, scale, bias, eps, slope)
    return _abn_apply_triton(x, mean, var, scale, bias, eps, slope, fused_abn_eval)


fused_abn_eval.launches = 0


# ---------------------------------------------------------------- train mode


def _safe_scale(scale: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Sign-preserving clamp of ``scale`` away from 0: the backward divides
    by it, and weight decay can drive it through 0 (``abn_core.py:38``)."""
    mag = scale.abs().clamp_min(eps)
    return torch.where(scale < 0, -mag, mag)


class _FusedABN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps, slope):
        dims = tuple(range(x.dim() - 1))
        rows = x.numel() // x.shape[-1]
        mean = torch.mean(x, dims, dtype=torch.float32)
        # squares in x's dtype, accumulated in f32, as the JAX function does
        mean_sq = torch.mean(x * x, dims, dtype=torch.float32)
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        if x.device.type == "cpu":
            y = abn_eval_plain(x, mean, var, scale, bias, eps, slope)
        else:
            y = _abn_apply_triton(x, mean, var, scale.contiguous(),
                                  bias.contiguous(), eps, slope, fused_abn)
        # residuals: the OUTPUT and [C] vectors only; x is not saved
        ctx.save_for_backward(y, scale, bias, torch.rsqrt(var + eps))
        ctx.slope, ctx.rows = slope, rows
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        y, scale, bias, inv = ctx.saved_tensors
        slope, rows, dt = ctx.slope, ctx.rows, y.dtype
        dims = tuple(range(y.dim() - 1))
        dy = dy.contiguous()
        # recover x_hat from the output, in the activation dtype
        pos = y >= 0
        safe = _safe_scale(scale)
        z = torch.where(pos, y, y * (1.0 / slope))
        x_hat = torch.addcmul((-bias / safe).to(dt), z, (1.0 / safe).to(dt))
        da = torch.where(pos, dy, dy * slope)
        sum_da = torch.sum(da, dims, dtype=torch.float32)
        sum_da_xhat = torch.sum(da * x_hat, dims, dtype=torch.float32)
        g = (scale * inv).to(dt)
        dx = g * (da - (sum_da / rows).to(dt)) - (g * (sum_da_xhat / rows).to(dt)) * x_hat
        return dx, sum_da_xhat, sum_da, None, None


def fused_abn(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    eps: float = 1e-5,
    slope: float = 0.01,
):
    """Train-mode ABN over the last axis of ``x`` -> (y, batch mean, batch
    var), the statistics f32 and not differentiable.

    Port of ``fused_abn`` (``bacs_tpu/ops/abn_core.py:52-128``) on one
    device.  Forward: the f32 batch mean and mean of squares, biased
    ``var = max(E[x^2] - mean^2, 0)``, then the apply and leaky with
    ``slope`` (1 = identity).  The apply is K5's Triton kernel fed the batch
    statistics (it computes the same function), counted on this function's
    own ``launches``: 107 per ResNet-101 DeepLabV3 train forward; CPU
    tensors take :func:`abn_eval_plain`.  Backward: the in-place-ABN
    inversion; only ``y`` and the [C] vectors are saved, and x_hat is
    recovered from ``y`` (``abn_core.py:96-125``).  The statistics and the
    backward are plain PyTorch ops (ROADMAP.md queue 2, note A).
    """
    return _FusedABN.apply(x, scale, bias, float(eps), float(slope))


fused_abn.launches = 0
