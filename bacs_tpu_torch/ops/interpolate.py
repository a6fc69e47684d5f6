"""Resize primitives matching the JAX package's, NHWC.

Port of ``bacs_tpu/ops/interpolate.py``: bilinear with half-pixel centres
(the logit upsampling, ``NetOutput.logits``), bilinear with aligned corners
(the background detector's x16 upsample), and nearest with
src = floor(dst * in / out) (the prototypes' label downsample).

:func:`resize_bilinear` is a ``torch.autograd.Function`` over two wrappers,
:func:`resize_fwd` and :func:`resize_grad`.  On a CPU tensor each runs the
plain version, ``F.interpolate`` and its own backward
(``aten.upsample_bilinear2d_backward``).  On a CUDA tensor each launches its
hand-written kernel of ``csrc/resize_bilinear.cu`` or raises: the forward
gathers four taps per output element, and the backward gathers each input
element's output footprint in a fixed order, with no atomics, so two runs
on the card give the same bits (``F.interpolate``'s CUDA backward
accumulates with float atomics).  The kernels take tables of taps and
weights computed once per (input size, output size, mode) as PyTorch
computes them, and their transposes.  Each wrapper's ``launches`` counts
its launches.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bacs_tpu_torch.kernels import build


def _taps(n_in: int, n_out: int, align_corners: bool):
    """Per output index: the two source indices and their weights, in f32
    as PyTorch's ``area_pixel_compute_scale`` and
    ``area_pixel_compute_source_index`` compute them."""
    f32 = np.float32
    dst = np.arange(n_out, dtype=f32)
    if align_corners:
        scale = f32(n_in - 1) / f32(n_out - 1) if n_out > 1 else f32(0)
        src = (f32(scale) * dst).astype(f32)
    else:
        scale = f32(n_in) / f32(n_out)
        src = (f32(scale) * (dst + f32(0.5)) - f32(0.5)).astype(f32)
        src = np.maximum(src, f32(0))
    i0 = src.astype(np.int64)
    i1 = np.where(i0 < n_in - 1, i0 + 1, i0)
    lam1 = (src - i0.astype(f32)).astype(f32)
    lam0 = (f32(1) - lam1).astype(f32)
    return i0, i1, lam0, lam1


@functools.lru_cache(maxsize=None)
def _tables(n_in: int, n_out: int, align_corners: bool, device: str):
    """(forward taps int32 [2, out], weights f32 [2, out], and the
    transpose: offsets int32 [in + 1], output indices int32, weights f32),
    on ``device``.  The transpose lists each input index's (output index,
    weight) pairs in order of the output index, the first tap first."""
    i0, i1, lam0, lam1 = _taps(n_in, n_out, align_corners)
    src = np.stack([i0, i1], 1).reshape(-1)
    dst = np.repeat(np.arange(n_out), 2)
    wgt = np.stack([lam0, lam1], 1).reshape(-1)
    order = np.argsort(src, kind="stable")
    offsets = np.searchsorted(src[order], np.arange(n_in + 1), side="left")
    as_t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)  # noqa: E731
    return (as_t(np.stack([i0, i1]), torch.int32), as_t(np.stack([lam0, lam1]), torch.float32),
            as_t(offsets, torch.int32), as_t(dst[order], torch.int32),
            as_t(wgt[order], torch.float32))


def _check(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: expected float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous [N, H, W, C] tensor")


def resize_fwd(x: torch.Tensor, size: Tuple[int, int], align_corners: bool) -> torch.Tensor:
    """Bilinear resize of NHWC ``x`` to ``size``: the plain version on the
    CPU, ``csrc/resize_bilinear.cu`` on the card."""
    if x.device.type == "cpu":
        y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                          align_corners=align_corners)
        return y.permute(0, 2, 3, 1)
    _check("resize_fwd", x)
    n, h, w, c = x.shape
    H, W = size
    ytab, ylam, *_ = _tables(h, H, align_corners, str(x.device))
    xtab, xlam, *_ = _tables(w, W, align_corners, str(x.device))
    out = torch.empty((n, H, W, c), dtype=x.dtype, device=x.device)
    lib = build.load_library()
    with torch.cuda.device(x.device):
        code = lib.resize_bilinear_fwd(
            x.data_ptr(), int(x.dtype == torch.bfloat16), n, h, w, c, H, W, ytab.data_ptr(),
            ylam.data_ptr(), xtab.data_ptr(), xlam.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(code, "resize_bilinear_fwd")
    resize_fwd.launches += 1
    return out


resize_fwd.launches = 0


def resize_grad(g: torch.Tensor, in_hw: Tuple[int, int], align_corners: bool) -> torch.Tensor:
    """The input's gradient of :func:`resize_fwd` given the output's ``g``
    [N, H, W, C]: the plain version on the CPU, the gather kernels on the
    card."""
    n, H, W, c = g.shape
    h, w = in_hw
    if g.device.type == "cpu":
        dx = torch.ops.aten.upsample_bilinear2d_backward(
            g.permute(0, 3, 1, 2), [H, W], [n, c, h, w], align_corners, None, None)
        return dx.permute(0, 2, 3, 1)
    _check("resize_grad", g)
    _, _, yoff, ysrc, yw = _tables(h, H, align_corners, str(g.device))
    _, _, xoff, xsrc, xw = _tables(w, W, align_corners, str(g.device))
    t = torch.empty((n, H, w, c), dtype=torch.float32, device=g.device)
    dx = torch.empty((n, h, w, c), dtype=g.dtype, device=g.device)
    lib = build.load_library()
    with torch.cuda.device(g.device):
        code = lib.resize_bilinear_grad(
            g.data_ptr(), int(g.dtype == torch.bfloat16), n, h, w, c, H, W, yoff.data_ptr(),
            ysrc.data_ptr(), yw.data_ptr(), xoff.data_ptr(), xsrc.data_ptr(), xw.data_ptr(),
            t.data_ptr(), dx.data_ptr(), torch.cuda.current_stream().cuda_stream)
    build.check(code, "resize_bilinear_grad")
    resize_grad.launches += 1
    return dx


resize_grad.launches = 0


class _ResizeBilinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, size, align_corners):
        ctx.in_hw = tuple(x.shape[1:3])
        ctx.align_corners = align_corners
        if x.device.type == "cuda":
            x = x.contiguous()
        return resize_fwd(x, size, align_corners)

    @staticmethod
    def backward(ctx, g):
        if g.device.type == "cuda":
            g = g.contiguous()
        return resize_grad(g, ctx.in_hw, ctx.align_corners), None, None


def resize_bilinear(
    x: torch.Tensor, size: Tuple[int, int], align_corners: bool = False
) -> torch.Tensor:
    """Bilinear resize of [N, H, W, C] to [N, size[0], size[1], C]:
    half-pixel centres (``align_corners=False``, the reference's logit
    upsampling) or src = dst * (in - 1) / (out - 1) (``align_corners=True``,
    the background detector's, ``bacs_tpu/ops/interpolate.py:32-54``)."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    return _ResizeBilinear.apply(x, tuple(size), align_corners)


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of [N, H, W] label maps or [N, H, W, C] tensors:
    src = floor(dst * in / out) in float32, as the JAX function
    (``bacs_tpu/ops/interpolate.py:57-80``), so the two pick the same
    source pixels."""
    h, w = x.shape[1:3]
    oh, ow = size
    if (h, w) == (oh, ow):
        return x
    ar = lambda n: torch.arange(n, dtype=torch.float32, device=x.device)  # noqa: E731
    ys = torch.floor(ar(oh) * (h / oh)).long().clamp(0, h - 1)
    xs = torch.floor(ar(ow) * (w / ow)).long().clamp(0, w - 1)
    return x[:, ys][:, :, xs]
