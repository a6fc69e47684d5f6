"""The bilinear resize's autograd wrapper (``bacs_tpu_torch/ops/
interpolate.py:resize_bilinear``) on the CPU, against
``bacs_tpu.ops.interpolate.resize_bilinear``.

On a CPU tensor the wrapper's forward and backward are the plain versions
(``F.interpolate`` and ``aten.upsample_bilinear2d_backward``); on the card
they are the gather kernels of ``csrc/resize_bilinear.cu``
(``tests/test_torch_kernels_cuda.py`` holds them to ``F.interpolate``).
Here: the values and the gradients (JAX's by ``jax.vjp``) at rtol 1e-5 of
the largest value, with half-pixel centres (the logits' upsample, upsampling
only: ``jax.image.resize`` antialiases a downsample, ``F.interpolate`` does
not) and with aligned corners (the detector's x16 and UNet's x2 upsample,
and a downsample); and the kernels' tables of taps, weights and their
transpose, run through the kernels' arithmetic in numpy, against the plain
version's values and gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bacs_tpu.ops.interpolate import resize_bilinear as jax_resize
from bacs_tpu_torch.ops import interpolate
from torch_port_helpers import _one_thread  # noqa: F401

CASES = [
    ((2, 4, 5, 3), (64, 80), True),    # the detector's x16
    ((2, 6, 6, 4), (12, 12), True),    # a UNet decoder stage's x2
    ((1, 3, 3, 2), (1, 7), True),      # a single output row
    ((2, 9, 7, 4), (5, 3), True),      # a downsample
    ((2, 4, 4, 5), (64, 64), False),   # the logits' x16
    ((1, 5, 7, 3), (12, 17), False),   # a non-integer scale
]


def close(got, ref, rtol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()))


@pytest.mark.parametrize("shape,size,align", CASES)
def test_values_and_gradients_match_jax(shape, size, align):
    rs = np.random.RandomState(sum(shape))
    x = rs.randn(*shape).astype(np.float32)
    g = rs.randn(shape[0], *size, shape[-1]).astype(np.float32)
    ref, vjp = jax.vjp(lambda t: jax_resize(t, size, align_corners=align), jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = interpolate.resize_bilinear(xt, size, align_corners=align)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    assert y.shape == (shape[0], *size, shape[-1]) and dx.shape == xt.shape
    close(y.detach().numpy(), ref)
    close(dx.numpy(), ref_dx)


def _kernel_arithmetic(x, g, size, align):
    """The kernels' forward and two-pass backward in numpy f32, from the
    wrapper's tables."""
    n, h, w, c = x.shape
    H, W = size
    ytab, ylam, yoff, ysrc, yw = (t.numpy() for t in interpolate._tables(h, H, align, "cpu"))
    xtab, xlam, xoff, xsrc, xw = (t.numpy() for t in interpolate._tables(w, W, align, "cpu"))
    top = (xlam[0][None, None, :, None] * x[:, ytab[0]][:, :, xtab[0]]
           + xlam[1][None, None, :, None] * x[:, ytab[0]][:, :, xtab[1]])
    bot = (xlam[0][None, None, :, None] * x[:, ytab[1]][:, :, xtab[0]]
           + xlam[1][None, None, :, None] * x[:, ytab[1]][:, :, xtab[1]])
    out = ylam[0][None, :, None, None] * top + ylam[1][None, :, None, None] * bot
    t = np.zeros((n, H, w, c), np.float32)
    for ix in range(w):
        for k in range(xoff[ix], xoff[ix + 1]):
            t[:, :, ix] += xw[k] * g[:, :, xsrc[k]]
    dx = np.zeros((n, h, w, c), np.float32)
    for iy in range(h):
        for k in range(yoff[iy], yoff[iy + 1]):
            dx[:, iy] += yw[k] * t[:, ysrc[k]]
    return out, dx


@pytest.mark.parametrize("shape,size,align", CASES)
def test_kernel_tables_reproduce_the_plain_version(shape, size, align):
    """Every output index has two taps whose weights sum to 1, every
    (output, tap) pair appears once in the transpose, and the kernels'
    sums over the tables give the plain version's values and gradients."""
    rs = np.random.RandomState(7)
    x = rs.randn(*shape).astype(np.float32)
    g = rs.randn(shape[0], *size, shape[-1]).astype(np.float32)
    for n_in, n_out in ((shape[1], size[0]), (shape[2], size[1])):
        tab, lam, off, src, wgt = interpolate._tables(n_in, n_out, align, "cpu")
        assert tab.shape == lam.shape == (2, n_out) and off.shape == (n_in + 1,)
        assert bool((tab >= 0).all()) and bool((tab < n_in).all())
        torch.testing.assert_close(lam.sum(0), torch.ones(n_out), rtol=0, atol=1e-6)
        assert int(off[-1]) == src.numel() == wgt.numel() == 2 * n_out
        assert sorted(src.tolist()) == sorted(list(range(n_out)) * 2)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = interpolate.resize_bilinear(xt, size, align_corners=align)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    out, kdx = _kernel_arithmetic(x, g, size, align)
    close(out, y.detach().numpy(), rtol=1e-6)
    close(kdx, dx.numpy(), rtol=1e-6)


def test_same_size_passes_through_and_cpu_wrappers_are_plain():
    x = torch.randn(1, 4, 4, 2)
    assert interpolate.resize_bilinear(x, (4, 4)) is x
    before = interpolate.resize_fwd.launches, interpolate.resize_grad.launches
    xt = x.clone().requires_grad_(True)
    interpolate.resize_bilinear(xt, (8, 8)).sum().backward()
    assert (interpolate.resize_fwd.launches, interpolate.resize_grad.launches) == before
