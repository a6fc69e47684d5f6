"""CPU models of what two CUDA kernels compute, held to the JAX package.

The kernels themselves run only on the card (``tests/test_torch_kernels_cuda.py``);
these tests check, on the CPU, the two facts their designs rest on:

- K12 (``csrc/stem_pool.cu``) pools separably: per input row the first
  strict maximum of the window's three cells, then the three rows compared
  in order with a strict ``>``.  A NumPy model of that scan gives the same
  value and first-max code (ky*3+kx) as the port's ``_pool_codes`` and
  JAX's ``_pool_codes_jnp`` (one strict scan over the nine cells), on
  inputs with ties everywhere and at the edge windows (W = 2, odd H / 2).
- K7 (``csrc/upsample_ce.cuh``, ``UkdTerm``) writes the hand-derived
  gradient g (q0 s_G + q 1[1 <= i < c_old] - p) / c_old of the upsampled
  logits; evaluated in torch and taken back through the two interpolations,
  it equals ``jax.grad`` of ``_ukd_sum_jnp`` on the same pair.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bacs_tpu.ops.stem_pool import _pool_codes_jnp
from bacs_tpu.ops.upsample_ce import _ukd_sum_jnp
from bacs_tpu_torch.ops.stem_pool import _pool_codes
from bacs_tpu_torch.ops.upsample_ce import upsample_plain
from bacs_tpu_torch.ops.upsample_tiles import kmats
from torch_port_helpers import _one_thread  # noqa: F401

NEG = np.float32(-1e30)  # the kernels' padding


def separable_first_max(y: np.ndarray):
    """(max, code) of every 3x3/2 window of NHWC ``y`` (padding 1) as K12
    takes them: each row's first strict max over kx, then the rows in order,
    a row taking over only on a strict >."""
    n, h, w, c = y.shape
    yp = np.pad(y, ((0, 0), (1, 1), (1, 1), (0, 0)), constant_values=NEG)
    best = np.full((n, h // 2, w // 2, c), NEG, np.float32)
    code = np.zeros(best.shape, np.int64)
    for ky in range(3):
        row_best = np.full(best.shape, NEG, np.float32)
        row_kx = np.zeros(best.shape, np.int64)
        for kx in range(3):
            cand = yp[:, ky:ky + h:2, kx:kx + w:2, :]
            take = cand > row_best
            row_best = np.where(take, cand, row_best)
            row_kx = np.where(take, kx, row_kx)
        take = row_best > best
        best = np.where(take, row_best, best)
        code = np.where(take, 3 * ky + row_kx, code)
    return best, code


def _stem_input(shape, seed, levels):
    rs = np.random.RandomState(seed)
    y = rs.randn(*shape).astype(np.float32)
    if levels:  # a few levels: most windows hold their max more than once
        y = np.round(y * levels / 4).astype(np.float32) * np.float32(4.0 / levels)
    return y


@pytest.mark.parametrize("levels", [None, 3, 1], ids=["random", "3-levels", "1-level"])
@pytest.mark.parametrize("shape", [(2, 6, 2, 5), (3, 10, 2, 4), (2, 8, 12, 3), (1, 14, 6, 8),
                                   (1, 2, 6, 2)])
def test_separable_first_max_is_the_scan_of_port_and_jax(shape, levels):
    ties = False
    for seed in range(3):
        y = _stem_input(shape, seed, levels)
        best, code = separable_first_max(y)
        port_best, port_code = _pool_codes(torch.from_numpy(y))
        jax_best, jax_code = _pool_codes_jnp(jnp.asarray(y))
        np.testing.assert_array_equal(best, port_best.numpy())
        np.testing.assert_array_equal(code, port_code.numpy())
        np.testing.assert_array_equal(best, np.asarray(jax_best))
        np.testing.assert_array_equal(code, np.asarray(jax_code))
        if levels:  # windows that hold their max twice: where a last-max scan parts
            yp = np.pad(y, ((0, 0), (1, 1), (1, 1), (0, 0)), constant_values=NEG)
            hits = sum((yp[:, ky:ky + shape[1]:2, kx:kx + shape[2]:2, :] == best).astype(int)
                       for ky in range(3) for kx in range(3))
            ties |= bool((hits > 1).any())
    assert ties or not levels


def ukd_dsem_hand(sem, sem_old, out_hw, g, alpha):
    """The student's gradient of T = sum over pixels of (q0 lse_G +
    sum_{1 <= i < c_old} q_i z_i - lse) / c_old, from the hand-derived
    d T / d z = (q0 s_G + q 1[1 <= i < c_old] - p) / c_old times g, taken
    back through both interpolation matrices."""
    c, c_old = sem.shape[-1], sem_old.shape[-1]
    kh, kw = (torch.from_numpy(k) for k in kmats(sem.shape, out_hw))
    z, u = upsample_plain(sem, out_hw), upsample_plain(sem_old, out_hw)
    ch = torch.arange(c)
    in_g = (ch == 0) | (ch >= c_old)
    old = (ch >= 1) & (ch < c_old)
    p = torch.softmax(z, -1)
    q = torch.softmax(alpha * u, -1)
    e_g = torch.exp(z - z.amax(-1, keepdim=True)) * in_g
    s_g = e_g / e_g.sum(-1, keepdim=True)
    q_full = torch.zeros_like(z)
    q_full[..., :c_old] = q
    dz = (q[..., :1] * s_g + q_full * old - p) / c_old * g
    dsem = torch.einsum("Ww,nHWc->nHwc", kw, dz)
    return torch.einsum("Hh,nHwc->nhwc", kh, dsem)


@pytest.mark.parametrize("alpha", [1.0, 0.7])
@pytest.mark.parametrize("shape,c_old,out_hw", [
    ((2, 4, 5, 6), 5, (13, 17)), ((1, 6, 4, 17), 16, (24, 16)), ((2, 3, 3, 6), 1, (7, 5)),
    ((1, 5, 5, 9), 4, (3, 4))])
def test_ukd_hand_gradient_matches_jax_grad(shape, c_old, out_hw, alpha):
    rs = np.random.RandomState(sum(shape) + c_old)
    sem = (rs.randn(*shape) * 3).astype(np.float32)
    sem_old = (rs.randn(*shape[:3], c_old) * 3).astype(np.float32)
    g = np.float32(-1.0 / (shape[0] * out_hw[0] * out_hw[1]))
    kh, kw = kmats(sem.shape, out_hw)
    ref = jax.grad(lambda s: _ukd_sum_jnp(s, jnp.asarray(sem_old), kh, kw, alpha) * g)(
        jnp.asarray(sem))
    got = ukd_dsem_hand(torch.from_numpy(sem), torch.from_numpy(sem_old), out_hw,
                        float(g), alpha)
    ref, got = np.asarray(ref), got.numpy()
    if c_old == 1:  # G is every channel and q0 = 1: T and its gradient vanish
        assert max(np.abs(got).max(), np.abs(ref).max()) <= 1e-5 * abs(g)
    else:
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
