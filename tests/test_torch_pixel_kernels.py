"""CPU models of the per-pixel template's three kernels, held to the JAX package.

K10 (serving argmax + confidence) and K9 (PLOP's pseudo-labels) run
``pixel_kernel`` of ``bacs_tpu_torch/csrc/upsample_stage.cuh``, and K2
(the eval step's confusion matrix) its own kernel on the same staged
layout, on the card only (``tests/test_torch_kernels_cuda.py``); these
tests check, on the CPU, the facts their designs rest on:

- The chunked scan.  A pixel's channels are W-lerped from the stage in
  chunks of KC; each chunk's max is taken first, its argmax is the first k
  with v[k] == that max, and a later chunk takes the argmax over only on a
  strict >; then the chunk's exponentials, the running sum rescaled once
  per chunk past the first.  A torch model of that scan, on the staged
  taps of ``launch_plan``'s tables, gives the preds and the confidence of
  JAX's ``upsampled_argmax_conf`` (its jnp path on the CPU), ties inside a
  chunk and across a chunk boundary included.
- The one-pass entropy of K9: the same scan, r = 1 / s once, p = e r and
  the sum of p log(p + 1e-8) with the logarithm in base 2 times ln 2,
  gives the labels, num and den of JAX's ``upsampled_plop_pseudo_labels``
  (``_plop_pseudo_jnp``), at thresholds set clear of every pixel's entropy.
- K2's argmax-only scan (the same tie rule, no exponentials, the
  channels padded with NaN to whole chunks) and its integer bins (one
  count per kept pixel at t * nc + min(pred, nc - 1)) give the matrix of
  JAX's ``upsampled_confusion`` (its jnp path on the CPU) exactly.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bacs_tpu.ops.upsample_argmax import upsampled_argmax_conf as jax_argmax_conf
from bacs_tpu.ops.upsample_confusion import upsampled_confusion as jax_confusion
from bacs_tpu.ops.upsample_ce import _kmats
from bacs_tpu.ops.upsample_ce import upsampled_plop_pseudo_labels as jax_pseudo
from bacs_tpu_torch.ops.losses import pixel_entropy
from bacs_tpu_torch.ops.upsample_ce import tap_tables
from torch_port_helpers import _one_thread  # noqa: F401


def staged_upsample(sem: torch.Tensor, out_hw) -> torch.Tensor:
    """f32 [n, H, W, c]: each output row's source rows lerped along H
    (``stage_row``), then each pixel's two staged columns along W
    (``Pixel``), with the taps of the host tables."""
    (H, W), h, w = out_hw, sem.shape[1], sem.shape[2]
    ty, tx = tap_tables(H, h), tap_tables(W, w)
    x = sem.float()
    wy = torch.from_numpy(ty["wt"])[None, :, None, None]
    rows = (1 - wy) * x[:, torch.from_numpy(ty["lo"]).long()] + wy * x[
        :, torch.from_numpy(ty["hi"]).long()]
    wx = torch.from_numpy(tx["wt"])[None, None, :, None]
    return (1 - wx) * rows[:, :, torch.from_numpy(tx["lo"]).long()] + wx * rows[
        :, :, torch.from_numpy(tx["hi"]).long()]


def chunked_scan(up: torch.Tensor, kc: int):
    """(argmax, max m, exp-sum s, the last chunk's exponentials) of f32
    logits [..., c] as ``argmax_stats`` takes them, in chunks of kc
    channels padded with -inf."""
    c = up.shape[-1]
    m = torch.full(up.shape[:-1], -math.inf)
    s = torch.zeros(up.shape[:-1])
    arg = torch.zeros(up.shape[:-1], dtype=torch.long)
    ks = torch.arange(kc)
    for c0 in range(0, c, kc):
        v = up[..., c0:c0 + kc]
        v = torch.cat([v, torch.full((*v.shape[:-1], kc - v.shape[-1]), -math.inf)], -1)
        cm = v.amax(-1)
        first = torch.where(v == cm[..., None], ks, kc).amin(-1)
        arg = torch.where(cm > m, c0 + first, arg)
        m_new = torch.maximum(m, cm)
        s = s * torch.exp(m - m_new)  # 0 at the first chunk
        e = torch.exp(v - m_new[..., None])
        for k in range(kc):
            s = s + e[..., k]
        m = m_new
    return arg, m, s, e


def seeded_logits(shape, seed, levels):
    """Random logits, or integers in [-3, 3] (``levels``): then most pixels
    tie, and at the scales below the upsample is exact in f32, so both
    packages see the same ties."""
    rs = np.random.RandomState(seed)
    if levels:
        return rs.randint(-3, 4, shape).astype(np.float32)
    return (rs.randn(*shape) * 4).astype(np.float32)


@pytest.mark.parametrize("levels", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("c", [16, 17, 24, 25, 40, 150])
@pytest.mark.parametrize("kc", [16, 24, 32])
def test_chunked_argmax_scan_matches_jax(kc, c, levels):
    shape, out_hw = (2, 4, 4, c), (16, 16)  # scale 4: weights in eighths
    sem = seeded_logits(shape, 7 * c + kc, levels)
    up = staged_upsample(torch.from_numpy(sem), out_hw)
    arg, _, s, _ = chunked_scan(up, kc)
    conf = 1.0 / s
    jax_preds, jax_conf = jax_argmax_conf(jnp.asarray(sem), out_hw)
    np.testing.assert_array_equal(arg.numpy().astype(np.uint8), np.asarray(jax_preds))
    # the f32 confidence of the JAX function before its f16 cast
    kh, kw = _kmats(jnp.asarray(sem), out_hw)
    jup = jnp.einsum("Ww,nHwc->nHWc", kw, jnp.einsum("Hh,nhwc->nHwc", kh, sem))
    ref = 1.0 / jnp.sum(jnp.exp(jup - jnp.max(jup, -1, keepdims=True)), -1)
    # 1e-6; past 40 channels the two sums of c f32 terms (the kernel's in
    # order, XLA's by its own tree) may part by c ulps of the sum
    rtol = 1e-6 if c <= 40 else c * 2.0 ** -24
    np.testing.assert_allclose(conf.numpy(), np.asarray(ref), rtol=rtol, atol=0)
    # and the f16 outputs: the two f32 values may round to neighbouring f16s
    np.testing.assert_allclose(conf.half().float().numpy(),
                               np.asarray(jax_conf).astype(np.float32), rtol=2 ** -10, atol=0)
    if levels:  # the inputs hold the ties the scan must break as JAX does
        top = up == up.amax(-1, keepdim=True)
        in_chunk = torch.stack([top[..., c0:c0 + kc].sum(-1) > 1
                                for c0 in range(0, c, kc)]).any(0)
        assert bool(in_chunk.any())
        if c > kc:
            chunks = torch.stack([top[..., c0:c0 + kc].any(-1) for c0 in range(0, c, kc)])
            assert bool((chunks.sum(0) > 1).any())


def one_pass_pseudo(up, labels, thr, max_entropy, kc, ignore_index):
    """PseudoTerm's labels, num and den of f32 logits [n, H, W, c]."""
    c = up.shape[-1]
    arg, m, s, e = chunked_scan(up, kc)
    r = 1.0 / s
    if c > kc:  # each chunk's exponentials again
        e = torch.exp(up - m[..., None])
    acc = torch.zeros_like(s)
    for k in range(c):
        p = e[..., k] * r
        acc = acc + p * torch.log2(p + 1e-8)
    ent_scale = -1.0 / (c * math.log(c + 1e-8))
    ent = acc * math.log(2.0) * ent_scale * (1.0 / max_entropy)
    valid = ent < thr[arg]
    bg = labels < c
    out = torch.where(bg, torch.where(valid, arg, ignore_index), labels.long())
    return (out.int(), (valid & bg).sum((1, 2)).float(), bg.sum((1, 2)).float())


def thresholds_clear_of(up, labels, max_entropy):
    """Per class, the midpoint of the widest gap between the entropies of
    the pixels below c that predict it (else just above them all), so no
    pixel's entropy lies within rounding of its threshold."""
    c = up.shape[-1]
    up64 = up.double()
    ent = pixel_entropy(torch.softmax(up64, -1)) / max_entropy
    pred = up64.argmax(-1)
    mask = labels < c
    thr = torch.full((max(c, 21),), 0.5)
    for k in range(c):
        vals = torch.unique(ent[mask & (pred == k)])
        if len(vals) > 1 and float(vals.diff().max()) > 1e-4:
            i = int(vals.diff().argmax())
            thr[k] = float(vals[i] + vals[i + 1]) / 2
        elif len(vals):
            thr[k] = float(vals[-1]) + 1e-3
    assert float((ent - thr.double()[pred]).abs()[mask].min()) > 1e-5
    return thr


@pytest.mark.parametrize("ignore_index", [255, 254])
@pytest.mark.parametrize("c,kc", [(16, 16), (16, 32), (17, 16), (17, 24), (40, 32),
                                  (150, 32)])
def test_one_pass_pseudo_labels_match_jax(c, kc, ignore_index):
    shape, out_hw = (2, 4, 4, c), (16, 16)
    rs = np.random.RandomState(c + kc)
    sem = (rs.randn(*shape) * 2).astype(np.float32)
    labels = rs.randint(0, c + 1, (shape[0], *out_hw)).astype(np.int32)
    labels[rs.rand(*labels.shape) < 0.05] = 255
    labels[rs.rand(*labels.shape) < 0.3] = 0
    max_entropy = float(np.log(c + 1))
    up = staged_upsample(torch.from_numpy(sem), out_hw)
    thr = thresholds_clear_of(up, torch.from_numpy(labels), max_entropy)
    got = one_pass_pseudo(up, torch.from_numpy(labels), thr, max_entropy, kc, ignore_index)
    ref = jax_pseudo(jnp.asarray(sem), jnp.asarray(labels), jnp.asarray(thr.numpy()),
                     out_hw, jnp.float32(max_entropy), ignore_index)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    num, den = got[1], got[2]
    assert 0 < float(num.sum()) < float(den.sum())  # kept and dropped pixels both


def argmax_scan(up: torch.Tensor, kc: int) -> torch.Tensor:
    """The argmax of f32 logits [..., c] as ``argmax_scan2`` takes it: the
    channels padded with NaN to a multiple of kc (the stage's padding),
    within a chunk a tree (a later half wins only on a strict >, the value
    by fmaxf, which passes over NaN), across chunks a later one taking over
    only on a strict >; no exponentials."""
    c = up.shape[-1]
    pad = torch.full((*up.shape[:-1], -c % kc), math.nan)
    x = torch.cat([up, pad], -1)
    m = torch.full(up.shape[:-1], -math.inf)
    arg = torch.zeros(up.shape[:-1], dtype=torch.long)
    for c0 in range(0, c, kc):
        mv = list(x[..., c0:c0 + kc].unbind(-1))
        mi = [torch.full(up.shape[:-1], k) for k in range(kc)]
        s = 1
        while s < kc:
            for k in range(0, kc - s, 2 * s):
                gt = mv[k + s] > mv[k]
                mi[k] = torch.where(gt, mi[k + s], mi[k])
                mv[k] = torch.fmax(mv[k], mv[k + s])
            s *= 2
        arg = torch.where(mv[0] > m, c0 + mi[0], arg)
        m = torch.fmax(m, mv[0])
    return arg


def pixel_histogram(preds: np.ndarray, labels: np.ndarray, nc: int) -> np.ndarray:
    """The int32 [nc, nc] matrix of ``conf_kernel``'s bins: one count per
    pixel whose label t is in [0, nc), at t * nc + min(pred, nc - 1)."""
    t = labels.astype(np.int64).ravel()
    keep = (t >= 0) & (t < nc)
    key = t[keep] * nc + np.minimum(preds.ravel()[keep], nc - 1)
    return np.bincount(key, minlength=nc * nc).reshape(nc, nc).astype(np.int32)


KC = 8  # the chunk of upsample_confusion.cu's scan


# (sem shape, output size, classes); scale 4 (weights in eighths): exact
# upsampled integer logits.  Chunks of 8 (the kernel's) and of 32 (c = 40
# crosses it); c < nc and c > nc; output widths of 36 and 20, not
# multiples of a warp
CONF_CASES = [((2, 4, 4, 21), (16, 16), 21), ((2, 4, 9, 40), (16, 36), 40),
              ((2, 4, 5, 17), (16, 20), 25), ((1, 5, 9, 30), (20, 36), 21),
              ((2, 4, 4, 16), (16, 16), 16), ((1, 3, 5, 150), (12, 20), 150)]


@pytest.mark.parametrize("labels_dtype", [np.int32, np.int64], ids=["i32", "i64"])
@pytest.mark.parametrize("levels", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("shape,out_hw,nc", CONF_CASES)
@pytest.mark.parametrize("kc", [KC, 32])
def test_confusion_scan_and_bins_match_jax(kc, shape, out_hw, nc, levels, labels_dtype):
    c = shape[-1]
    sem = seeded_logits(shape, 5 * c + nc, levels)
    rs = np.random.RandomState(c + nc)
    labels = rs.randint(0, nc, (shape[0], *out_hw)).astype(labels_dtype)
    drop = rs.rand(*labels.shape)
    labels[drop < 0.15] = 255
    labels[(drop >= 0.15) & (drop < 0.2)] = -1
    labels[(drop >= 0.2) & (drop < 0.25)] = nc
    up = staged_upsample(torch.from_numpy(sem), out_hw)
    preds = argmax_scan(up, kc).numpy()
    got = pixel_histogram(preds, labels, nc)
    ref = np.asarray(jax_confusion(jnp.asarray(sem), jnp.asarray(labels), out_hw, nc))
    np.testing.assert_array_equal(got, ref)
    valid = (labels >= 0) & (labels < nc)
    assert got.sum() == valid.sum()
    if c > nc:  # predictions past nc were clipped into the last column
        assert (preds >= nc).any() and got[:, -1].sum() >= ((preds >= nc) & valid).sum()
    if levels:  # ties the scan must break as JAX does: within a chunk, and across
        top = up == up.amax(-1, keepdim=True)
        assert bool((top[..., :kc].sum(-1) > 1).any())
        if c > kc:
            assert bool((top[..., :kc].any(-1) & top[..., kc:].any(-1)).any())
