"""The host-built tap tables and band plan of the upsample+loss kernels.

The CUDA kernels of ``bacs_tpu_torch/csrc/upsample_ce.cuh`` (K1, K3, K4,
K6, K8) read their bilinear taps from tables that
``ops/upsample_ce.py:launch_plan`` builds with numpy: these tests hold the
tables to ``interp_matrix`` bit for bit, their inverse ranges to its
nonzeros, and the bands a gradient launch takes to every (output row,
source row) tap pair, once each.  They need no card.
"""

import numpy as np
import pytest

from bacs_tpu_torch.ops.upsample_ce import (
    SMEM_MAX, TARGET_BLOCKS, _plan_numpy, band_plan, grad_smem_bytes, tap_tables,
    tile_span)
from bacs_tpu_torch.ops.upsample_tiles import interp_matrix

# (in, out) pairs of the card tests: upsamples at integer and odd scales,
# equal sizes and downscales
PAIRS = [(32, 512), (33, 261), (47, 373), (5, 37), (7, 51), (8, 128), (16, 16),
         (4, 7), (4, 5), (8, 5), (8, 7), (6, 40), (6, 37), (1, 9), (9, 1)]


def rebuilt(t: dict, out_dim: int, in_dim: int) -> np.ndarray:
    """The [out, in] matrix the inverse ranges give: 1 - wt over each lo
    range plus wt over each hi range, in f32 as the kernels add them."""
    k = np.zeros((out_dim, in_dim), np.float32)
    one = np.float32(1.0)
    for x in range(in_dim):
        for o in range(t["lo_first"][x], t["lo_last"][x] + 1):
            k[o, x] += one - t["wt"][o]
        for o in range(t["hi_first"][x], t["hi_last"][x] + 1):
            k[o, x] += t["wt"][o]
    return k


@pytest.mark.parametrize("in_dim,out_dim", PAIRS)
def test_tap_tables_rebuild_interp_matrix_bit_for_bit(in_dim, out_dim):
    t = tap_tables(out_dim, in_dim)
    ref = interp_matrix(out_dim, in_dim)
    # the forward's taps: 1 - wt at lo plus wt at hi, as interp_matrix adds
    k = np.zeros((out_dim, in_dim), np.float32)
    rows = np.arange(out_dim)
    np.add.at(k, (rows, t["lo"]), np.float32(1.0) - t["wt"])
    np.add.at(k, (rows, t["hi"]), t["wt"])
    assert k.tobytes() == ref.tobytes()
    assert t["lo"].dtype == t["hi"].dtype == np.int32 and t["wt"].dtype == np.float32
    assert np.all(np.diff(t["lo"]) >= 0) and np.all(np.diff(t["hi"]) >= 0)
    # the backward's inverse ranges give the same matrix
    assert rebuilt(t, out_dim, in_dim).tobytes() == ref.tobytes()


@pytest.mark.parametrize("in_dim,out_dim", PAIRS)
def test_inverse_ranges_cover_exactly_the_nonzeros(in_dim, out_dim):
    t = tap_tables(out_dim, in_dim)
    ref = interp_matrix(out_dim, in_dim)
    one = np.float32(1.0)
    for x in range(in_dim):
        for name, src, weight in (("lo", t["lo"], one - t["wt"]), ("hi", t["hi"], t["wt"])):
            first, last = t[f"{name}_first"][x], t[f"{name}_last"][x]
            want = np.flatnonzero((src == x) & (weight != 0))
            # each range is exactly the output indices of that tap, contiguous
            np.testing.assert_array_equal(np.arange(first, last + 1), want)
        covered = set(range(t["lo_first"][x], t["lo_last"][x] + 1)) | set(
            range(t["hi_first"][x], t["hi_last"][x] + 1))
        assert covered == set(np.flatnonzero(ref[:, x]).tolist())


@pytest.mark.parametrize("band", [1, 3, 6, 8, 64])
@pytest.mark.parametrize("in_dim,out_dim", PAIRS)
def test_bands_cover_every_tap_pair_once(in_dim, out_dim, band):
    ty = tap_tables(out_dim, in_dim)
    plan = band_plan(ty, in_dim, band)
    ref = interp_matrix(out_dim, in_dim)
    n_bands = -(-out_dim // band)
    assert len(plan["y0"]) == n_bands
    assert plan["max_rows"] == int(plan["rows"].max())
    for oy in range(out_dim):
        for y in np.flatnonzero(ref[oy]):
            # the bands the second pass sums for source row y that hold oy
            holders = [b for b in range(plan["first"][y], plan["last"][y] + 1)
                       if b * band <= oy < (b + 1) * band]
            assert len(holders) == 1, (oy, y, holders)
            b = holders[0]
            # and the band's slab holds row y
            assert plan["y0"][b] <= y < plan["y0"][b] + plan["rows"][b]
    # every (output row, lo / hi) pair the kernel adds lies in its band's slab
    for oy in range(out_dim):
        b = oy // band
        for y in (ty["lo"][oy], ty["hi"][oy]):
            assert 0 <= y - plan["y0"][b] < plan["max_rows"]
    # a source row that is no output row's lo or hi (a downscale) sums no
    # band; one reached with weight 0 only sums zeros
    untouched = np.setdiff1d(np.arange(in_dim), np.union1d(ty["lo"], ty["hi"]))
    assert np.all(plan["first"][untouched] > plan["last"][untouched])


@pytest.mark.parametrize("shape,out_hw", [
    ((16, 32, 32, 21), (512, 512)), ((12, 32, 32, 17), (512, 512)),
    ((2, 33, 47, 21), (261, 373)), ((2, 8, 8, 150), (128, 128)),
    ((2, 8, 8, 21), (5, 7)), ((1, 4, 4, 3), (7, 5)), ((1, 64, 1024, 151), (16, 200))])
def test_launch_plan_layout_and_shared_memory(shape, out_hw):
    """The packed tables in the order ``Plan`` reads them, a plan whose
    shared memory fits a block, and bands that give about TARGET_BLOCKS
    blocks."""
    n, h, w, c = shape
    H, W = out_hw
    tables, (band, tile, span, rows), nb = _plan_numpy(n, h, w, c, H, W)
    tx, ty = tap_tables(W, w), tap_tables(H, h)
    bands = band_plan(ty, h, band)
    assert tables.dtype == np.int32
    assert len(tables) == 3 * W + 4 * w + 3 * H + nb + 2 * h
    parts = np.split(tables, np.cumsum([W, W, W, w, w, w, w, H, H, H, nb, h]))
    want = [tx["lo"], tx["hi"], tx["wt"].view(np.int32), tx["lo_first"], tx["lo_last"],
            tx["hi_first"], tx["hi_last"], ty["lo"], ty["hi"], ty["wt"].view(np.int32),
            bands["y0"], bands["first"], bands["last"]]
    for got, ref in zip(parts, want):
        np.testing.assert_array_equal(got, ref)
    assert nb == -(-H // band) and rows == bands["max_rows"]
    assert 1 <= tile <= 256 and span == tile_span(tx, tile)
    assert grad_smem_bytes(tile, span, c) <= SMEM_MAX
    assert n * nb >= min(TARGET_BLOCKS, n * H) // 2


@pytest.mark.parametrize("shape,c_old,out_hw", [
    ((12, 32, 32, 17), 16, (512, 512)), ((2, 8, 8, 40), 39, (128, 128)),
    ((2, 5, 7, 6), 1, (37, 51)), ((1, 64, 1024, 151), 150, (16, 200))])
def test_launch_plan_stages_the_pair(shape, c_old, out_hw):
    """K7 stages the teacher's c_old channels beside the student's c: the
    plan's tile is the largest whose gradient shared memory fits with
    c + c_old floats a staged column, and a plan for the student alone may
    take a larger tile, never a smaller one."""
    n, h, w, c = shape
    H, W = out_hw
    _, (band, tile, span, rows), nb = _plan_numpy(n, h, w, c, H, W, c_old)
    _, (_, tile_alone, _, _), _ = _plan_numpy(n, h, w, c, H, W)
    tx = tap_tables(W, w)
    assert span == tile_span(tx, tile)
    assert grad_smem_bytes(tile, span, c + c_old) <= SMEM_MAX
    if tile < 256:  # the next larger tile would not fit
        assert grad_smem_bytes(2 * tile, tile_span(tx, 2 * tile), c + c_old) > SMEM_MAX
    assert tile <= tile_alone
    assert grad_smem_bytes(tile, span, c + c_old) >= grad_smem_bytes(tile, span, c)


@pytest.mark.parametrize("shape,out_hw", [
    # K10: the serving batch, batch 1, an odd band, 150 channels, and the
    # channel counts at and across its register chunks
    ((16, 32, 32, 21), (512, 512)), ((1, 32, 32, 21), (512, 512)),
    ((2, 33, 47, 21), (261, 373)), ((2, 8, 8, 150), (128, 128)),
    ((2, 8, 8, 25), (128, 128)), ((2, 8, 8, 33), (128, 128)),
    # K9: PLOP's teacher at the step's batch, an odd band, 150 channels
    ((12, 32, 32, 16), (512, 512)), ((2, 33, 47, 16), (261, 373)),
    ((2, 8, 8, 150), (128, 128)), ((1, 64, 1024, 256), (16, 200))])
def test_launch_plan_fits_the_pixel_kernels(shape, out_hw):
    """K9 and K10 (``pixel_kernel`` of csrc/upsample_stage.cuh) stage the
    whole row where its w columns of (c | 1) floats fit 48 KB, else the
    plan's tiles: either stage fits a block's shared memory, the tiles
    cover every output column with the source columns they read, and the
    bands give about TARGET_BLOCKS blocks."""
    n, h, w, c = shape
    H, W = out_hw
    _, (band, tile, span, _), nb = _plan_numpy(n, h, w, c, H, W)
    ldc = c | 1
    if 4 * w * ldc <= 48 * 1024:
        tile, span = W, w
    assert 1 <= tile and 4 * span * ldc <= SMEM_MAX
    tx = tap_tables(W, w)
    for ox0 in range(0, W, tile):
        ox1 = min(W, ox0 + tile)
        assert tx["hi"][ox1 - 1] - tx["lo"][ox0] + 1 <= span
    assert nb == -(-H // band) and n * nb >= min(TARGET_BLOCKS, n * H) // 2
