"""Port ops against their JAX counterparts, on the CPU (plain versions).

Inputs are made with numpy from a seed and fed to both packages.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bacs_tpu.data.transforms import normalize_image as jax_normalize
from bacs_tpu.models.norm import make_norm as jax_make_norm
from bacs_tpu.ops.abn_core import fused_abn_eval as jax_fused_abn_eval
from bacs_tpu.ops.bitpack import pack_bits as jax_pack_bits
from bacs_tpu.ops.interpolate import resize_bilinear as jax_resize
from bacs_tpu.ops.upsample_argmax import upsampled_argmax_conf as jax_argmax_conf
from bacs_tpu.ops.upsample_tiles import interp_matrix as jax_interp_matrix
from bacs_tpu.viz.media import voc_colormap as jax_voc_colormap
from bacs_tpu_torch.data.transforms import normalize_image
from bacs_tpu_torch.kernels import build
from bacs_tpu_torch.models.norm import ABN, make_norm
from bacs_tpu_torch.ops.abn_core import abn_eval_plain, fused_abn_eval
from bacs_tpu_torch.ops.bitpack import bits_needed, pack_bits, unpack_bits
from bacs_tpu_torch.ops.interpolate import resize_bilinear
from bacs_tpu_torch.ops.upsample_argmax import (
    argmax_conf_plain,
    upsampled_argmax_conf,
)
from bacs_tpu_torch.ops.upsample_tiles import interp_matrix, kmats
from bacs_tpu_torch.viz.media import voc_colormap

EPS = 1e-5


def _abn_vectors(rs, c):
    return dict(
        mean=rs.uniform(-0.5, 0.5, c).astype(np.float32),
        var=rs.uniform(0.3, 2.5, c).astype(np.float32),
        scale=rs.uniform(-1.5, 1.5, c).astype(np.float32),
        bias=rs.uniform(-0.5, 0.5, c).astype(np.float32),
    )


# ---------------------------------------------------------------- interp


@pytest.mark.parametrize(
    "out_dim,in_dim",
    [(64, 8), (64, 4), (512, 32), (37, 5), (51, 7), (16, 16), (5, 9), (261, 33)],
)
def test_interp_matrix_exact(out_dim, in_dim):
    np.testing.assert_array_equal(
        interp_matrix(out_dim, in_dim), jax_interp_matrix(out_dim, in_dim)
    )


def test_kmats_shapes():
    kh, kw = kmats((2, 5, 7, 3), (37, 51))
    np.testing.assert_array_equal(kh, jax_interp_matrix(37, 5))
    np.testing.assert_array_equal(kw, jax_interp_matrix(51, 7))


# ---------------------------------------------------------------- ABN (K5)


@pytest.mark.parametrize("slope", [0.01, 0.0, 1.0])
@pytest.mark.parametrize("shape", [(2, 5, 7, 64), (2, 1, 1, 256), (3, 4, 4, 24)])
def test_fused_abn_eval_matches_jax(shape, slope):
    rs = np.random.RandomState(0)
    x = (rs.randn(*shape) * 2).astype(np.float32)
    v = _abn_vectors(rs, shape[-1])
    ref = jax_fused_abn_eval(
        jnp.asarray(x), v["mean"], v["var"], v["scale"], v["bias"], EPS, slope
    )
    t = {k: torch.from_numpy(a) for k, a in v.items()}
    got = fused_abn_eval(
        torch.from_numpy(x), t["mean"], t["var"], t["scale"], t["bias"], EPS, slope
    )
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_fused_abn_eval_bf16_rounds_once():
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(2, 3, 3, 16).astype(np.float32)).bfloat16()
    t = {k: torch.from_numpy(a) for k, a in _abn_vectors(rs, 16).items()}
    got = fused_abn_eval(x, t["mean"], t["var"], t["scale"], t["bias"], EPS, 0.01)
    ref = abn_eval_plain(x.float(), t["mean"], t["var"], t["scale"], t["bias"],
                         EPS, 0.01)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, ref.bfloat16(), rtol=0, atol=0)


@pytest.mark.parametrize(
    "norm,kwargs",
    [
        ("iabn_sync", {}),
        ("bn", {}),
        ("iabn_sync", dict(activation="identity")),
        ("iabr", {}),
        ("iabn_sync", dict(pool=True)),
    ],
    ids=["leaky", "relu", "identity", "renorm", "pool"],
)
def test_abn_module_eval_matches_jax(norm, kwargs):
    """make_norm's layers in eval mode; renorm is inert with running stats."""
    rs = np.random.RandomState(2)
    c = 32
    x = (rs.randn(2, 10, 9, c) * 2).astype(np.float32)
    v = _abn_vectors(rs, c)
    jm = jax_make_norm(norm)(c, **kwargs)
    variables = {
        "params": {"scale": v["scale"], "bias": v["bias"]},
        "batch_stats": {"mean": v["mean"], "var": v["var"]},
    }
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), use_running_average=True))

    m = make_norm(norm)(c, **kwargs).eval()
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(v["scale"]))
        m.bias.copy_(torch.from_numpy(v["bias"]))
        m.running_mean.copy_(torch.from_numpy(v["mean"]))
        m.running_var.copy_(torch.from_numpy(v["var"]))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)  # NCHW, channels_last memory
        got = m(xt).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_abn_train_mode_raises():
    """Train mode is ported for the fused branch (tests/test_torch_train_ops.py);
    the non-fused one (ReLU, renorm) still raises, naming its ROADMAP item."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ABN(8, activation="relu", activation_param=0.0)(torch.zeros(1, 8, 2, 2))


def test_abn_cpu_does_not_count_launches():
    before = fused_abn_eval.launches
    ABN(8).eval()(torch.randn(1, 8, 2, 2))
    assert fused_abn_eval.launches == before


# ------------------------------------------------- upsample+argmax+conf (K10)


@pytest.mark.parametrize(
    "shape,out_hw",
    [
        ((2, 8, 8, 21), (64, 64)),    # 8x
        ((1, 4, 4, 21), (64, 64)),    # 16x
        ((2, 5, 7, 6), (37, 51)),     # odd sizes
        ((2, 16, 16, 4), (16, 16)),   # identity resolution
    ],
    ids=["8x", "16x", "odd", "identity"],
)
def test_upsampled_argmax_conf_matches_jax(shape, out_hw):
    rs = np.random.RandomState(3)
    sem = (rs.randn(*shape) * 4).astype(np.float32)
    ref_p, ref_c = jax_argmax_conf(jnp.asarray(sem), out_hw, use_pallas=False)
    before = upsampled_argmax_conf.launches
    preds, conf = upsampled_argmax_conf(torch.from_numpy(sem), out_hw)
    assert upsampled_argmax_conf.launches == before
    assert preds.dtype == torch.uint8 and conf.dtype == torch.float16
    assert tuple(preds.shape) == (shape[0],) + tuple(out_hw)
    # decisive pixels: top-2 margin of the f64 upsampled logits above 1e-5
    kh, kw = kmats(shape, out_hw)
    up = np.einsum("Hh,Ww,nhwc->nHWc", kh.astype(np.float64),
                   kw.astype(np.float64), sem.astype(np.float64))
    top2 = np.sort(up, axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) > 1e-5
    np.testing.assert_array_equal(preds.numpy()[decisive], np.asarray(ref_p)[decisive])
    np.testing.assert_allclose(
        conf.numpy().astype(np.float32), np.asarray(ref_c).astype(np.float32),
        atol=1e-3,
    )


def test_argmax_conf_plain_is_a_probability():
    sem = torch.from_numpy(
        (np.random.RandomState(4).randn(1, 8, 8, 21) * 5).astype(np.float32)
    )
    _, conf = argmax_conf_plain(sem, (64, 64))
    c = conf.float()
    assert bool((c >= 1.0 / 21 - 1e-3).all()) and bool((c <= 1.0 + 1e-3).all())


# ---------------------------------------------------------------- bitpack


@pytest.mark.parametrize("bits,n_classes", [(1, 2), (5, 21), (8, 150)])
def test_pack_bits_matches_jax_bytes(bits, n_classes):
    rs = np.random.RandomState(bits)
    preds = rs.randint(0, n_classes, (2, 16, 24)).astype(np.uint8)
    got = pack_bits(torch.from_numpy(preds), bits).numpy()
    ref = np.asarray(jax_pack_bits(jnp.asarray(preds), bits))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(unpack_bits(got, preds.shape, bits), preds)


def test_bits_needed_and_bad_shapes():
    assert [bits_needed(n) for n in (2, 3, 21, 150, 256)] == [1, 2, 5, 8, 8]
    with pytest.raises(ValueError):
        bits_needed(1)
    with pytest.raises(ValueError):
        pack_bits(torch.zeros(1, 12, 8, dtype=torch.uint8), 5)


# ------------------------------------------------- resize, normalize, palette


@pytest.mark.parametrize("size", [(32, 48), (8, 8)])
def test_resize_bilinear_matches_jax(size):
    x = np.random.RandomState(5).randn(2, 8, 8, 3).astype(np.float32)
    ref = np.asarray(jax_resize(jnp.asarray(x), size, align_corners=False))
    got = resize_bilinear(torch.from_numpy(x), size).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_normalize_image_matches_jax():
    img = np.random.RandomState(6).randint(0, 256, (2, 5, 5, 3)).astype(np.uint8)
    ref = np.asarray(jax_normalize(jnp.asarray(img)))
    got = normalize_image(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_voc_colormap_matches_jax():
    np.testing.assert_array_equal(voc_colormap(), jax_voc_colormap())


# ---------------------------------------------------------------- build


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()


def test_signatures_match_the_c_entry_points():
    """Every extern "C" function in csrc/ is declared for ctypes with its
    parameter count, and nothing else is."""
    found = {}
    for path in build.sources():
        src = path.read_text()
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
            found[name] = len(params.split(","))
    assert found == {k: len(v) for k, v in build.SIGNATURES.items()}
    assert build.library_path().name.startswith("libbacs_kernels_")
