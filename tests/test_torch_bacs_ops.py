"""The BACS slice's ops and modules against their JAX counterparts, on the CPU.

Resizes, the detector's focal loss, the BACS weighted CE, the K3 and K4
public ops (the port's plain versions on CPU tensors, the JAX jnp branches
off the TPU), the replay crop, the buffer, the background detector, the
Flax weight map with the detector, the prototype fold and the BACS terms
on given inputs.  Inputs are made with numpy from a seed and fed to both
packages; the tolerance is stated per test.
"""


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bacs_tpu.data import transforms as jax_transforms
from bacs_tpu.methods import create_method as jax_create_method
from bacs_tpu.methods.base import label_task_ids as jax_label_task_ids
from bacs_tpu.methods.base import update_task_prototypes as jax_update_prototypes
from bacs_tpu.methods.bacs import random_autocontrast as jax_autocontrast
from bacs_tpu.models.bg_detector import BgDetector as JaxBgDetector
from bacs_tpu.models.deeplab import DeepLabV3 as JaxDeepLabV3
from bacs_tpu.ops import interpolate as jax_interp
from bacs_tpu.ops import losses as jax_losses
from bacs_tpu.ops import upsample_ce as jax_uce
from bacs_tpu.train import buffer as jax_buffer
from bacs_tpu.train.state import TaskInfo as JaxTaskInfo
from bacs_tpu_torch.ops import rng
from bacs_tpu_torch.data import transforms
from bacs_tpu_torch.methods import ModelContext, create_method
from bacs_tpu_torch.methods.bacs import random_autocontrast
from bacs_tpu_torch.methods.base import label_task_ids, update_task_prototypes
from bacs_tpu_torch.models import create_network
from bacs_tpu_torch.models.bg_detector import BgDetector
from bacs_tpu_torch.ops import interpolate, losses
from bacs_tpu_torch.ops import upsample_ce as uce
from bacs_tpu_torch.train import buffer
from bacs_tpu_torch.train.state import TaskInfo
from bacs_tpu_torch.utils.flax_weights import (
    flax_to_state_dict, load_flax_variables, state_dict_to_flax)
from torch_port_helpers import _one_thread, randomize_abn  # noqa: F401

TASK1 = dict(task_id=1, initial_classes=16, increment=1, num_classes=21, n_tasks=6,
             max_epochs=30)


def close(got, ref, rtol=1e-5, scale_atol=1e-6):
    """got (torch) against ref (JAX or numpy): rtol, and atol a share of the
    largest reference value."""
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), ref, rtol=rtol,
                               atol=scale_atol * max(np.abs(ref).max(), 1e-30))


def sem_labels(shape, out_hw, seed, bg_share=0.3):
    rs = np.random.RandomState(seed)
    sem = (rs.randn(*shape) * 3).astype(np.float32)
    labels = rs.randint(0, shape[-1], (shape[0],) + tuple(out_hw)).astype(np.int32)
    labels[rs.rand(*labels.shape) < bg_share] = 0
    labels[rs.rand(*labels.shape) < 0.08] = 255
    return sem, labels, rs


# ---------------------------------------------------------------- resizes


@pytest.mark.parametrize("shape,size", [((2, 4, 5, 3), (64, 80)), ((1, 3, 3, 2), (1, 7)),
                                        ((2, 9, 7, 4), (5, 3))])
def test_resize_bilinear_align_corners_matches_jax(shape, size):
    """The detector's corner-aligned upsample (and a downsample), f32 rtol 1e-5."""
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    ref = jax_interp.resize_bilinear(jnp.asarray(x), size, align_corners=True)
    close(interpolate.resize_bilinear(torch.from_numpy(x), size, align_corners=True), ref)


@pytest.mark.parametrize("shape,size", [((2, 17, 23), (5, 4)), ((2, 64, 64), (4, 4)),
                                        ((1, 8, 8, 3), (3, 5)), ((1, 5, 5), (12, 9))])
def test_resize_nearest_matches_jax(shape, size):
    """Label maps and NHWC tensors: the same source pixels, exactly."""
    x = np.random.RandomState(1).randint(0, 255, shape).astype(np.int32)
    ref = np.asarray(jax_interp.resize_nearest(jnp.asarray(x), size))
    np.testing.assert_array_equal(interpolate.resize_nearest(torch.from_numpy(x), size).numpy(), ref)


# ---------------------------------------------------------------- losses


@pytest.mark.parametrize("alpha", [None, 0.25])
def test_binary_focal_loss_matches_jax(alpha):
    """Value and gradient rtol 1e-5, some logits exactly 0 (JAX's tie
    derivatives) and some targets ignored."""
    rs = np.random.RandomState(2)
    x = (rs.randn(2, 9, 11) * 2).astype(np.float32)
    x[0, 0, :4] = 0.0
    t = rs.randint(0, 2, x.shape).astype(np.int32)
    t[rs.rand(*t.shape) < 0.1] = 255
    fn = lambda x: jax_losses.binary_focal_loss(x, jnp.asarray(t), alpha=alpha)  # noqa: E731
    ref, ref_grad = jax.value_and_grad(fn)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = losses.binary_focal_loss(xt, torch.from_numpy(t), alpha=alpha)
    got.backward()
    close(got, ref)
    close(xt.grad, ref_grad)


@pytest.mark.parametrize("ukd", [True, False], ids=["ukd", "no-ukd"])
def test_weighted_cross_entropy_matches_jax(ukd):
    """The BACS weighted CE (mean over all pixels), value and gradient
    rtol 1e-5, seen-probabilities on both sides of the threshold."""
    rs = np.random.RandomState(3)
    logits = (rs.randn(2, 6, 7, 9) * 2).astype(np.float32)
    labels = rs.randint(0, 9, (2, 6, 7)).astype(np.int32)
    labels[rs.rand(*labels.shape) < 0.3] = 0
    labels[rs.rand(*labels.shape) < 0.1] = 255
    seen = rs.rand(2, 6, 7, 2).astype(np.float32)
    fn = lambda x: jax_losses.weighted_cross_entropy(  # noqa: E731
        x, jnp.asarray(labels), jnp.asarray(seen), old_classes=6, ukd=ukd)
    ref, ref_grad = jax.jit(jax.value_and_grad(fn))(jnp.asarray(logits))
    xt = torch.from_numpy(logits).requires_grad_()
    got = losses.weighted_cross_entropy(xt, torch.from_numpy(labels), torch.from_numpy(seen),
                                        old_classes=6, ukd=ukd)
    got.backward()
    close(got, ref)
    close(xt.grad, ref_grad)


# ---------------------------------------------------------------- K4 and K3


UPSAMPLE_CASES = [((2, 5, 7, 6), (37, 51)), ((2, 4, 4, 17), (64, 64))]


@pytest.mark.parametrize("shape,out_hw", UPSAMPLE_CASES, ids=["odd", "16x"])
@pytest.mark.parametrize("weights", ["beta", "random", "zeros"])
def test_upsampled_weighted_cross_entropy_matches_jax(shape, out_hw, weights):
    """K4's public op (its plain version here) against the JAX op: value
    rtol 1e-5, d/dsem within 1e-5 of its largest entry; all-zero weights
    give 0 and a zero gradient, not NaN; no kernel launch on the CPU."""
    sem, labels, rs = sem_labels(shape, out_hw, 4)
    c = shape[-1]
    w = {"beta": ((np.arange(c) >= 1) & (np.arange(c) < c - 1)).astype(np.float32),
         "random": rs.uniform(0.1, 2.0, c).astype(np.float32),
         "zeros": np.zeros(c, np.float32)}[weights]
    fn = lambda s: jax_uce.upsampled_weighted_cross_entropy(  # noqa: E731
        s, jnp.asarray(labels), jnp.asarray(w), out_hw)
    ref, ref_grad = jax.jit(jax.value_and_grad(fn))(jnp.asarray(sem))
    st = torch.from_numpy(sem).requires_grad_()
    before = (uce.wce_sums.launches, uce.wce_dsem.launches)
    got = uce.upsampled_weighted_cross_entropy(st, torch.from_numpy(labels),
                                               torch.from_numpy(w), out_hw)
    got.backward()
    assert (uce.wce_sums.launches, uce.wce_dsem.launches) == before
    close(got, ref)
    close(st.grad, ref_grad, rtol=0, scale_atol=1e-5)
    if weights == "zeros":
        assert float(got.detach()) == 0.0 and not st.grad.any()
    loss, wsum = uce.upsampled_wce_sums(torch.from_numpy(sem), torch.from_numpy(labels),
                                        torch.from_numpy(w), out_hw)
    assert not wsum.requires_grad
    np.testing.assert_allclose(float(wsum), float((w[np.where(labels == 255, 0, labels)]
                                                   * (labels != 255)).sum()), rtol=1e-6)


@pytest.mark.parametrize("shape,out_hw", UPSAMPLE_CASES, ids=["odd", "16x"])
@pytest.mark.parametrize("ukd", [True, False], ids=["ukd", "no-ukd"])
def test_upsampled_bacs_weighted_ce_matches_jax(shape, out_hw, ukd):
    """K3's public op (its plain version) against the JAX op: value rtol
    1e-5, d/dsem within 1e-5 of its largest entry, max_seen on both sides
    of the threshold, old_classes = C - 1."""
    sem, labels, rs = sem_labels(shape, out_hw, 5)
    ms = rs.rand(shape[0], *out_hw).astype(np.float32)
    old = shape[-1] - 1
    fn = lambda s: jax_uce.upsampled_bacs_weighted_ce(  # noqa: E731
        s, jnp.asarray(labels), jnp.asarray(ms), out_hw, old, ukd=ukd)
    ref, ref_grad = jax.jit(jax.value_and_grad(fn))(jnp.asarray(sem))
    st = torch.from_numpy(sem).requires_grad_()
    before = (uce.bacs_sum.launches, uce.bacs_dsem.launches)
    got = uce.upsampled_bacs_weighted_ce(st, torch.from_numpy(labels), torch.from_numpy(ms),
                                         out_hw, old, ukd=ukd)
    got.backward()
    assert (uce.bacs_sum.launches, uce.bacs_dsem.launches) == before
    close(got, ref)
    close(st.grad, ref_grad, rtol=0, scale_atol=1e-5)


def test_bacs_kernel_terms_equal_the_weighted_ce():
    """``_bacs_terms``, the per-pixel terms the K3 kernel computes by hand
    (the TPU kernel's, ``bacs_tpu/ops/upsample_ce.py:341-393``), summed,
    equal the port's plain K3 sum: the CUDA kernel's formulas are that
    function's, so this ties the kernel's derivation to the plain version
    the card holds it against."""
    sem, labels, rs = sem_labels((2, 4, 4, 17), (16, 16), 6)
    ms = rs.rand(2, 16, 16).astype(np.float32)
    up = np.asarray(uce.upsample_plain(torch.from_numpy(sem), (16, 16)))
    for ukd in (True, False):
        tile = jnp.asarray(up.reshape(-1, 16, 17).transpose(0, 2, 1))  # [R, c, W]
        loss_map, grad = jax_uce._bacs_terms(tile, jnp.asarray(labels.reshape(-1, 16)),
                                             jnp.asarray(ms.reshape(-1, 16)), 16, 2.0, 0.5,
                                             ukd)
        ref = uce.bacs_sum(torch.from_numpy(sem), torch.from_numpy(labels),
                           torch.from_numpy(ms), (16, 16), 16, ukd=ukd)
        np.testing.assert_allclose(float(jnp.sum(loss_map)), float(ref), rtol=1e-5)
        # and the hand gradient against autograd of the plain sum, per pixel
        upt = torch.from_numpy(up).requires_grad_()
        losses.weighted_cross_entropy(upt, torch.from_numpy(labels),
                                      torch.from_numpy(ms)[..., None], 16,
                                      ukd=ukd).mul(labels.size).backward()
        g = np.asarray(grad).transpose(0, 2, 1).reshape(up.shape)
        np.testing.assert_allclose(upt.grad.numpy(), g, rtol=0, atol=1e-5)


# ---------------------------------------------------------------- replay crop


def test_resize_region_and_flip_match_jax():
    """Given crop parameters, the bilinear image and nearest label crops and
    the flip equal JAX's ``_resize_region`` (images rtol 1e-5, labels
    exactly)."""
    rs = np.random.RandomState(7)
    images = rs.randn(3, 32, 32, 3).astype(np.float32)
    labels = rs.randint(0, 17, (3, 32, 32)).astype(np.int32)
    params = dict(i=np.float32([3.25, 0.0, 10.7]), j=np.float32([0.0, 5.5, 1.3]),
                  ch=np.float32([20.0, 32.0, 8.0]), cw=np.float32([27.5, 16.0, 30.9]),
                  flip=np.array([True, False, True]))
    img, lbl = transforms.apply_crop_params(
        torch.from_numpy(images), torch.from_numpy(labels),
        {k: torch.from_numpy(v) for k, v in params.items()})
    for n in range(3):
        p = [params[k][n] for k in ("i", "j", "ch", "cw")]
        ri = np.asarray(jax_transforms._resize_region(jnp.asarray(images[n]), *p, 32, "bilinear"))
        rl = np.asarray(jax_transforms._resize_region(jnp.asarray(labels[n]), *p, 32, "nearest"))
        if params["flip"][n]:
            ri, rl = ri[:, ::-1], rl[:, ::-1]
        close(img[n], ri)
        np.testing.assert_array_equal(lbl[n].numpy(), rl)
    # drawn parameters: in range, one per image, on the draws' device
    drawn = transforms.sample_crop_params(64, (32, 32), rng.key(0))
    assert ((drawn["ch"] >= 8) & (drawn["ch"] <= 32) & (drawn["i"] >= 0)
            & (drawn["i"] + drawn["ch"] <= 32 + 1e-4)).all()
    img, lbl = transforms.replay_augment(torch.from_numpy(images), torch.from_numpy(labels),
                                         rng.key(1))
    assert img.shape == images.shape and lbl.dtype == torch.int32


def test_random_autocontrast_matches_jax():
    x = np.random.RandomState(8).randn(2, 6, 5, 3).astype(np.float32)
    ref = jax_autocontrast(jax.random.PRNGKey(0), jnp.asarray(x), p=1.0)
    close(random_autocontrast(torch.from_numpy(x), p=1.0), ref)
    np.testing.assert_array_equal(random_autocontrast(torch.from_numpy(x), p=0.0).numpy(), x)


# ---------------------------------------------------------------- buffer


def buffer_items(rs, n, hw=16):
    return dict(
        images=rs.randn(n, hw, hw, 3).astype(np.float32),
        logits=rs.randn(n, 2, 2, 8).astype(np.float32),
        labels=np.where(rs.rand(n, hw, hw) < 0.05, 255,
                        rs.randint(0, 8, (n, hw, hw))).astype(np.int32),
        losses=-rs.rand(n).astype(np.float32))


@pytest.mark.parametrize("image_dtype", ["bfloat16", "uint8"])
def test_buffer_add_batch_matches_jax(image_dtype):
    """Six batches of 4 into 7 slots with injected uniforms: slots, class
    counts, label masks, importances, task ids, class counts at store time,
    labels, images and num_seen bit-identical after every batch."""
    rs = np.random.RandomState(9)
    jdt = {"bfloat16": jnp.bfloat16, "uint8": jnp.uint8}[image_dtype]
    tdt = {"bfloat16": torch.bfloat16, "uint8": torch.uint8}[image_dtype]
    jbuf = jax_buffer.init_buffer(7, (16, 16), (2, 2), 8, image_dtype=jdt)
    buf = buffer.init_buffer(7, (16, 16), (2, 2), 8, image_dtype=tdt, device="cpu")
    for b in range(6):
        it = buffer_items(rs, 4)
        if image_dtype == "uint8":  # canonical crops: normalized uint8 pixels
            it["images"] = np.asarray(transforms.normalize_image(
                torch.from_numpy(rs.randint(0, 256, (4, 16, 16, 3)).astype(np.uint8))))
        u = (rs.rand(4).astype(np.float32), rs.rand(4).astype(np.float32))
        jbuf = jax_buffer.add_batch(
            jbuf, None, *(jnp.asarray(it[k]) for k in ("images", "logits", "labels", "losses")),
            task_id=b // 3, n_classes=5 + b // 3, uniforms=tuple(map(jnp.asarray, u)))
        buffer.add_batch(buf, *(torch.from_numpy(it[k]) for k in
                                ("images", "logits", "labels", "losses")),
                         task_id=b // 3, n_classes=5 + b // 3,
                         uniforms=tuple(map(torch.from_numpy, u)))
        assert buf.num_seen == int(jbuf.num_seen) == 4 * (b + 1)
        for f in ("valid", "task_ids", "n_classes", "label_mask", "class_counts", "labels",
                  "importance"):
            np.testing.assert_array_equal(getattr(buf, f).numpy(),
                                          np.asarray(getattr(jbuf, f)), err_msg=f)
        np.testing.assert_array_equal(buf.images.float().numpy(),
                                      np.asarray(jbuf.images).astype(np.float32))
        np.testing.assert_array_equal(buf.logits.float().numpy(),
                                      np.asarray(jbuf.logits).astype(np.float32))
    scores = buffer._eviction_scores(buf)
    close(scores, jax_buffer._eviction_scores(jbuf))
    # sample on injected Gumbel keys: the same slots and contents
    key = jax.random.PRNGKey(3)
    ref = jax_buffer.sample(jbuf, key, 5)
    got = buffer.sample(buf, 5, keys=torch.from_numpy(
        np.array(jax.random.gumbel(key, (buf.size,)))))
    np.testing.assert_array_equal(got["indices"].numpy(), np.asarray(ref["indices"]))
    for k in ("images", "logits", "labels", "n_classes"):
        close(got[k], ref[k], rtol=0, scale_atol=0)
    assert got["labels"].dtype == torch.int32 and got["images"].dtype == torch.float32
    drawn = buffer.sample(buf, 7, rng.key(0))
    assert sorted(drawn["indices"].tolist()) == list(range(7))


@pytest.mark.parametrize("same_task", [False, True])
def test_init_buffer_defaults_to_the_card(monkeypatch, same_task):
    """The buffer goes to the card unless the caller asks for the CPU:
    where torch sees no CUDA device the default raises, for the buffer and
    for the method's ``init_buffer``.  On the CPU the method's buffer has
    JAX's slot count (one partition per task with ``same_task``), shapes
    and storage dtypes."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    task = dict(task_id=1, initial_classes=5, increment=1, num_classes=8, n_tasks=2)
    kw = dict(buffer_size=3, same_task=same_task, use_bg_detector=True)
    m = create_method("loss.BACSLoss", **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        buffer.init_buffer(3, (16, 16), (2, 2), 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.init_buffer(TaskInfo(**task), (16, 16), (2, 2))
    buf = m.init_buffer(TaskInfo(**task), (16, 16), (2, 2), device="cpu")
    jbuf = jax_create_method("loss.BACSLoss", **kw).init_buffer(
        JaxTaskInfo(**task), (16, 16), (2, 2))
    assert buf.size == jbuf.images.shape[0] == (6 if same_task else 3)
    for f in ("images", "logits", "labels", "importance", "label_mask", "task_ids",
              "n_classes", "valid", "class_counts"):
        got, ref = getattr(buf, f), getattr(jbuf, f)
        assert got.device.type == "cpu" and tuple(got.shape) == ref.shape, f
        assert str(got.dtype).removeprefix("torch.") == str(ref.dtype), f


def test_uint8_image_round_trip_matches_jax():
    """uint8 pixels -> normalized -> uint8 storage -> normalized, exactly as
    JAX, and ``denormalize_image`` equal."""
    px = np.random.RandomState(10).randint(0, 256, (2, 5, 6, 3)).astype(np.uint8)
    norm = transforms.normalize_image(torch.from_numpy(px))
    close(norm, jax_transforms.normalize_image(jnp.asarray(px)), rtol=0, scale_atol=0)
    enc = buffer._encode_image(norm, torch.uint8)
    np.testing.assert_array_equal(enc.numpy(), px)
    np.testing.assert_array_equal(
        enc.numpy(), np.asarray(jax_buffer._encode_image(jnp.asarray(norm.numpy()), jnp.uint8)))
    close(buffer._decode_image(enc), jax_buffer._decode_image(jnp.asarray(px)), rtol=0,
          scale_atol=0)
    np.testing.assert_array_equal(
        transforms.denormalize_image(norm * 1.01).numpy(),
        np.asarray(jax_transforms.denormalize_image(jnp.asarray(norm.numpy() * 1.01))))


# ---------------------------------------------------------------- detector


def detector_pair(rs, d_in=32, n_tasks=3):
    jdet = JaxBgDetector(in_channels=d_in, n_tasks=n_tasks, dropout_rate=0.0)
    x = rs.randn(2, 5, 6, d_in).astype(np.float32)
    v = jdet.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    params = randomize_abn(v["params"], rs)
    stats = randomize_abn(v["batch_stats"], rs)
    det = BgDetector(d_in, n_tasks, dropout_rate=0.0)
    load_flax_variables(det, params, stats)
    return jdet, det, {"params": params, "batch_stats": stats}, x


def test_bg_detector_matches_flax():
    """Trunk in train mode (output rtol 1e-5, running statistics: momentum
    0.9 and the biased variance) and eval mode; the seen map of one task
    and the seen-probabilities of all, x16 with aligned corners, with the
    gradient of the head (and, without stop_grads, of the features)."""
    rs = np.random.RandomState(11)
    jdet, det, v, x = detector_pair(rs)
    ref, mut = jdet.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    got = det.train().trunk(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    close(got, ref)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        close(getattr(det.base_bn, name), mut["batch_stats"]["base_bn"][key])
    ref_eval = jdet.apply({**v, "batch_stats": mut["batch_stats"]}, jnp.asarray(x), train=False)
    close(det.eval().trunk(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1),
          ref_eval)

    pen = np.maximum(rs.randn(2, 3, 4, 8), 0).astype(np.float32)
    protos = rs.randn(3, 8).astype(np.float32)
    protos[2] = pen[0, 0, 0]  # a feature equal to its prototype: |.| at 0
    jdet8, det8, v8, _ = detector_pair(rs, d_in=32, n_tasks=3)
    v8["params"]["head_kernel"] = rs.randn(3, 8, 1).astype(np.float32)
    det8.head_kernel = torch.nn.Parameter(torch.from_numpy(v8["params"]["head_kernel"]))
    for stop in (True, False):
        def jfn(p, x):
            out = jdet8.apply({**v8, "params": p}, x, jnp.asarray(protos), 2, stop,
                              method="seen_map_task")
            return jnp.sum(out * jnp.arange(out.size).reshape(out.shape) / out.size), out
        (_, ref_map), (ref_g, ref_gx) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
            v8["params"], jnp.asarray(pen))
        det8.zero_grad()
        xt = torch.from_numpy(pen).requires_grad_()
        out = det8.seen_map_task(xt, torch.from_numpy(protos), 2, stop)
        (out * torch.arange(out.numel()).reshape(out.shape) / out.numel()).sum().backward()
        assert out.shape == (2, 48, 64, 1)
        close(out, ref_map)
        close(det8.head_kernel.grad, ref_g["head_kernel"])
        close(det8.head_bias.grad, ref_g["head_bias"])
        if stop:
            assert xt.grad is None
        else:
            close(xt.grad, ref_gx)
    ref_p = jdet8.apply(v8, jnp.asarray(pen), jnp.asarray(protos), 2, method="seen_probs")
    close(det8.seen_probs(torch.from_numpy(pen), torch.from_numpy(protos), 2), ref_p)


def test_flax_round_trip_with_the_detector():
    """A JAX DeepLabV3 with the detector: every Flax leaf maps to a
    state_dict key of the port's model and back, ``head_kernel`` and
    ``head_bias`` untransposed; the forward's penultimate output (the trunk)
    agrees in eval mode."""
    jm = JaxDeepLabV3(num_classes=21, backbone_name="resnet18", n_tasks=6,
                      use_bg_detector=True)
    x = np.random.RandomState(12).randn(1, 64, 64, 3).astype(np.float32)
    v = jax.jit(lambda k, x: jm.init(k, x, train=False))(jax.random.PRNGKey(1), x)
    model = create_network("deeplab", 21, n_tasks=6, use_bg_detector=True,
                           backbone="resnet18")
    load_flax_variables(model, v["params"], v["batch_stats"])
    sd = model.state_dict()
    assert sd["seen_fg_network.head_kernel"].shape == (6, 128, 1)
    np.testing.assert_array_equal(sd["seen_fg_network.head_bias"].numpy(),
                                  np.asarray(v["params"]["seen_fg_network"]["head_bias"]))
    params, stats = state_dict_to_flax(sd)
    flat = lambda t: jax.tree_util.tree_leaves_with_path(t)  # noqa: E731
    assert len(flat(params)) == len(flat(v["params"]))
    for (path, a), (path2, b) in zip(flat(params), flat(v["params"])):
        assert path == path2
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert set(flax_to_state_dict(params, stats)) == set(sd)
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, jnp.asarray(x))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    close(got.penultimate, ref.penultimate, scale_atol=1e-5)
    assert got.penultimate.shape[-1] == jm.penultimate_dim == 128
    assert model.penultimate_stats_keys == jm.penultimate_stats_keys


# ---------------------------------------------------------------- prototypes and terms


def test_prototype_fold_matches_jax():
    """``label_task_ids`` (half to even) exactly; the running-mean fold
    rtol 1e-5, a task that gets no pixel kept as it was."""
    rs = np.random.RandomState(13)
    labels = rs.randint(0, 18, (2, 32, 32)).astype(np.int32)
    labels[rs.rand(*labels.shape) < 0.1] = 255
    jt, t = JaxTaskInfo(**TASK1), TaskInfo(**TASK1)
    np.testing.assert_array_equal(label_task_ids(torch.from_numpy(labels), t).numpy(),
                                  np.asarray(jax_label_task_ids(jnp.asarray(labels), jt)))
    pen = rs.randn(2, 4, 4, 8).astype(np.float32)
    protos, counts = rs.randn(6, 8).astype(np.float32), np.float32([5, 0, 2, 0, 0, 0])
    ref = jax_update_prototypes(jnp.asarray(protos), jnp.asarray(counts), jnp.asarray(pen),
                                jnp.asarray(labels), jt)
    got = update_task_prototypes(torch.from_numpy(protos), torch.from_numpy(counts),
                                 torch.from_numpy(pen), torch.from_numpy(labels), t)
    close(got[0], ref[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


@pytest.mark.parametrize("mode", ["reference", "per_sample"])
@pytest.mark.parametrize("n_classes", [[16, 16, 16, 16], [16, 15, 16, 17], [15, 16, 14, 15]])
def test_dark_logits_transplant_matches_jax(mode, n_classes):
    """The alpha term given sem logits and a replayed batch, both transplant
    modes (the reference's fixed-size unique made on the device), rtol
    1e-5."""
    rs = np.random.RandomState(14)
    sem = rs.randn(4, 3, 3, 17).astype(np.float32)
    mem = dict(logits=rs.randn(4, 3, 3, 21).astype(np.float32),
               n_classes=np.int32(n_classes))
    kw = dict(use_bg_detector=True, transplant_mode=mode)
    jctx = type("Ctx", (), {"n_cur": 17})()
    ref = jax_create_method("loss.BACSLoss", **kw)._dark_from_sem(
        jctx, jnp.asarray(sem), {k: jnp.asarray(v) for k, v in mem.items()})
    ctx = ModelContext(TaskInfo(**TASK1))
    got = create_method("loss.BACSLoss", **kw)._dark_from_sem(
        ctx, torch.from_numpy(sem), {k: torch.from_numpy(v) for k, v in mem.items()})
    close(got, ref)


def test_teacher_distill_matches_jax():
    """The teacher distillation (in chunks, recomputed in the backward):
    value rtol 1e-5 and the gradient of the student embedding within 1e-5
    of its largest entry; a fully masked row stays finite."""
    rs = np.random.RandomState(15)
    old, new = (rs.randn(3, 4, 4, 8).astype(np.float32) for _ in range(2))
    mask = rs.randint(0, 3, (3, 64, 64)).astype(np.int32)
    mask[0, 5] = 1  # a row with no background pixel
    seen = rs.rand(3, 64, 64, 2).astype(np.float32)
    jm = jax_create_method("loss.BACSLoss", use_bg_detector=True)
    ref, ref_g = jax.jit(jax.value_and_grad(lambda n: jm._teacher_distill(
        jnp.asarray(old), n, jnp.asarray(seen), jnp.asarray(mask))))(jnp.asarray(new))
    nt = torch.from_numpy(new).requires_grad_()
    got = create_method("loss.BACSLoss", use_bg_detector=True)._teacher_distill(
        torch.from_numpy(old), nt, torch.from_numpy(seen), torch.from_numpy(mask))
    got.backward()
    close(got, ref)
    close(nt.grad, ref_g, rtol=0, scale_atol=1e-5)


def test_bacs_options_not_ported_raise():
    """The four options build and set JAX's flags
    (``tests/test_torch_bacs_options.py`` holds their steps to JAX)."""
    for kw in (dict(mixup=True), dict(merged_replay=True), dict(pseudo_label=True),
               dict(use_cosine_dist=True)):
        (flag, on), = kw.items()
        assert getattr(create_method("loss.BACSLoss", **kw), flag) is on
        assert getattr(jax_create_method("loss.BACSLoss", **kw), flag) is on
    # pseudo-labels are off whenever the weighted CE is on (reference :60-61)
    assert not create_method("loss.BACSLoss", pseudo_label=True,
                             bg_weighted_ce=True).pseudo_label
    with pytest.raises(ValueError, match="transplant_mode"):
        create_method("bacs", transplant_mode="nonsense")
    # BACS extends ER and overrides its step and end_task; ER itself is
    # ported (tests/test_torch_more_methods_step.py)
    from bacs_tpu_torch.methods.er import ExperienceReplayMethod

    m = create_method("bacs", use_bg_detector=True)
    assert isinstance(m, ExperienceReplayMethod)
    for hook in ("compute_loss", "end_task"):
        assert getattr(type(m), hook) is not getattr(ExperienceReplayMethod, hook), hook
    for name in ("er", "loss.ExperienceReplay"):
        assert type(create_method(name)) is ExperienceReplayMethod
