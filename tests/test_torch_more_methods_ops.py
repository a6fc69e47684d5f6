"""The ops of the ER, SDR and iCaRL slice against their JAX counterparts, on
the CPU.

iCaRL's BCE (``icarl_criterion``), the nearest-downsampled argmax of an
upsampled teacher (``upsampled_argmax_nearest``), each SDR term and its
class-prototype fold (the prototype distillation on both sides of the
fused-CE gate and in sequential mode), ER's partition scores (JAX's
``nanmedian``: the mean of the two middle values of an even count, 10.0
for an empty partition), the buffer's per-task sample on injected Gumbel
keys and ER's reservoir add into a task's partition on injected uniforms.
Inputs are made with numpy from a seed and fed to both packages; the
tolerance is stated per test.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bacs_tpu.methods.er as jax_er
from bacs_tpu.methods.base import ModelContext as JaxModelContext
from bacs_tpu.methods.sdr import SDRMethod as JaxSDR
from bacs_tpu.models.base import NetOutput as JaxNetOutput
from bacs_tpu.ops import losses as jax_losses
from bacs_tpu.ops import upsample_ce as jax_uce
from bacs_tpu.ops.interpolate import resize_bilinear as jax_resize_bilinear
from bacs_tpu.train import buffer as jax_buffer
from bacs_tpu.train.state import TaskInfo as JaxTaskInfo
from bacs_tpu_torch.methods import ModelContext, create_method
from bacs_tpu_torch.methods.er import ExperienceReplayMethod, nanmedian, partition_scores
from bacs_tpu_torch.methods.sdr import SDRMethod
from bacs_tpu_torch.models.base import NetOutput
from bacs_tpu_torch.ops.interpolate import resize_nearest
from bacs_tpu_torch.ops import losses
from bacs_tpu_torch.ops import upsample_ce as uce
from bacs_tpu_torch.train import buffer as port_buffer
from bacs_tpu_torch.train.state import TaskInfo
from torch_port_helpers import _one_thread  # noqa: F401

TASK1 = dict(task_id=1, initial_classes=16, increment=1, num_classes=21, n_tasks=6)
CROP, D = 64, 24


def close(got, ref, rtol=1e-5, scale_atol=1e-6):
    """got (torch) against ref (JAX or numpy): rtol, and atol a share of the
    largest reference value."""
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), ref, rtol=rtol,
                               atol=scale_atol * max(np.abs(ref).max(), 1e-30))


def labels_of(rs, n, hw, n_classes, bg=0.4, ignore=0.05):
    lab = rs.randint(0, n_classes, (n,) + tuple(hw)).astype(np.int32)
    lab[rs.rand(*lab.shape) < bg] = 0
    lab[rs.rand(*lab.shape) < ignore] = 255
    return lab


# ---------------------------------------------------------------- iCaRL


@pytest.mark.parametrize("bkg", [False, True])
def test_icarl_criterion_matches_jax(bkg):
    """Value and gradient rtol 1e-5 (the gradient also atol 1e-6 of its
    largest entry); logits exactly 0 at a tenth of the entries, where the
    |x| of the stable form takes JAX's derivative, ignored labels whose
    one-hot rows are zero, the mean over all pixels."""
    rs = np.random.RandomState(3)
    logits = (rs.randn(2, 9, 11, 7) * 2).astype(np.float32)
    logits[rs.rand(*logits.shape) < 0.1] = 0.0
    labels = labels_of(rs, 2, (9, 11), 7)
    old = 1 / (1 + np.exp(-rs.randn(2, 9, 11, 5).astype(np.float32)))
    fn = lambda x: jax_losses.icarl_criterion(  # noqa: E731
        x, jnp.asarray(labels), jnp.asarray(old), bkg=bkg)
    ref, ref_grad = jax.value_and_grad(fn)(jnp.asarray(logits))
    xt = torch.from_numpy(logits).requires_grad_()
    got = losses.icarl_criterion(xt, torch.from_numpy(labels), torch.from_numpy(old), bkg=bkg)
    got.backward()
    close(got, ref)
    close(xt.grad, ref_grad)


# ---------------------------------------------------------------- upsampled argmax


@pytest.mark.parametrize("shape,out_hw,down_hw", [
    ((2, 4, 4, 16), (64, 64), (4, 4)),
    ((3, 5, 7, 6), (37, 51), (5, 7)),
    ((1, 8, 8, 3), (128, 128), (16, 16)),
])
def test_upsampled_argmax_nearest_matches_jax(shape, out_hw, down_hw):
    """Equal labels to JAX's two einsums, and to the argmax of the whole
    upsampled tensor nearest-downsampled (logits of scale 3, no ties)."""
    rs = np.random.RandomState(4)
    sem = (rs.randn(*shape) * 3).astype(np.float32)
    ref = np.asarray(jax_uce.upsampled_argmax_nearest(jnp.asarray(sem), out_hw, down_hw))
    got = uce.upsampled_argmax_nearest(torch.from_numpy(sem), out_hw, down_hw)
    np.testing.assert_array_equal(got.numpy(), ref)
    full = resize_nearest(uce.upsample_plain(torch.from_numpy(sem), out_hw).argmax(-1), down_hw)
    np.testing.assert_array_equal(got.numpy(), full.numpy())


# ---------------------------------------------------------------- SDR


def sdr_inputs(seed=5, n=2, h=4):
    """feats [n, h, h, D] (mostly positive, as after the backbone's leaky
    activations), labels [n, 64, 64] of 17 classes, class prototypes and
    counts [21, D] (the first 17 set), the teacher's sem logits [n, h, h, 16]."""
    rs = np.random.RandomState(seed)
    feats = (rs.rand(n, h, h, D) * 2 - 0.2).astype(np.float32)
    labels = labels_of(rs, n, (CROP, CROP), 17)
    protos = np.zeros((21, D), np.float32)
    protos[:17] = rs.rand(17, D).astype(np.float32)
    counts = np.zeros(21, np.float32)
    counts[:17] = rs.randint(0, 40, 17).astype(np.float32)
    sem_old = (rs.randn(n, h, h, 16) * 3).astype(np.float32)
    return feats, labels, protos, counts, sem_old


def jax_state(protos, counts):
    return types.SimpleNamespace(class_prototypes=jnp.asarray(protos),
                                 class_proto_counts=jnp.asarray(counts))


def port_state(protos, counts):
    return types.SimpleNamespace(class_prototypes=torch.from_numpy(protos.copy()),
                                 class_proto_counts=torch.from_numpy(counts.copy()))


@pytest.mark.parametrize("task_id,sequential", [(1, False), (1, True), (0, False)])
def test_sdr_class_prototypes_match_jax(task_id, sequential):
    """The per-class running means and counts: rtol 1e-5 (the counts
    exactly); the background skipped at a task > 0 unless sequential."""
    feats, labels, protos, counts, _ = sdr_inputs()
    task = dict(TASK1, task_id=task_id)
    ref = JaxSDR(sequential_mode=sequential)._update_class_prototypes(
        jax_state(protos, counts), jnp.asarray(feats), jnp.asarray(labels),
        JaxTaskInfo(**task), None)
    got = SDRMethod(sequential_mode=sequential)._update_class_prototypes(
        port_state(protos, counts), torch.from_numpy(feats), torch.from_numpy(labels),
        TaskInfo(**task))
    close(got[0], ref[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


def jax_term(fn, feats):
    return jax.value_and_grad(fn)(jnp.asarray(feats))


def port_term(fn, feats):
    ft = torch.from_numpy(feats).requires_grad_()
    val = fn(ft)
    val.backward()
    return val, ft.grad


@pytest.mark.parametrize("seed", [5, 6])
def test_sdr_clustering_separation_matches_jax(seed):
    """Value and gradient in the features, rtol 1e-5 (atol 1e-6 of the
    largest gradient); one class of the labels made absent, so the
    recurrence skips it."""
    feats, labels, protos, _, _ = sdr_inputs(seed)
    labels[labels == 7] = 0
    jt, pt = JaxTaskInfo(**TASK1), TaskInfo(**TASK1)
    ref, ref_g = jax_term(lambda f: JaxSDR()._clustering_separation(
        jnp.asarray(labels), f, jnp.asarray(protos), jt), feats)
    got, got_g = port_term(lambda f: SDRMethod()._clustering_separation(
        torch.from_numpy(labels), f, torch.from_numpy(protos), pt), feats)
    close(got, ref, rtol=1e-5)
    close(got_g, ref_g, rtol=1e-5)


def test_sdr_clustering_recurrence_matches_jax_per_class_count():
    """The "divide by every present class" recurrence with 1 to 17 classes
    present: rtol 1e-5 each."""
    feats, labels, protos, _, _ = sdr_inputs(7)
    jt, pt = JaxTaskInfo(**TASK1), TaskInfo(**TASK1)
    for keep in (1, 2, 5, 17):
        lab = np.where(labels < keep, labels, 0).astype(np.int32)
        ref = JaxSDR()._clustering_separation(jnp.asarray(lab), jnp.asarray(feats),
                                              jnp.asarray(protos), jt)
        got = SDRMethod()._clustering_separation(torch.from_numpy(lab),
                                                 torch.from_numpy(feats),
                                                 torch.from_numpy(protos), pt)
        close(got, ref, rtol=1e-5)


@pytest.mark.parametrize("case", ["mixed", "only_bg", "ignore_group"])
def test_sdr_feature_sparsification_matches_jax(case):
    """Value and gradient rtol 1e-5 (atol 1e-6 of the largest gradient):
    the ignored pixels a group of their own, and 0 with only background."""
    feats, labels, *_ = sdr_inputs(8)
    if case == "only_bg":
        labels[:] = 0
    elif case == "ignore_group":
        labels[:, :32] = 255
    jt, pt = JaxTaskInfo(**TASK1), TaskInfo(**TASK1)
    ref, ref_g = jax_term(lambda f: JaxSDR()._feature_sparsification(
        jnp.asarray(labels), f, jt), feats)
    got, got_g = port_term(lambda f: SDRMethod()._feature_sparsification(
        torch.from_numpy(labels), f, pt), feats)
    close(got, ref)
    close(got_g, ref_g)
    if case == "only_bg":
        assert float(got.detach()) == 0.0


@pytest.mark.parametrize("fused,sequential", [(True, False), (False, False), (True, True)])
def test_sdr_proto_distillation_matches_jax(fused, sequential):
    """Value and gradient rtol 1e-5 (atol 1e-6 of the largest gradient):
    through the fused-CE gate (the teacher's argmax from the picked rows and
    columns, ``upsampled_argmax_nearest``), the composed path (the argmax
    of the full-resolution logits, nearest-downsampled) and sequential
    mode (the labels themselves)."""
    feats, labels, protos, _, sem_old = sdr_inputs(9)
    labels[:, :, :20] = 0  # background for the teacher to label
    jctx = JaxModelContext(model=None, task=JaxTaskInfo(**TASK1), fused_ce=fused)
    jold = JaxNetOutput(logits=jax_resize_bilinear(jnp.asarray(sem_old), (CROP, CROP)),
                        sem_logits=jnp.asarray(sem_old), penultimate=None, attentions=())
    ctx = ModelContext(TaskInfo(**TASK1), fused_ce=fused)
    pold = NetOutput(torch.from_numpy(sem_old), None, (), (CROP, CROP))
    ref, ref_g = jax_term(lambda f: JaxSDR(sequential_mode=sequential)._proto_distillation(
        jctx, jold, f, jnp.asarray(labels), jnp.asarray(protos), jctx.task), feats)
    got, got_g = port_term(lambda f: SDRMethod(sequential_mode=sequential)._proto_distillation(
        ctx, pold, f, torch.from_numpy(labels), torch.from_numpy(protos), ctx.task), feats)
    assert float(ref) > 0
    close(got, ref)
    close(got_g, ref_g)


# ---------------------------------------------------------------- ER


def er_scores_jax(importance, valid, n_prev, size, monkeypatch):
    """JAX's partition probabilities: ``_sample_replay`` at task ``n_prev``
    with ``jax.random.choice`` and the buffer's sample replaced by
    recorders."""
    seen = {}

    def choice(key, n, p=None):
        seen["p"] = np.asarray(p)
        return jnp.zeros((), jnp.int32)

    monkeypatch.setattr(jax.random, "choice", choice)
    monkeypatch.setattr(jax_er.buffer_lib, "sample", lambda buf, rng, n, task_id=None: {})
    state = types.SimpleNamespace(buffer=types.SimpleNamespace(
        importance=jnp.asarray(importance), valid=jnp.asarray(valid)))
    jax_er.ExperienceReplayMethod(buffer_size=size)._sample_replay(
        state, jax.random.PRNGKey(0), n_prev)
    return seen["p"]


def test_er_partition_scores_match_jax(monkeypatch):
    """Four partitions of 6 slots: 4 set (an even count: JAX's median is the
    mean of the two middle values, ``torch.nanmedian`` the lower one), 3
    set, none set (10.0) and 6 set with a repeated value; probabilities
    rtol 1e-6.  The medians themselves equal ``np.nanmedian``'s."""
    size, n_prev = 6, 4
    rs = np.random.RandomState(10)
    importance = -rs.rand(n_prev * size).astype(np.float32) * 3
    importance[19:21] = importance[18]
    valid = np.zeros(n_prev * size, bool)
    valid[[0, 2, 3, 5]] = True
    valid[[6, 7, 10]] = True
    valid[18:] = True
    ref = er_scores_jax(importance, valid, n_prev, size, monkeypatch)
    got = partition_scores(torch.from_numpy(importance), torch.from_numpy(valid), n_prev, size)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)
    neg = np.where(valid, -importance, np.nan).reshape(n_prev, size)
    med = nanmedian(torch.from_numpy(neg))
    np.testing.assert_allclose(med.numpy()[[0, 1, 3]], np.nanmedian(neg[[0, 1, 3]], axis=1),
                               rtol=1e-6)
    assert bool(torch.isnan(med[2]))
    lower = torch.from_numpy(neg[0]).nanmedian()
    assert float(lower) < float(med[0])  # the trap: torch takes the lower value


def test_buffer_sample_by_task_matches_jax():
    """``sample(task_id=)`` on the Gumbel keys JAX draws from its key: the
    same slots (only valid slots of that task), images, logits, labels and
    class counts, exactly."""
    rs = np.random.RandomState(11)
    n = 20
    task_ids = rs.randint(0, 3, n).astype(np.int32)
    valid = rs.rand(n) < 0.8
    fields = dict(
        images=rs.randn(n, 8, 8, 3).astype(np.float32),
        logits=rs.randn(n, 2, 2, 6).astype(np.float32),
        labels=rs.randint(0, 6, (n, 8, 8)).astype(np.uint8),
        importance=-rs.rand(n).astype(np.float32),
        label_mask=rs.rand(n, 7) < 0.5, task_ids=task_ids,
        n_classes=rs.randint(3, 6, n).astype(np.int32), valid=valid,
        class_counts=np.zeros(7, np.int32))
    jbuf = jax_buffer.BufferState(**{k: jnp.asarray(v) for k, v in fields.items()},
                                  num_seen=jnp.int32(n))
    pbuf = port_buffer.BufferState(**{k: torch.from_numpy(v) for k, v in fields.items()},
                                   num_seen=n)
    for task, key in ((1, 3), (2, 4), (0, 5)):
        rng = jax.random.PRNGKey(key)
        count = int((valid & (task_ids == task)).sum())
        ref = jax_buffer.sample(jbuf, rng, count, task_id=jnp.int32(task))
        keys = torch.from_numpy(np.array(jax.random.gumbel(rng, (n,))))
        got = port_buffer.sample(pbuf, count, keys=keys, task_id=torch.tensor(task))
        np.testing.assert_array_equal(got["indices"].numpy(), np.asarray(ref["indices"]))
        assert set(got["indices"].tolist()) == set(np.flatnonzero(valid & (task_ids == task)))
        for k in ("images", "logits", "labels", "n_classes"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_er_buffer_add_into_partition_matches_jax():
    """ER's ``_buffer_add`` into task 1's partition of a 2 x 4-slot f32
    buffer, twice (the second batch evicts by the blended scores), on the
    uniforms JAX draws from its key: every slot field, the class counts and
    the reservoir count equal; task 0's partition untouched."""
    rs = np.random.RandomState(12)
    size, n_tasks = 4, 2
    task = dict(task_id=1, initial_classes=3, increment=1, num_classes=5, n_tasks=n_tasks)
    jm = jax_er.ExperienceReplayMethod(buffer_size=size, buffer_dtype="float32")
    pm = create_method("er", buffer_size=size, buffer_dtype="float32")
    assert isinstance(pm, ExperienceReplayMethod)
    jbuf = jm.init_buffer(JaxTaskInfo(**task), (8, 8), (2, 2))
    pbuf = pm.init_buffer(TaskInfo(**task), (8, 8), (2, 2), device="cpu")
    part = pm._partition(1)
    assert part == jm._partition(1) == (size, size)
    for b, key in enumerate((21, 22)):
        image = rs.randn(3, 8, 8, 3).astype(np.float32)
        sem = rs.randn(3, 2, 2, 5).astype(np.float32)
        labels = labels_of(rs, 3, (8, 8), 4)
        loss = -rs.rand(3).astype(np.float32)
        rng = jax.random.PRNGKey(key)
        jbuf = jm._buffer_add(jbuf, rng, *map(jnp.asarray, (image, sem, labels, loss)),
                              JaxTaskInfo(**task), part)
        k1, k2 = jax.random.split(rng)
        uniforms = tuple(torch.from_numpy(np.array(jax.random.uniform(k, (3,))))
                         for k in (k1, k2))
        pm._buffer_add(pbuf, *map(torch.from_numpy, (image, sem, labels, loss)),
                       TaskInfo(**task), part, uniforms=uniforms)
    for f in ("images", "logits", "labels", "importance", "label_mask", "task_ids",
              "n_classes", "valid", "class_counts"):
        np.testing.assert_array_equal(getattr(pbuf, f).numpy(), np.asarray(getattr(jbuf, f)),
                                      err_msg=f)
    assert pbuf.num_seen == int(jbuf.num_seen) == 6
    assert not bool(pbuf.valid[:size].any()) and bool(pbuf.valid[size:].all())
