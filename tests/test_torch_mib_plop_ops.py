"""The MiB and PLOP slice's ops against their JAX counterparts, on the CPU.

The five losses (unbiased CE and KD, the pixel entropy, local POD and the
features distillation), the public ops of K6 (unbiased upsample+CE), K7
(unbiased KD of an upsampled pair), K8 (per-image upsample+CE, its backward
with a per-image cotangent) and K9 (PLOP's pseudo-labels) through the
port's wrappers on CPU tensors (their plain versions; the JAX ops run their
jnp branches off the TPU), the MiB head imprinting and PLOP's histogram
median.  Inputs are made with numpy from a seed and fed to both packages;
the tolerance is stated per test.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bacs_tpu.methods.plop import _median_from_histogram as jax_median
from bacs_tpu.ops import losses as jax_losses
from bacs_tpu.ops import upsample_ce as jax_uce
from bacs_tpu.train import learner as jax_learner
from bacs_tpu.train.state import TaskInfo as JaxTaskInfo
from bacs_tpu.train.state import TrainState as JaxTrainState
from bacs_tpu_torch.methods.plop import _median_from_histogram
from bacs_tpu_torch.models import create_network
from bacs_tpu_torch.ops import losses
from bacs_tpu_torch.ops import upsample_ce as uce
from bacs_tpu_torch.ops import upsample_pseudo
from bacs_tpu_torch.ops.upsample_tiles import kmats
from bacs_tpu_torch.train import learner
from bacs_tpu_torch.train.state import TaskInfo, TrainState
from bacs_tpu_torch.utils.flax_weights import state_dict_to_flax
from torch_port_helpers import _one_thread  # noqa: F401

TASK1 = dict(task_id=1, initial_classes=16, increment=1, num_classes=21, n_tasks=6)


def close(got, ref, rtol=1e-5, scale_atol=1e-6):
    """got (torch) against ref (JAX or numpy): rtol, and atol a share of the
    largest reference value."""
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), ref, rtol=rtol,
                               atol=scale_atol * max(np.abs(ref).max(), 1e-30))


def sem_labels(shape, out_hw, seed, old_share=0.4, ignore_share=0.08):
    """sem logits, labels in [0, C) with ~old_share below C - 1 forced to
    old classes, ~ignore_share ignored."""
    rs = np.random.RandomState(seed)
    sem = (rs.randn(*shape) * 3).astype(np.float32)
    c = shape[-1]
    labels = rs.randint(0, c, (shape[0],) + tuple(out_hw)).astype(np.int32)
    labels[rs.rand(*labels.shape) < old_share] = 0
    labels[rs.rand(*labels.shape) < ignore_share] = 255
    return sem, labels, rs


# ---------------------------------------------------------------- losses


@pytest.mark.parametrize("reduction", ["mean", "none"])
def test_unbiased_cross_entropy_matches_jax(reduction):
    """Value and gradient rtol 1e-5; labels below, at and above old_classes
    and ignored ones."""
    rs = np.random.RandomState(1)
    logits = (rs.randn(2, 6, 7, 9) * 2).astype(np.float32)
    labels = rs.randint(0, 9, (2, 6, 7)).astype(np.int32)
    labels[rs.rand(*labels.shape) < 0.1] = 255
    lab = jnp.asarray(labels)
    fn = lambda x: jnp.sum(jax_losses.unbiased_cross_entropy(  # noqa: E731
        x, lab, 5, reduction=reduction) ** 2)
    ref = jax_losses.unbiased_cross_entropy(jnp.asarray(logits), lab, 5, reduction=reduction)
    ref_grad = jax.grad(fn)(jnp.asarray(logits))
    xt = torch.from_numpy(logits).requires_grad_()
    got = losses.unbiased_cross_entropy(xt, torch.from_numpy(labels), 5, reduction=reduction)
    (got ** 2).sum().backward()
    close(got, ref)
    close(xt.grad, ref_grad)


@pytest.mark.parametrize("alpha", [1.0, 0.7])
def test_unbiased_knowledge_distillation_matches_jax(alpha):
    """Value and student gradient rtol 1e-5, the mean over every pixel."""
    rs = np.random.RandomState(2)
    new = (rs.randn(2, 5, 6, 9) * 2).astype(np.float32)
    old = (rs.randn(2, 5, 6, 6) * 2).astype(np.float32)
    fn = lambda x: jax_losses.unbiased_knowledge_distillation(  # noqa: E731
        x, jnp.asarray(old), alpha=alpha)
    ref, ref_grad = jax.value_and_grad(fn)(jnp.asarray(new))
    xt = torch.from_numpy(new).requires_grad_()
    got = losses.unbiased_knowledge_distillation(xt, torch.from_numpy(old), alpha=alpha)
    got.backward()
    close(got, ref)
    close(xt.grad, ref_grad)


def test_pixel_entropy_matches_jax():
    """Normalised entropy of softmax probabilities (some one-hot), rtol 1e-6."""
    rs = np.random.RandomState(3)
    x = (rs.randn(2, 5, 7, 16) * 3).astype(np.float32)
    x[0, 0, 0, 3] = 80.0  # a pixel whose probabilities round to one-hot
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x), axis=-1))
    ref = jax_losses.pixel_entropy(jnp.asarray(probs))
    close(losses.pixel_entropy(torch.from_numpy(probs)), ref, rtol=1e-6, scale_atol=1e-7)


@pytest.mark.parametrize("shape", [(2, 8, 8, 5), (1, 13, 11, 3)])
def test_local_pod_matches_jax(shape):
    """The embedding, element by element (the same flatten order), rtol
    1e-6; a size that the scales do not divide drops the same border."""
    x = np.random.RandomState(4).rand(*shape).astype(np.float32)
    ref = jax_losses.local_pod(jnp.asarray(x))
    got = losses.local_pod(torch.from_numpy(x))
    assert got.shape == ref.shape
    close(got, ref, rtol=1e-6)


@pytest.mark.parametrize("same", [False, True], ids=["distinct", "teacher-equals-student"])
def test_features_distillation_matches_jax(same):
    """PLOP's POD over five attention maps and the logits (the student's
    new-class channels summed into background), value rtol 1e-5 and the
    gradient of every student map within 1e-5 of its largest entry.  Where
    teacher and student maps are equal their distance is sqrt(1e-12), the
    value still rtol 1e-5 and the gradient finite: exactly 0 here, while
    JAX's is its rounding of ea - eb divided by 1e-6, so only the logits'
    gradient (not tied) is compared there."""
    rs = np.random.RandomState(5)
    shapes = [(2, 16, 16, 4), (2, 8, 8, 8), (2, 4, 4, 8), (2, 4, 4, 16), (2, 4, 4, 6)]
    new = [rs.randn(*s).astype(np.float32) for s in shapes] + [
        rs.randn(2, 4, 4, 17).astype(np.float32)]
    old = [(a if same else rs.randn(*a.shape).astype(np.float32)) for a in new[:-1]]
    old.append(new[-1][..., :16].copy() if same else rs.randn(2, 4, 4, 16).astype(np.float32))
    kw = dict(index_new_class=16, nb_current_classes=17, nb_new_classes=1)
    fn = lambda atts: jax_losses.features_distillation(  # noqa: E731
        [jnp.asarray(a) for a in old], atts, **kw)
    ref, ref_grads = jax.jit(jax.value_and_grad(fn))([jnp.asarray(a) for a in new])
    xs = [torch.from_numpy(a).requires_grad_() for a in new]
    got = losses.features_distillation([torch.from_numpy(a) for a in old], xs, **kw)
    got.backward()
    close(got, ref)
    for i, (x, r) in enumerate(zip(xs, ref_grads)):
        assert bool(torch.isfinite(x.grad).all())
        if same and i < len(xs) - 1:
            assert not bool(x.grad.any())
        else:
            close(x.grad, r, rtol=1e-5, scale_atol=1e-5)


# ---------------------------------------------------------------- K6, K7, K8


CASES = [((2, 5, 7, 6), (37, 51)), ((2, 4, 4, 17), (64, 64))]
IDS = ["odd", "16x"]


def with_vjp(fn, x, cotangent):
    """fn's outputs at x and the vector-Jacobian product of ``cotangent``,
    jitted: (outputs..., grad)."""
    @jax.jit
    def run(x):
        out, vjp = jax.vjp(fn, x)
        out = out if isinstance(out, tuple) else (out,)
        return (*out, vjp(cotangent)[0])
    return run(jnp.asarray(x))


@pytest.mark.parametrize("shape,out_hw", CASES, ids=IDS)
def test_upsampled_uce_sums_matches_jax(shape, out_hw):
    """K6's public op (its plain version here): the sum and the valid count
    rtol 1e-5 (the count exactly), d/dsem within 1e-5 of its largest entry,
    old classes C - 1; the mean over valid pixels too; no launch on the
    CPU."""
    sem, labels, _ = sem_labels(shape, out_hw, 6)
    old = shape[-1] - 1
    lab = jnp.asarray(labels)
    fn = lambda s: jax_uce.upsampled_uce_sums(s, lab, out_hw, old, 255, None)  # noqa: E731
    ref, ref_count, ref_grad = with_vjp(fn, sem, (jnp.float32(0.37), jnp.float32(0.0)))
    before = (uce.uce_sums.launches, uce.uce_dsem.launches)
    st = torch.from_numpy(sem).requires_grad_()
    got, count = uce.upsampled_uce_sums(st, torch.from_numpy(labels), out_hw, old)
    (got * 0.37).backward()
    assert (uce.uce_sums.launches, uce.uce_dsem.launches) == before
    assert float(count) == float(ref_count) == float((labels != 255).sum())
    close(got, ref)
    close(st.grad, ref_grad, scale_atol=1e-5)
    mean = uce.upsampled_unbiased_cross_entropy(torch.from_numpy(sem), torch.from_numpy(labels),
                                                out_hw, old)
    close(mean, jax_uce.upsampled_unbiased_cross_entropy(jnp.asarray(sem), lab, out_hw, old))


@pytest.mark.parametrize("alpha", [1.0, 0.7])
@pytest.mark.parametrize("shape,out_hw", CASES, ids=IDS)
def test_upsampled_ukd_sum_matches_jax(shape, out_hw, alpha):
    """K7's public op: the sum T rtol 1e-5, the student's gradient within
    1e-5 of its largest entry, none for the teacher; the mean -T / (N H W)
    as JAX's ``upsampled_unbiased_kd``."""
    rs = np.random.RandomState(7)
    sem = (rs.randn(*shape) * 3).astype(np.float32)
    sem_old = (rs.randn(*shape[:3], shape[-1] - 1) * 3).astype(np.float32)
    fn = lambda s: jax_uce.upsampled_ukd_sum(s, jnp.asarray(sem_old), out_hw,  # noqa: E731
                                             alpha, None)
    ref, ref_grad = with_vjp(fn, sem, jnp.float32(-0.6))
    st = torch.from_numpy(sem).requires_grad_()
    teacher = torch.from_numpy(sem_old).requires_grad_()
    got = uce.upsampled_ukd_sum(st, teacher, out_hw, alpha)
    (got * -0.6).backward()
    assert teacher.grad is None
    assert uce.ukd_sum.launches == uce.ukd_dsem.launches == 0
    close(got, ref)
    close(st.grad, ref_grad, scale_atol=1e-5)
    close(uce.upsampled_unbiased_kd(torch.from_numpy(sem), teacher, out_hw, alpha),
          jax_uce.upsampled_unbiased_kd(jnp.asarray(sem), jnp.asarray(sem_old), out_hw, alpha))


@pytest.mark.parametrize("shape,out_hw", CASES, ids=IDS)
def test_upsampled_ce_sums_per_image_matches_jax(shape, out_hw):
    """The per-image CE sums (K1's forward) and counts, rtol 1e-5 (counts
    exactly), and K8's backward for a per-image cotangent (the jnp branch of
    ``_ucespi_bwd``), within 1e-5 of the largest entry."""
    sem, labels, rs = sem_labels(shape, out_hw, 8)
    g = rs.uniform(0.1, 1.0, shape[0]).astype(np.float32)
    lab = jnp.asarray(labels)
    fn = lambda s: jax_uce.upsampled_ce_sums_per_image(s, lab, out_hw, 255, None)  # noqa: E731
    ref, ref_count, ref_grad = with_vjp(fn, sem, (jnp.asarray(g),
                                                  jnp.zeros(shape[0], jnp.float32)))
    st = torch.from_numpy(sem).requires_grad_()
    got, count = uce.upsampled_ce_sums_per_image(st, torch.from_numpy(labels), out_hw)
    (got * torch.from_numpy(g)).sum().backward()
    assert got.shape == count.shape == (shape[0],)
    assert uce.ce_dsem_per_image.launches == 0
    np.testing.assert_array_equal(count.numpy(), np.asarray(ref_count))
    close(got, ref)
    close(st.grad, ref_grad, scale_atol=1e-5)


# ---------------------------------------------------------------- K9


def entropy_margins(sem_old, out_hw, thresholds, max_entropy):
    """Per output pixel in f64: |entropy - threshold of the argmax| and the
    gap between the top two upsampled logits."""
    kh, kw = kmats(sem_old.shape, out_hw)
    up = np.einsum("Ww,nHwc->nHWc", kw, np.einsum("Hh,nhwc->nHwc", kh, sem_old.astype(np.float64)))
    p = np.exp(up - up.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    c = sem_old.shape[-1]
    ent = -(p * np.log(p + 1e-8)).mean(-1) / math.log(c + 1e-8) / max_entropy
    top2 = np.sort(up, axis=-1)[..., -2:]
    return np.abs(ent - thresholds[up.argmax(-1)]), top2[..., 1] - top2[..., 0]


@pytest.mark.parametrize("shape,out_hw", [((2, 5, 7, 6), (37, 51)), ((3, 4, 4, 16), (64, 64))],
                         ids=IDS)
def test_upsampled_plop_pseudo_labels_matches_jax(shape, out_hw):
    """K9's public op (its plain version here) against the JAX op: the new
    labels, num and den exactly, on inputs where no pixel's entropy lies
    within 1e-5 of its threshold and no top-2 logits within 1e-5 (drawn
    until so); labels of old classes, the new one and ignored."""
    rs = np.random.RandomState(9)
    sem_old = (rs.randn(*shape) * 2).astype(np.float32)
    c_old = shape[-1]
    labels = rs.randint(0, c_old + 1, (shape[0],) + out_hw).astype(np.int32)
    labels[rs.rand(*labels.shape) < 0.4] = 0
    labels[rs.rand(*labels.shape) < 0.08] = 255
    max_entropy = math.log(c_old + 1)
    while True:
        thresholds = rs.uniform(0.005, 0.06, 21).astype(np.float32)
        ent_gap, top_gap = entropy_margins(sem_old, out_hw, thresholds.astype(np.float64),
                                           max_entropy)
        if ent_gap.min() > 1e-5 and top_gap.min() > 1e-5:
            break
    ref = jax_uce.upsampled_plop_pseudo_labels(
        jnp.asarray(sem_old), jnp.asarray(labels), jnp.asarray(thresholds), out_hw,
        jnp.float32(max_entropy))
    got = upsample_pseudo.upsampled_plop_pseudo_labels(
        torch.from_numpy(sem_old), torch.from_numpy(labels), torch.from_numpy(thresholds),
        out_hw, torch.tensor(max_entropy, dtype=torch.float32))
    assert got[0].dtype == torch.int32 and upsample_pseudo.plop_pseudo_labels.launches == 0
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    new = got[0].numpy()
    bg = labels < c_old
    assert (new[~bg] == labels[~bg]).all()
    assert 0 < int(got[1].sum()) < int(got[2].sum()) == int(bg.sum())
    assert set(np.unique(new[bg])) - set(range(c_old)) == {255}


# ---------------------------------------------------------------- learner, median


def test_multihead_init_matches_jax():
    """MiB imprinting at task 1 (16 old classes, 1 new) on the head of a
    port network, against JAX ``multihead_init`` on the same weights as a
    Flax tree: the new class's kernel row is the background's, its bias and
    the background's are bg_bias - log 2; every other parameter unchanged.
    Task 0 changes nothing; the transformer learner raises on a network
    without TranSeg's class tokens."""
    torch.manual_seed(0)
    model = create_network("deeplab", 21, backbone="resnet18")
    with torch.no_grad():
        model.classifier_head.bias.uniform_(-1.0, 1.0)
    # copies: state_dict_to_flax's arrays share the tensors' memory
    params, stats = (jax.tree.map(np.array, t) for t in state_dict_to_flax(model.state_dict()))
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32),
                           params=jax.tree.map(jnp.asarray, params), batch_stats=stats,
                           opt_state=None, rng=jax.random.PRNGKey(0),
                           prototypes=None, proto_counts=None)
    ref = jax_learner.multihead_init(jstate, JaxTaskInfo(**TASK1)).params
    state = TrainState(model, None, None)
    assert learner.multihead_init(state, TaskInfo(task_id=0, **{
        k: v for k, v in TASK1.items() if k != "task_id"})) is state
    assert state_dict_to_flax(model.state_dict())[0]["classifier_head"]["bias"].tolist() == \
        params["classifier_head"]["bias"].tolist()
    learner.get_learner("learner.MultiHeadLearner")(state, TaskInfo(**TASK1))
    got, _ = state_dict_to_flax(model.state_dict())
    for name in ("kernel", "bias"):
        np.testing.assert_array_equal(got["classifier_head"][name],
                                      np.asarray(ref["classifier_head"][name]))
    head = got["classifier_head"]
    np.testing.assert_array_equal(head["kernel"][..., 16], head["kernel"][..., 0])
    assert head["bias"][16] == head["bias"][0] == np.float32(
        params["classifier_head"]["bias"][0] - math.log(2))
    assert got["backbone"]["conv1"]["kernel"].tobytes() == \
        params["backbone"]["conv1"]["kernel"].tobytes()
    assert learner.get_learner("singlehead") is learner.singlehead_init
    # the transformer learner needs TranSeg's class tokens
    assert learner.get_learner("learner.TransformerLearner") is learner.transformer_init
    with pytest.raises(ValueError, match="TranSeg"):
        learner.get_learner("learner.TransformerLearner")(state, TaskInfo(**TASK1))
    with pytest.raises(ValueError, match="unknown learner"):
        learner.get_learner("nonsense")


def test_median_from_histogram_matches_jax():
    """PLOP's histogram median, the reference's recurrence, against the JAX
    package's on random histograms of 21 classes, some empty, some with a
    single filled bin: equal to the last bit."""
    rs = np.random.RandomState(10)
    hist = rs.randint(0, 50, (21, 100)).astype(np.int64)
    hist[rs.rand(*hist.shape) < 0.6] = 0
    hist[[3, 7, 20]] = 0
    hist[5] = 0
    hist[5, 42] = 11
    got = _median_from_histogram(hist, base_threshold=0.001)
    ref = jax_median(hist.astype(np.int32), base_threshold=0.001)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.float32 and (got[[3, 7, 20]] == np.float32(0.001)).all()
