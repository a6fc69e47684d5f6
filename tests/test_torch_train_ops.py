"""The training slice's ops against their JAX counterparts, on the CPU.

Train-mode ABN (function and module), the upsample+CE loss and its
gradient, the confusion ops, cross-entropy, the optimizers and schedules.
Inputs are made with numpy from a seed and fed to both packages; the port
runs its plain versions (CPU tensors), the JAX package its jnp branches
(``_use_pallas`` is False off the TPU).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from bacs_tpu.models.norm import make_norm as jax_make_norm
from bacs_tpu.ops.abn_core import fused_abn as jax_fused_abn
from bacs_tpu.ops.confusion import (
    confusion_matrix as jax_confusion_matrix,
    iou_from_confusion as jax_iou_from_confusion,
)
from bacs_tpu.ops.losses import cross_entropy as jax_cross_entropy
from bacs_tpu.ops.upsample_ce import upsampled_cross_entropy as jax_uce
from bacs_tpu.ops.upsample_confusion import upsampled_confusion as jax_uconf
from bacs_tpu.train import optim as jax_optim
from bacs_tpu_torch.methods import create_method
from bacs_tpu_torch.models.norm import make_norm
from bacs_tpu_torch.ops.abn_core import fused_abn
from bacs_tpu_torch.ops.confusion import confusion_matrix, iou_from_confusion
from bacs_tpu_torch.ops.losses import cross_entropy
from bacs_tpu_torch.ops.upsample_ce import (
    ce_dsem,
    ce_sums_per_image,
    upsampled_ce_sums,
    upsampled_cross_entropy,
)
from bacs_tpu_torch.ops.upsample_confusion import upsampled_confusion
from bacs_tpu_torch.train import optim
from torch_port_helpers import _one_thread  # noqa: F401

EPS = 1e-5


# ---------------------------------------------------------------- train ABN


@pytest.mark.parametrize("slope", [0.01, 1.0], ids=["leaky", "identity"])
@pytest.mark.parametrize("shape", [(4, 6, 6, 8), (2, 5, 7, 16)])
def test_fused_abn_train_matches_jax(shape, slope):
    """Forward (y, mean, var) and backward (dx, dscale, dbias) against
    ``fused_abn`` and ``jax.vjp``, f32: rtol 1e-5, atol 1e-5 of the
    largest value.  Channel 0 has scale 0, which only ``_safe_scale`` keeps
    finite: its dscale recovers x_hat = (y - bias) / 1e-12 from y == bias,
    rounding noise in both packages, so it is checked finite, not equal."""
    rs = np.random.RandomState(1)
    c = shape[-1]
    x = (rs.randn(*shape) * 2 + 1).astype(np.float32)
    scale = (rs.rand(c) + 0.5).astype(np.float32) * rs.choice([-1, 1], c)
    scale[0] = 0.0
    bias = rs.randn(c).astype(np.float32)
    dy = rs.randn(*shape).astype(np.float32)

    ref, vjp = jax.vjp(lambda x, s, b: jax_fused_abn(x, s, b, EPS, slope, None),
                       jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    ref_grads = vjp((jnp.asarray(dy), jnp.zeros(c), jnp.zeros(c)))

    xt, st, bt = (torch.from_numpy(a).requires_grad_() for a in (x, scale, bias))
    before = fused_abn.launches
    got = fused_abn(xt, st, bt, EPS, slope)
    got[0].backward(torch.from_numpy(dy))
    assert fused_abn.launches == before  # CPU tensors take the plain apply
    assert not got[1].requires_grad and not got[2].requires_grad

    def close(a, b):
        a, b = np.asarray(a), b.detach().numpy()
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5 * np.abs(a).max())

    for r, g in zip(ref, got):
        close(r, g)
    close(ref_grads[0], xt.grad)
    close(ref_grads[2], bt.grad)
    close(np.asarray(ref_grads[1])[1:], st.grad[1:])
    assert np.isfinite(st.grad.numpy()).all()


@pytest.mark.parametrize(
    "kwargs", [{}, dict(activation="identity"), dict(pool=True)],
    ids=["leaky", "identity", "stem-pool"],
)
def test_abn_module_train_matches_jax(kwargs):
    """Train-mode ABN against the Flax ABN: output and the updated running
    mean and variance (momentum 0.1, Bessel factor n/(n-1)), f32."""
    rs = np.random.RandomState(2)
    c = 16
    x = (rs.randn(2, 10, 8, c) * 2 + 0.5).astype(np.float32)
    v = dict(scale=rs.uniform(0.5, 1.5, c), bias=rs.uniform(-0.3, 0.3, c),
             mean=rs.uniform(-0.3, 0.3, c), var=rs.uniform(0.5, 2.0, c))
    v = {k: a.astype(np.float32) for k, a in v.items()}
    jm = jax_make_norm("iabn_sync")(c, **kwargs)
    ref, mut = jm.apply(
        {"params": {"scale": v["scale"], "bias": v["bias"]},
         "batch_stats": {"mean": v["mean"], "var": v["var"]}},
        jnp.asarray(x), use_running_average=False, mutable=["batch_stats"],
    )
    m = make_norm("iabn_sync")(c, **kwargs).train()
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(v["scale"]))
        m.bias.copy_(torch.from_numpy(v["bias"]))
        m.running_mean.copy_(torch.from_numpy(v["mean"]))
        m.running_var.copy_(torch.from_numpy(v["var"]))
    got = m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    for ours, theirs in ((m.running_mean, "mean"), (m.running_var, "var")):
        np.testing.assert_allclose(ours.numpy(),
                                   np.asarray(mut["batch_stats"][theirs]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("norm", ["bn", "iabr_sync"])
def test_abn_non_fused_train_branch_raises(norm):
    """The non-fused train branch no longer raises: ``bn`` (ReLU) and the
    renorm norms train through it (held to Flax per tensor by
    ``tests/test_torch_atrous.py``); here its output and running statistics
    against the JAX module on one input."""
    x = np.random.RandomState(4).randn(2, 3, 3, 8).astype(np.float32)
    jm = jax_make_norm(norm)(8)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref, mut = jm.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    m = make_norm(norm)(8).train()
    assert not m.fusable
    got = m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]),
                               rtol=1e-5)


# ---------------------------------------------------------------- K1: upsample+CE


CE_CASES = [((2, 5, 7, 6), (37, 51)), ((2, 8, 8, 5), (64, 64)),
            ((1, 4, 4, 21), (64, 64))]


def _sem_labels(shape, out_hw, seed):
    rs = np.random.RandomState(seed)
    sem = (rs.randn(*shape) * 3).astype(np.float32)
    labels = rs.randint(0, shape[-1], (shape[0],) + tuple(out_hw)).astype(np.int32)
    labels[rs.rand(*labels.shape) < 0.1] = 255
    return sem, labels


@pytest.mark.parametrize("shape,out_hw", CE_CASES, ids=["odd", "8x", "16x"])
def test_upsampled_cross_entropy_matches_jax(shape, out_hw):
    """Value and d/dsem against the JAX op (``jax.value_and_grad``), f32:
    value rtol 1e-5, gradient within 1e-5 of its largest entry."""
    sem, labels = _sem_labels(shape, out_hw, 4)
    ref, ref_grad = jax.value_and_grad(
        lambda s: jax_uce(s, jnp.asarray(labels), out_hw))(jnp.asarray(sem))
    st = torch.from_numpy(sem).requires_grad_()
    before = (ce_sums_per_image.launches, ce_dsem.launches)
    loss = upsampled_cross_entropy(st, torch.from_numpy(labels), out_hw)
    loss.backward()
    assert (ce_sums_per_image.launches, ce_dsem.launches) == before
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)
    g = np.asarray(ref_grad)
    np.testing.assert_allclose(st.grad.numpy(), g, rtol=0, atol=1e-5 * np.abs(g).max())


def test_upsampled_ce_sums_count_and_all_ignored():
    sem, labels = _sem_labels((2, 5, 7, 6), (37, 51), 5)
    loss_sum, count = upsampled_ce_sums(torch.from_numpy(sem), torch.from_numpy(labels),
                                        (37, 51))
    assert float(count) == float((labels != 255).sum())
    assert not count.requires_grad
    per_image, counts = ce_sums_per_image(torch.from_numpy(sem),
                                          torch.from_numpy(labels), (37, 51))
    np.testing.assert_allclose(float(per_image.sum()), float(loss_sum.detach()), rtol=1e-6)
    assert counts.shape == (2,)
    # every pixel ignored: the mean is 0 and its gradient is 0, not NaN
    st = torch.from_numpy(sem).requires_grad_()
    loss = upsampled_cross_entropy(st, torch.full_like(torch.from_numpy(labels), 255),
                                   (37, 51))
    loss.backward()
    assert float(loss.detach()) == 0.0 and float(st.grad.abs().max()) == 0.0


# ---------------------------------------------------------------- K2 and confusion


@pytest.mark.parametrize("shape,out_hw", CE_CASES + [((2, 8, 8, 5), (8, 8))],
                         ids=["odd", "8x", "16x", "identity"])
def test_upsampled_confusion_matches_jax(shape, out_hw):
    """Integer equality; inputs scaled so no pixel is near a tie."""
    sem, labels = _sem_labels(shape, out_hw, 6)
    labels[0, 0, :3] = [-1, shape[-1], shape[-1] + 7]  # out of range: dropped
    n_cls = shape[-1]
    ref = np.asarray(jax_uconf(jnp.asarray(sem), jnp.asarray(labels), out_hw, n_cls))
    before = upsampled_confusion.launches
    got = upsampled_confusion(torch.from_numpy(sem), torch.from_numpy(labels),
                              out_hw, n_cls)
    assert upsampled_confusion.launches == before
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert int(got.sum()) == int(((labels >= 0) & (labels < n_cls)).sum())


def test_confusion_matrix_and_iou_match_jax():
    rs = np.random.RandomState(7)
    preds = rs.randint(0, 8, (3, 9, 11)).astype(np.int32)  # some >= 6: clipped
    labels = rs.randint(0, 6, (3, 9, 11)).astype(np.int32)
    labels[rs.rand(*labels.shape) < 0.2] = 255
    ref = np.asarray(jax_confusion_matrix(jnp.asarray(preds), jnp.asarray(labels), 6))
    got = confusion_matrix(torch.from_numpy(preds), torch.from_numpy(labels), 6)
    np.testing.assert_array_equal(got.numpy(), ref)
    cm = ref.copy()
    cm[5] = 0
    cm[:, 5] = 0  # a class absent from targets and predictions
    for r, g in zip(jax_iou_from_confusion(jnp.asarray(cm)),
                    iou_from_confusion(torch.from_numpy(cm))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_cross_entropy_matches_jax(reduction, weighted):
    rs = np.random.RandomState(8)
    logits = (rs.randn(2, 6, 5, 7) * 3).astype(np.float32)
    labels = rs.randint(0, 7, (2, 6, 5)).astype(np.int32)
    labels[rs.rand(*labels.shape) < 0.2] = 255
    w = rs.uniform(0.2, 2.0, 7).astype(np.float32) if weighted else None
    ref = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            class_weights=None if w is None else jnp.asarray(w),
                            reduction=reduction)
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                        class_weights=None if w is None else torch.from_numpy(w),
                        reduction=reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- optimizers


OPTIMIZERS = [
    {"_target_": "torch.optim.SGD", "lr": 0.01, "momentum": 0.9,
     "nesterov": True, "weight_decay": 1e-4},  # conf/bacs/optimizer/nesterov.yaml
    {"_target_": "torch.optim.SGD", "lr": 0.05, "weight_decay": 1e-3},
    {"_target_": "torch.optim.Adam", "lr": 1e-3, "weight_decay": 1e-4},
    {"_target_": "torch.optim.AdamW", "lr": 1e-3, "weight_decay": 1e-2},
]


@pytest.mark.parametrize("cfg", OPTIMIZERS, ids=["nesterov", "sgd", "adam", "adamw"])
def test_make_optimizer_matches_optax_chain(cfg):
    """Five updates of seeded parameters with seeded gradients, some above
    the clip value 2.0, under the poly schedule: f32, rtol 1e-5."""
    rs = np.random.RandomState(9)
    shapes = [(3, 4), (5,), (2, 3, 3)]
    params0 = [rs.randn(*s).astype(np.float32) for s in shapes]
    grads = [[(rs.randn(*s) * 3).astype(np.float32) for s in shapes]
             for _ in range(5)]
    base_lr, max_iters = cfg["lr"], 8
    tx = jax_optim.make_optimizer(cfg, jax_optim.poly_schedule(base_lr, max_iters))
    jp = [jnp.asarray(p) for p in params0]
    opt_state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params0]
    opt, sched = optim.make_optimizer(cfg, tp, optim.poly_schedule(base_lr, max_iters))
    for step_grads in grads:
        updates, opt_state = tx.update([jnp.asarray(g) for g in step_grads],
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(tp, step_grads):
            p.grad = torch.from_numpy(g.copy())
        optim.apply_updates(opt, sched)
    for p, r in zip(tp, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(r),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize(
    "cfg",
    [{"_target_": "training.PolyLR", "power": 0.9},
     {"_target_": "WarmupPoly", "warmup_iters_percentage": 0.3},
     {"_target_": "WarmupPoly", "warmup_method": "constant",
      "constant_ending": 0.2},
     {"_target_": "ExponentialLR", "gamma": 0.5},
     {"_target_": "CyclicLR", "step_size_up": 3}],
    ids=["poly", "warmup-linear", "warmup-constant-ending", "exponential", "cyclic"],
)
def test_make_schedule_matches_jax(cfg):
    ref = jax_optim.make_schedule(cfg, 0.01, 10)
    got = optim.make_schedule(cfg, 0.01, 10)
    for step in range(14):
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6, atol=1e-9)


def test_unported_options_raise():
    # gradient accumulation is ported (held to optax.MultiSteps by
    # tests/test_torch_accumulate.py)
    opt, _ = optim.make_optimizer(OPTIMIZERS[0], [torch.nn.Parameter(torch.zeros(2))],
                                  optim.poly_schedule(0.01, 10), accumulate_steps=2)
    assert opt.param_groups[0]["accumulate_steps"] == 2
    assert opt.param_groups[0]["mini_step"] == 0
    # every method of the JAX registry is ported (held to JAX by
    # tests/test_torch_more_methods_step.py), bg_weighted_ce included
    for name in ("sdr", "loss.IcarlLoss", "er", "prototypes"):
        create_method(name)
    for name in ("mib", "loss.PLOPLoss"):
        assert create_method(name, bg_weighted_ce=True).bg_weighted_ce
    with pytest.raises(ValueError, match="unknown"):
        create_method("nonsense")
    # BACS's options are ported (held to JAX by tests/test_torch_bacs_options.py)
    assert create_method("loss.BACSLoss", mixup=True).mixup
