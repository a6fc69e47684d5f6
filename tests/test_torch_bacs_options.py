"""BACS's four options against the JAX package, on the CPU.

The setup of ``tests/test_torch_bacs_step.py``: DeepLabV3-ResNet-18 with
the seen detector at 64^2, VOC-21 split 16+1, batch 4, replay batches of 4
from an 8-slot buffer, every ABN with the identity activation, the same
Flax variables on both sides, and its ``injected`` fixture for the draws
(the two buffer samples' Gumbel keys, the replay crop and flip, no
autocontrast stretch, the detector's dropout at rate 0).  Here the buffer
holds items of 1 to 6 foreground classes each in stripes, offered one at a
time (a slot's class set is its batch's), so that mixup's
partners and its two lambda branches (0.9 above ``mixup_threshold``, a
Beta draw at or below it) both occur; mixup's Beta draws are injected too
(``jax.random.beta`` and the port's ``beta_sample``).

Each option alone on ``bacs_plus_bg.yaml``'s method (``pseudo_label`` on
``bacs_plus.yaml``'s, as the weighted CE turns it off): one task-1 step,
the JAX side ``_train_step_impl`` written out to return the gradients,
held per tensor at ``test_torch_bacs_step.py``'s tolerances; and each term
of the loss on the state before the step.  ``merged_replay``'s two terms
come out of its one forward (its ``_dark_from_sem`` and
``ce_with_upsample`` recorded on both sides).

Also: the port's Beta draw (Marsaglia and Tsang from the state's
generator) against ``scipy.stats.beta``, and each option built from
``conf/bacs/bacs_plus_config`` by the port's command line, two debug tasks
on the CPU.
"""

import functools
from unittest import mock

import numpy as np
import optax
import pytest
import scipy.stats
import torch

import jax
import jax.numpy as jnp

import bacs_tpu_torch.methods.bacs as port_bacs
import test_torch_bacs_step as bs
from bacs_tpu.methods import create_method as jax_create_method
from bacs_tpu.methods.base import ModelContext as JaxModelContext
from bacs_tpu.train import buffer as jax_buffer
from bacs_tpu.train import optim as jax_optim
from bacs_tpu.train.state import TaskInfo as JaxTaskInfo
from bacs_tpu.train.state import TrainState as JaxTrainState
from bacs_tpu_torch.ops import rng
from bacs_tpu_torch import main as port_main
from bacs_tpu_torch.methods import ModelContext, create_method
from bacs_tpu_torch.methods.base import proto_updates
from bacs_tpu_torch.train import buffer as port_buffer
from bacs_tpu_torch.train import loop, optim
from bacs_tpu_torch.train.state import TaskInfo, TrainState, frozen_copy
from bacs_tpu_torch.train.step import make_steps
from bacs_tpu_torch.utils.flax_weights import state_dict_to_flax
from test_torch_bacs_step import injected  # noqa: F401  (the draws' fixture)
from torch_port_helpers import _one_thread  # noqa: F401

CROP, REPLAY, SLOTS, N_CLASSES, OLD = bs.CROP, bs.REPLAY, bs.SLOTS, bs.N_CLASSES, 16
MIXUP_THRESHOLD = 9
OPTIONS = {
    "pseudo_label": dict(pseudo_label=True, bg_weighted_ce=False),
    "use_cosine_dist": dict(use_cosine_dist=True),
    "mixup": dict(mixup=True, mixup_alpha=0.4, mixup_threshold=MIXUP_THRESHOLD),
    "merged_replay": dict(merged_replay=True),
}
# mixup's Beta draws, one per replayed item
LAMBDAS = np.float32([0.3, 0.55, 0.8, 0.15])
# foreground classes of each of the 10 items offered to the buffer
CLASSES_PER_ITEM = (1, 2, 3, 4, 5, 6, 2, 3, 1, 4)


@pytest.fixture
def injected_lambdas(monkeypatch):
    monkeypatch.setattr(jax.random, "beta",
                        lambda key, a, b, shape=(), dtype=None: jnp.asarray(LAMBDAS))
    monkeypatch.setattr(port_bacs, "beta_sample",
                        lambda a, n, draws, device: torch.from_numpy(LAMBDAS.copy()))


@functools.lru_cache(maxsize=None)
def buffer_items():
    """10 items of 1-6 old foreground classes each, in stripes over the top
    half (the bottom half background), ~5 % ignored; and the reservoir's
    uniforms."""
    rs = np.random.RandomState(8)
    labels = np.zeros((len(CLASSES_PER_ITEM), CROP, CROP), np.int32)
    for i, k in enumerate(CLASSES_PER_ITEM):
        for j, c in enumerate(rs.choice(np.arange(1, OLD), k, replace=False)):
            labels[i, : CROP // 2, j * CROP // k: (j + 1) * CROP // k] = c
    labels[rs.rand(*labels.shape) < 0.05] = 255
    n = len(CLASSES_PER_ITEM)
    return dict(images=rs.randn(n, CROP, CROP, 3).astype(np.float32),
                logits=rs.randn(n, 4, 4, N_CLASSES).astype(np.float32),
                labels=labels, losses=-rs.rand(n).astype(np.float32),
                uniforms=(rs.rand(n).astype(np.float32), rs.rand(n).astype(np.float32)))


def jax_buffer_filled():
    """The items offered one at a time: a slot's classes are those of its
    batch (the reference's quirk, ``bacs_tpu/train/buffer.py:173-177``)."""
    it = buffer_items()
    buf = jax_buffer.init_buffer(SLOTS, (CROP, CROP), (4, 4), N_CLASSES)
    for i in range(len(CLASSES_PER_ITEM)):
        buf = jax_buffer.add_batch(
            buf, None, *(jnp.asarray(it[k][i: i + 1])
                         for k in ("images", "logits", "labels", "losses")),
            task_id=0, n_classes=OLD,
            uniforms=tuple(jnp.asarray(u[i: i + 1]) for u in it["uniforms"]))
    return buf


@functools.lru_cache(maxsize=None)
def background_offset():
    """What the previous model adds to its background logit, so that it
    keeps about half of the batch's background pixels and gives the rest to
    old classes: the midpoint of the widest gap between two neighbouring
    values of (best old class - background) over the background pixels in
    the middle fifth, so that no pixel's choice is within rounding of it."""
    model = bs.port_model().eval()
    batch = bs.inputs()[0]
    with torch.no_grad():
        logits = model(torch.from_numpy(batch["image"])).logits[..., :OLD]
    gap = (logits[..., 1:].amax(-1) - logits[..., 0])[torch.from_numpy(batch["label"] == 0)]
    gap = np.sort(gap.numpy().astype(np.float64))
    lo, hi = int(0.4 * len(gap)), int(0.6 * len(gap))
    k = lo + int(np.argmax(np.diff(gap[lo:hi])))
    return float(0.5 * (gap[k] + gap[k + 1])), float(gap[k + 1] - gap[k])


def jax_state(tx):
    _, _, _, protos, counts, _, _ = bs.inputs()
    params, stats = bs.flax_variables()
    p, s = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats)
    prev = jax.tree.map(lambda x: x, p)
    bias = prev["classifier_head"]["bias"]
    prev["classifier_head"] = {**prev["classifier_head"],
                               "bias": bias.at[0].add(background_offset()[0])}
    return JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=p, batch_stats=s, opt_state=tx.init(p),
        rng=jax.random.PRNGKey(2), prototypes=jnp.asarray(protos),
        proto_counts=jnp.asarray(counts), prev_params=prev, prev_batch_stats=s,
        buffer=jax_buffer_filled())


def port_state():
    _, _, _, protos, counts, _, _ = bs.inputs()
    model = bs.port_model()
    opt, sched = optim.make_optimizer(bs.OPT_CFG, model.parameters(),
                                      optim.poly_schedule(0.01, bs.MAX_ITERS))
    prev = frozen_copy(model)
    with torch.no_grad():
        prev.classifier_head.bias[0] += background_offset()[0]
    return TrainState(model, opt, sched, key=rng.key(0),
                      prototypes=torch.from_numpy(protos.copy()),
                      proto_counts=torch.from_numpy(counts.copy()),
                      prev_model=prev, buffer=bs.port_buffer_from(jax_buffer_filled()))


def method_kw(option):
    return {**bs.METHOD, **OPTIONS[option]}


def recording(method, names):
    """Record what ``method``'s ``names`` return, on the instance."""
    out = []
    for name in names:
        fn = getattr(method, name)

        def wrapped(*a, fn=fn, **k):
            out.append(fn(*a, **k))
            return out[-1]

        setattr(method, name, wrapped)
    return out


def jax_step_and_terms(option):
    params, _ = bs.flax_variables()
    batch, *_ = bs.inputs()
    tx = jax_optim.make_optimizer(bs.OPT_CFG, jax_optim.poly_schedule(0.01, bs.MAX_ITERS))
    state = jax_state(tx)
    ctx = JaxModelContext(model=bs.jax_model(), task=JaxTaskInfo(task_id=1, **bs.TASK),
                          axis_name=None)
    method = jax_create_method("loss.BACSLoss", **method_kw(option))
    data = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(9)

    @jax.jit
    def step(state, data):
        def loss_fn(p):
            return method.compute_loss(ctx, p, state, data, True, rng)

        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        updates, _ = tx.update(grads, state.opt_state, state.params)
        return (loss, grads, optax.apply_updates(state.params, updates),
                aux.batch_stats, aux.state_updates)

    terms_method = jax_create_method("loss.BACSLoss", **method_kw(option))

    @jax.jit
    def terms(state, data):
        m, p, image, mask = terms_method, state.params, data["image"], data["label"]
        if m.pseudo_label:  # bacs_tpu/methods/bacs.py:143-148
            pseudo = jnp.argmax(ctx.forward_prev(state, image).logits[..., :OLD], axis=-1)
            mask = jnp.where(mask == 0, pseudo.astype(mask.dtype), mask)
        main, out, old_out, bstats, seen = m.compute_base_loss(
            ctx, p, state, image, mask, True, rng, use_weighted_ce=m.bg_weighted_ce,
            need_old_out=True)
        distill = m._teacher_distill(old_out.attentions[-1], out.attentions[-1], seen, mask)
        updates = m.prototype_updates(ctx, state, out.penultimate, mask, True)
        if m.merged_replay:
            rec = recording(m, ("_dark_from_sem", "ce_with_upsample"))
            replay, _, updates = m._merged_replay_der_loss(ctx, p, state, bstats, rng,
                                                           updates)
            alpha, beta = rec
        else:
            alpha, bstats, _ = m._dark_logits(ctx, p, state, bstats, rng)
            beta, _, updates = m._dark_pp(ctx, p, state, bstats, rng, updates)
        return main, distill, alpha, beta, updates, mask

    loss, grads, new_params, new_stats, upd = step(state, data)
    *t, term_upd, mask = terms(state, data)
    return dict(
        loss=float(loss), grads=dict(bs.flat(grads)), params=dict(bs.flat(new_params)),
        stats=dict(bs.flat(new_stats)), protos=np.asarray(upd["prototypes"]),
        counts=np.asarray(upd["proto_counts"]), terms=[float(v) for v in t],
        term_protos=np.asarray(term_upd["prototypes"]), mask=np.asarray(mask))


def port_step_and_terms(option):
    batch, *_ = bs.inputs()
    ctx = ModelContext(TaskInfo(task_id=1, **bs.TASK))
    method = create_method("loss.BACSLoss", **method_kw(option))
    train_step, _, put_batch = make_steps(ctx, method, N_CLASSES, device="cpu")
    data = put_batch(batch)
    state, metrics = train_step(port_state(), data)
    grads = {k: p.grad for k, p in state.model.named_parameters()}
    params, stats = state_dict_to_flax(state.model.state_dict())

    m = create_method("loss.BACSLoss", **method_kw(option))
    s = port_state()
    mask = data["label"]
    if m.pseudo_label:
        mask = m._pseudo_labels(ctx, s, data["image"], mask)
    base = m.compute_base_loss(ctx, s, data["image"], mask, True,
                               use_weighted_ce=m.bg_weighted_ce, need_old_out=True)
    distill = m._teacher_distill(base.old_out.attentions[-1], base.out.attentions[-1],
                                 base.seen_prob, mask)
    if m.merged_replay:
        rec = recording(m, ("_dark_from_sem", "ce_with_upsample"))
        _, upd = m._merged_replay_der_loss(ctx, s, None, proto_updates(base))
        alpha, beta = rec
    else:
        alpha = m._dark_logits(ctx, s, None)
        beta, upd = m._dark_pp(ctx, s, None, proto_updates(base))
    return dict(
        loss=float(metrics["loss"]), grads=dict(bs.flat(state_dict_to_flax(grads)[0])),
        params=dict(bs.flat(params)), stats=dict(bs.flat(stats)),
        protos=state.prototypes.numpy(), counts=state.proto_counts.numpy(),
        terms=[float(v.detach()) for v in (base.loss, distill, alpha, beta)],
        term_protos=upd["prototypes"].numpy(), mask=mask.numpy(), state=state)


@functools.lru_cache(maxsize=None)
def runs(option):
    return jax_step_and_terms(option), port_step_and_terms(option)


@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_step_matches_jax(option, injected, injected_lambdas):  # noqa: F811
    """A task-1 step with the option on: ``test_torch_bacs_step.py``'s
    checks (loss rtol 1e-5, every gradient and update per tensor, the
    statistics, the prototypes and their counts)."""
    bs.assert_step_matches(*runs(option))


@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_loss_terms_match_jax(option, injected, injected_lambdas):  # noqa: F811
    """Each term on the state before the step, rtol 1e-5: the main CE
    (+ the detector's focal term), the teacher distillation, the alpha term
    and the beta term; their weighted sum is the step's loss; the
    prototypes after the folds as JAX's."""
    ref, got = runs(option)
    np.testing.assert_array_equal(got["mask"], ref["mask"])
    np.testing.assert_allclose(got["terms"], ref["terms"], rtol=1e-5)
    main, distill, alpha, beta = got["terms"]
    assert min(main, distill, alpha, beta) > 0
    np.testing.assert_allclose(main + distill + 0.8 * alpha + 0.5 * beta, got["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["term_protos"], ref["term_protos"], rtol=1e-5,
                               atol=1e-5 * np.abs(ref["term_protos"]).max())


def test_pseudo_label_relabels_background(injected, injected_lambdas):  # noqa: F811
    """The old classes take background pixels: 40-60 % of the background is
    relabelled (``background_offset``), only to old foreground classes, and
    nothing else moves.  No pixel is within 1e-2 of the previous model's
    background-or-not choice (the logits are ~1e2)."""
    ref, got = runs("pseudo_label")
    label = bs.inputs()[0]["label"]
    bg = label == 0
    moved = got["mask"] != label
    assert not (moved & ~bg).any()
    assert 0.4 < moved.sum() / bg.sum() < 0.6, (moved.sum(), bg.sum())
    assert 0 < got["mask"][moved].min() and got["mask"][moved].max() < OLD
    assert background_offset()[1] > 2e-2, background_offset()
    assert create_method("loss.BACSLoss", pseudo_label=True).pseudo_label


def test_mixup_takes_both_lambda_branches():
    """The beta batch (the second Gumbel key) pairs items whose classes
    together exceed the threshold and items whose do not."""
    buf = bs.port_buffer_from(jax_buffer_filled())
    key = torch.from_numpy(bs.inputs()[5][1].copy())
    idx = port_buffer.sample(buf, REPLAY, keys=key)["indices"]
    sets = buf.label_mask[:, 1:-1].sum(dim=1)[idx]
    fg = buf.label_mask.clone()
    fg[:, 0] = fg[:, -1] = False
    held = fg.double().sum(dim=0)
    score = fg[idx].double() @ torch.outer(held, held) @ fg[idx].double().t()
    partner = score.fill_diagonal_(-torch.inf).argmax(dim=1)
    merged = sets + sets[partner]
    assert (merged > MIXUP_THRESHOLD).any() and (merged <= MIXUP_THRESHOLD).any(), merged


@pytest.mark.parametrize("a", [1.0, 0.4])
def test_beta_draws_follow_scipy(a):
    """20 000 draws of the port's Beta(a, a) from one seeded key: a
    Kolmogorov-Smirnov test against ``scipy.stats.beta`` (p > 0.01 at this
    seed), the same draws again from the same seed, and the key as their
    only source (another seed, other draws)."""
    draw = lambda seed: port_bacs.beta_sample(  # noqa: E731
        a, 20000, rng.key(seed), torch.device("cpu"))
    x = draw(3)
    assert x.dtype == torch.float32 and bool(((x >= 0) & (x <= 1)).all())
    p = scipy.stats.kstest(x.numpy(), scipy.stats.beta(a, a).cdf).pvalue
    assert p > 0.01, p
    torch.testing.assert_close(draw(3), x, rtol=0, atol=0)
    assert not torch.equal(draw(4), x)


@pytest.mark.parametrize("option", list(OPTIONS))
def test_cli_trains_each_option(option):
    """``python -m bacs_tpu_torch.main --device cpu --config-path conf/bacs
    --config-name bacs_plus_config +loss.<option>=true`` at a debug size
    (RN18, 64^2, batch 4, two tasks of 6 images): the method has the option
    on and the run ends at a finite mIoU."""
    trainers = []

    class Recorded(loop.Trainer):
        def fit(self):
            trainers.append(self)
            return super().fit()

    argv = ["--device", "cpu", "--config-path", "conf/bacs", "--config-name",
            "bacs_plus_config", f"+loss.{option}=true",
            "dataset._target_=dataloaders.SyntheticDataModule",
            "dataset.dataset.crop_size=64", "+training.debug=true",
            "training.initial_increment=19", "training.epochs=1",
            "training.mixed_precision=false", "training.num_workers=0",
            "network.backbone=resnet18", "training.batch_size=4", "loss.buffer_size=8",
            "loss.replay_minibatch_size=4", "~training.ckpt_dir",
            # one process: der_15_1's n_gpus 2 would start two CPU ranks
            "training.n_gpus=1"]
    with mock.patch.object(loop, "Trainer", Recorded):
        miou = port_main.main(argv)
    (trainer,) = trainers
    assert trainer.n_tasks == 2 and getattr(trainer.method, option) is True
    assert np.isfinite(miou)
