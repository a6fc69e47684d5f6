"""The port's steps on TranSeg against the JAX package's, on the CPU.

TranSeg on a ResNet-18 at 32^2 (hidden 32, 4 heads, 2 layers, feed-forward
64), every ABN with the identity activation (so the network is smooth, as
``tests/test_torch_bacs_step.py`` makes DeepLabV3), f32, from the same Flax
variables (initialised by the JAX package, every 1-D scale and bias and
``mask_norm`` redrawn), the nesterov SGD of
``conf/bacs/optimizer/nesterov.yaml`` under a poly schedule:

- CE at task 0 of VOC's 15-1 split (16 of 21 class tokens in use): the
  eval step, two train steps and the eval step again, against JAX
  ``make_steps``.
- The task-1 BACS+ step (``bacs_plus``: weighted CE, alpha 0.8, beta 0.5,
  lkd 0.25, the detector; replay 4 from 8 slots, batch 4) after the
  ``mean`` token growth, against the JAX step written out to return the
  gradients, with the draws injected on both sides as
  ``tests/test_torch_bacs_step.py`` does (fixed Gumbel keys and crops, no
  autocontrast, detector dropout 0).  The previous model holds the
  parameters from before the growth and 17 tokens, as the Trainer sets it
  (``train/loop.py:_set_active_classes``): JAX's teacher is the current
  task's module applied to the previous parameters
  (``bacs_tpu/methods/base.py:82-89``).  Its ``image_feats`` are held to
  JAX's, and shown to differ at the old count.
- The task-1 eval step, and the Predictor against the JAX Predictor.

Tolerances.  The network is smooth, so losses, running statistics and
prototypes hold to f32 rounding (rtol 1e-5 of the largest value), and
every gradient (each norm's scale and bias joined: an exact-zero bias
gradient is rounding noise in both packages) to 1e-4 of its tensor's
largest value, every update to 1e-4 of its largest plus one ulp of the
parameter (measured: below 2e-6).  The Predictor as
``tests/test_torch_unet.py`` holds it: masks equal on at least 99.9 % of
the pixels, the f16 confidence within 2e-3.
"""

import functools
import itertools
import types
from unittest import mock

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import bacs_tpu.data.transforms as jax_transforms
import bacs_tpu.methods.bacs as jax_bacs
import bacs_tpu.models.transeg as jax_transeg
from bacs_tpu.methods import create_method as jax_create_method
from bacs_tpu.methods.base import ModelContext as JaxModelContext
from bacs_tpu.models.norm import ABN as JaxABN
from bacs_tpu.serve import Predictor as JaxPredictor
from bacs_tpu.train import buffer as jax_buffer
from bacs_tpu.train import optim as jax_optim
from bacs_tpu.train.learner import transformer_init as jax_transformer_init
from bacs_tpu.train.state import TaskInfo as JaxTaskInfo
from bacs_tpu.train.state import TrainState as JaxTrainState
from bacs_tpu.train.step import make_steps as jax_make_steps
import bacs_tpu_torch.methods.bacs as port_bacs
from bacs_tpu_torch.ops import rng
from bacs_tpu_torch.data.transforms import apply_crop_params
from bacs_tpu_torch.methods import ModelContext, create_method
from bacs_tpu_torch.models.norm import ABN
from bacs_tpu_torch.models.transeg import TranSeg
from bacs_tpu_torch.serve import Predictor
from bacs_tpu_torch.train import buffer as port_buffer
from bacs_tpu_torch.train import optim
from bacs_tpu_torch.train.learner import transformer_init
from bacs_tpu_torch.train.loop import Trainer
from bacs_tpu_torch.train.state import TaskInfo, TrainState, frozen_copy
from bacs_tpu_torch.train.step import make_steps
from bacs_tpu_torch.utils.flax_weights import (
    flax_to_state_dict, load_flax_variables, state_dict_to_flax)
from torch_port_helpers import _one_thread, randomize_abn  # noqa: F401

CROP, BATCH, REPLAY, SLOTS, N_CLASSES, N_TASKS = 32, 4, 4, 8, 21, 6
TR = dict(hidden_dim=32, nhead=4, num_decoder_layers=2, dim_feedforward=64)
OPT_CFG = {"_target_": "torch.optim.SGD", "lr": 0.01, "momentum": 0.9,
           "nesterov": True, "weight_decay": 1e-4}
MAX_ITERS = 10
TASK = dict(initial_classes=16, increment=1, num_classes=N_CLASSES, n_tasks=N_TASKS,
            max_epochs=30)
BACS = dict(use_bg_detector=True, bg_weighted_ce=True, alpha=0.8, beta=0.5, lkd=0.25,
            buffer_size=SLOTS, replay_minibatch_size=REPLAY)


def jax_model(active, det):
    return jax_transeg.TranSeg(
        num_classes=N_CLASSES, crop_size=CROP, active_classes=active,
        backbone_name="resnet18", norm=functools.partial(JaxABN, activation="identity"),
        n_tasks=N_TASKS, use_bg_detector=det, **TR)


def port_model(active, det, variables=None):
    model = TranSeg(N_CLASSES, crop_size=CROP, active_classes=active,
                    backbone_name="resnet18",
                    norm=functools.partial(ABN, activation="identity"), n_tasks=N_TASKS,
                    use_bg_detector=det, **TR)
    if det:
        model.seen_fg_network.dropout_rate = 0.0
    load_flax_variables(model, *(variables or flax_variables(det)))
    return model


def no_jax_dropout():
    return mock.patch.object(jax_transeg, "BgDetector",
                             functools.partial(jax_transeg.BgDetector, dropout_rate=0.0))


@functools.lru_cache(maxsize=None)
def flax_variables(det):
    x = np.zeros((1, CROP, CROP, 3), np.float32)
    with no_jax_dropout():
        v = jax.jit(lambda k, x: jax_model(None, det).init(k, x, train=False))(
            jax.random.PRNGKey(0), x)
    rs = np.random.RandomState(7)
    params = randomize_abn(v["params"], rs)
    head = dict(params["base_classifier"])
    for k in ("mask_norm_scale", "mask_norm_bias"):
        head[k] = (float(k.endswith("scale")) + rs.uniform(-0.3, 0.3, N_CLASSES)).astype(
            np.float32)
    params["base_classifier"] = head
    return params, randomize_abn(v["batch_stats"], rs)


def flat(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float32)


def joined(d):
    """Each norm's scale and bias joined (``tests/test_torch_bacs_step.py``)."""
    out = {}
    for k, v in d.items():
        stem, _, leaf = k.rpartition("/")
        if leaf in ("scale", "bias") and f"{stem}/scale" in d:
            out[stem] = np.concatenate([d[f"{stem}/scale"], d[f"{stem}/bias"]])
        else:
            out[k] = v
    return out


def close(got, ref, rel, msg=""):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=rel * max(float(np.abs(ref).max()), 1e-30), err_msg=msg)


def hold_params(got, ref, p0):
    """Each parameter within 1e-4 of its update's largest value plus one
    ulp of the parameter."""
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        upd = np.abs(r - p0[k]).max()
        ulp = np.finfo(np.float32).eps * np.abs(p0[k]).max()
        np.testing.assert_allclose(got[k], r, rtol=0, atol=1e-4 * upd + ulp, err_msg=k)


def labels_of(rs, n, n_classes):
    """Labels in [0, n_classes), ~40 % background, ~5 % ignored."""
    lab = rs.randint(0, n_classes, (n, CROP, CROP)).astype(np.int32)
    lab[rs.rand(*lab.shape) < 0.4] = 0
    lab[rs.rand(*lab.shape) < 0.05] = 255
    return lab


def tx():
    return jax_optim.make_optimizer(OPT_CFG, jax_optim.poly_schedule(0.01, MAX_ITERS))


def port_opt(model):
    return optim.make_optimizer(OPT_CFG, model.parameters(),
                                optim.poly_schedule(0.01, MAX_ITERS))


def jax_state(t, params, stats, **kw):
    p = jax.tree.map(jnp.asarray, params)
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=p,
                         batch_stats=jax.tree.map(jnp.asarray, stats), opt_state=t.init(p),
                         rng=jax.random.PRNGKey(2), **kw)


# ---------------------------------------------------------------- CE


def ce_batches():
    rs = np.random.RandomState(3)
    return [{"image": rs.randn(BATCH, CROP, CROP, 3).astype(np.float32),
             "label": labels_of(rs, BATCH, 16)} for _ in range(3)]


@functools.lru_cache(maxsize=None)
def jax_ce_run():
    params, stats = flax_variables(False)
    t = tx()
    state = jax_state(t, params, stats, prototypes=jnp.zeros((1, 128)),
                      proto_counts=jnp.zeros((1,)))
    ctx = JaxModelContext(model=jax_model(16, False), task=JaxTaskInfo(task_id=0, **TASK),
                          axis_name=None)
    train_step, eval_step, _ = jax_make_steps(
        ctx, jax_create_method("loss.CrossEntropy"), t, N_CLASSES, mesh=None)
    data = [{k: jnp.asarray(v) for k, v in b.items()} for b in ce_batches()]
    zeros = lambda: jnp.zeros((N_CLASSES, N_CLASSES), jnp.int32)  # noqa: E731
    cm0, eval0 = eval_step(state, zeros(), data[-1])
    losses = []
    for b in data[:2]:
        state, metrics = train_step(state, b)
        losses.append(float(metrics["loss"]))
    cm, eval_loss = eval_step(state, zeros(), data[-1])
    return dict(eval0=(np.asarray(cm0), float(eval0)), losses=losses,
                params=dict(flat(state.params)), stats=dict(flat(state.batch_stats)),
                eval=(np.asarray(cm), float(eval_loss)))


def test_ce_train_and_eval_steps_match_jax():
    """Task 0, 16 of 21 tokens: the eval step before training (matrix equal,
    loss rtol 1e-5), the two steps' losses (rtol 1e-5), the parameters after
    them and the running statistics, and the eval step after them (loss
    rtol 1e-5, matrix equal)."""
    ref = jax_ce_run()
    model = port_model(16, False)
    state = TrainState(model, *port_opt(model))
    train_step, eval_step, put_batch = make_steps(
        ModelContext(TaskInfo(task_id=0, **TASK)), create_method("loss.CrossEntropy"),
        N_CLASSES, device="cpu")
    data = [put_batch(b) for b in ce_batches()]
    zeros = lambda: torch.zeros((N_CLASSES, N_CLASSES), dtype=torch.int32)  # noqa: E731
    cm0, eval0 = eval_step(state, zeros(), data[-1])
    losses = [float(train_step(state, b)[1]["loss"]) for b in data[:2]]
    cm, eval_loss = eval_step(state, zeros(), data[-1])
    params, stats = (dict(flat(t)) for t in state_dict_to_flax(model.state_dict()))

    np.testing.assert_array_equal(cm0.numpy(), ref["eval0"][0])
    np.testing.assert_allclose(float(eval0), ref["eval0"][1], rtol=1e-5)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    hold_params(params, ref["params"], dict(flat(flax_variables(False)[0])))
    for k, r in ref["stats"].items():
        close(stats[k], r, 1e-5, msg=k)
    np.testing.assert_allclose(float(eval_loss), ref["eval"][1], rtol=1e-5)
    np.testing.assert_array_equal(cm.numpy(), ref["eval"][0])
    assert int(cm.sum()) == int((ce_batches()[-1]["label"] != 255).sum())


# ---------------------------------------------------------------- BACS+ at task 1


@functools.lru_cache(maxsize=None)
def task1_inputs():
    rs = np.random.RandomState(5)
    batch = {"image": rs.randn(BATCH, CROP, CROP, 3).astype(np.float32),
             "label": labels_of(rs, BATCH, 17)}
    items = dict(images=rs.randn(10, CROP, CROP, 3).astype(np.float32),
                 logits=rs.randn(10, 2, 2, N_CLASSES).astype(np.float32),
                 labels=labels_of(rs, 10, 16), losses=-rs.rand(10).astype(np.float32),
                 uniforms=(rs.rand(10).astype(np.float32), rs.rand(10).astype(np.float32)))
    protos = rs.randn(N_TASKS, 128).astype(np.float32)
    counts = np.zeros(N_TASKS, np.float32)
    counts[0] = 50.0
    crop = dict(i=np.float32([1.5, 0.0, 10.25, 0.0]), j=np.float32([0.0, 3.25, 1.0, 0.0]),
                ch=np.float32([20.0, 32.0, 15.5, 32.0]),
                cw=np.float32([26.5, 17.0, 30.0, 32.0]),
                flip=np.array([True, False, False, True]))
    return batch, items, protos, counts, crop


@functools.lru_cache(maxsize=None)
def grown_variables():
    """(the snapshot's params, the params after the ``mean`` growth of task
    1's token, stats), as JAX's ``transformer_init`` computes them."""
    params, stats = flax_variables(True)
    t = tx()
    state = jax_state(t, params, stats, prototypes=jnp.zeros((1, 1)),
                      proto_counts=jnp.zeros((1,)))
    grown = jax_transformer_init(state, JaxTaskInfo(task_id=1, **TASK), "mean").params
    return params, jax.tree.map(np.asarray, grown), stats


def jax_buffer_filled():
    _, it, *_ = task1_inputs()
    buf = jax_buffer.init_buffer(SLOTS, (CROP, CROP), (2, 2), N_CLASSES)
    return jax_buffer.add_batch(
        buf, None, jnp.asarray(it["images"]), jnp.asarray(it["logits"]),
        jnp.asarray(it["labels"]), jnp.asarray(it["losses"]), task_id=0, n_classes=16,
        uniforms=tuple(jnp.asarray(u) for u in it["uniforms"]))


def port_buffer_from(jbuf):
    t = lambda a: torch.from_numpy(np.asarray(a).astype(np.float32))  # noqa: E731
    a = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731
    return port_buffer.BufferState(
        images=t(jbuf.images).to(torch.bfloat16), logits=t(jbuf.logits).to(torch.bfloat16),
        labels=a(jbuf.labels), importance=t(jbuf.importance), label_mask=a(jbuf.label_mask),
        task_ids=a(jbuf.task_ids), n_classes=a(jbuf.n_classes), valid=a(jbuf.valid),
        class_counts=a(jbuf.class_counts), num_seen=int(jbuf.num_seen))


@pytest.fixture
def injected(monkeypatch):
    """The replay draws of both packages made identical, as
    ``tests/test_torch_bacs_step.py``'s fixture of the same name."""
    *_, crop = task1_inputs()
    keys = [np.asarray(jax.random.gumbel(jax.random.PRNGKey(k), (SLOTS,))) for k in (21, 22)]
    jkeys = itertools.cycle([jax.random.PRNGKey(21), jax.random.PRNGKey(22)])
    sample = jax_buffer.sample
    monkeypatch.setattr(jax_bacs.buffer_lib, "sample",
                        lambda buf, rng, n, task_id=None: sample(buf, next(jkeys), n))
    autocontrast = jax_bacs.random_autocontrast
    monkeypatch.setattr(jax_bacs, "random_autocontrast",
                        lambda rng, x, p=0.5: autocontrast(rng, x, 0.0))

    def jax_augment(rng, images, labels):
        def one(im, lb, i, j, ch, cw, f):
            im = jax_transforms._resize_region(im, i, j, ch, cw, CROP, "bilinear")
            lb = jax_transforms._resize_region(lb, i, j, ch, cw, CROP, "nearest")
            return jnp.where(f, im[:, ::-1], im), jnp.where(f, lb[:, ::-1], lb)

        return jax.vmap(one)(images, labels, *(jnp.asarray(crop[k]) for k in
                                               ("i", "j", "ch", "cw", "flip")))

    monkeypatch.setattr(jax_transforms, "replay_augment", jax_augment)
    monkeypatch.setattr(jax_transeg, "BgDetector",
                        functools.partial(jax_transeg.BgDetector, dropout_rate=0.0))
    pkeys = itertools.cycle([torch.from_numpy(k.copy()) for k in keys])
    psample = port_buffer.sample
    monkeypatch.setattr(port_bacs.buffer_lib, "sample",
                        lambda buf, n, gen=None: psample(buf, n, keys=next(pkeys)))
    pautocontrast = port_bacs.random_autocontrast
    monkeypatch.setattr(port_bacs, "random_autocontrast",
                        lambda x, gen=None, p=0.5: pautocontrast(x, gen, 0.0))
    params = {k: torch.from_numpy(v) for k, v in crop.items()}
    monkeypatch.setattr(port_bacs, "replay_augment",
                        lambda im, lab, gen=None: apply_crop_params(im, lab, params))


def jax_task1():
    prev, grown, stats = grown_variables()
    batch, _, protos, counts, _ = task1_inputs()
    t = tx()
    state = jax_state(t, grown, stats, prototypes=jnp.asarray(protos),
                      proto_counts=jnp.asarray(counts),
                      prev_params=jax.tree.map(jnp.asarray, prev),
                      prev_batch_stats=jax.tree.map(jnp.asarray, stats),
                      buffer=jax_buffer_filled())
    ctx = JaxModelContext(model=jax_model(17, True), task=JaxTaskInfo(task_id=1, **TASK),
                          axis_name=None)
    method = jax_create_method("loss.BACSLoss", **BACS)
    data = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def step(state, data):
        def loss_fn(p):
            return method.compute_loss(ctx, p, state, data, True, jax.random.PRNGKey(9))

        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        updates, _ = t.update(grads, state.opt_state, state.params)
        return (loss, grads, optax.apply_updates(state.params, updates), aux.batch_stats,
                aux.state_updates, ctx.forward_prev(state, data["image"]).attentions[-1])

    _, eval_step, _ = jax_make_steps(ctx, method, t, N_CLASSES, mesh=None)
    cm, eval_loss = eval_step(state, jnp.zeros((N_CLASSES, N_CLASSES), jnp.int32), data)
    loss, grads, new_params, new_stats, upd, teacher = step(state, data)
    return dict(loss=float(loss), grads=dict(flat(grads)), params=dict(flat(new_params)),
                stats=dict(flat(new_stats)), protos=np.asarray(upd["prototypes"]),
                teacher=np.asarray(teacher), eval=(np.asarray(cm), float(eval_loss)))


def port_task1_state():
    """The task-1 state as the Trainer builds it: the snapshot of task 0
    (``end_task``'s ``frozen_copy``), then the learner's ``mean`` growth and
    the Trainer's class counts on both models."""
    prev, _, stats = grown_variables()
    batch, items, protos, counts, _ = task1_inputs()
    model = port_model(16, True, (prev, stats))
    state = TrainState(model, *port_opt(model), key=rng.key(0),
                       prototypes=torch.from_numpy(protos.copy()),
                       proto_counts=torch.from_numpy(counts.copy()),
                       prev_model=frozen_copy(model),
                       buffer=port_buffer_from(jax_buffer_filled()))
    task = TaskInfo(task_id=1, **TASK)
    transformer_init(state, task, "mean")
    Trainer._set_active_classes(types.SimpleNamespace(state=state), task)
    return state


@functools.lru_cache(maxsize=None)
def runs():
    batch, *_ = task1_inputs()
    ref = jax_task1()
    state = port_task1_state()
    ctx = ModelContext(TaskInfo(task_id=1, **TASK))
    method = create_method("loss.BACSLoss", **BACS)
    train_step, eval_step, put_batch = make_steps(ctx, method, N_CLASSES, device="cpu")
    data = put_batch(batch)
    teacher = ctx.forward_prev(state, data["image"]).attentions[-1]
    state.prev_model.active_classes = 16
    teacher_old_count = ctx.forward_prev(state, data["image"]).attentions[-1]
    state.prev_model.active_classes = 17
    cm, eval_loss = eval_step(state, torch.zeros((N_CLASSES, N_CLASSES), dtype=torch.int32),
                              data)
    state, metrics = train_step(state, data)
    grads = {k: p.grad for k, p in state.model.named_parameters()}
    params, stats = state_dict_to_flax(state.model.state_dict())
    got = dict(loss=float(metrics["loss"]), grads=dict(flat(state_dict_to_flax(grads)[0])),
               params=dict(flat(params)), stats=dict(flat(stats)),
               protos=state.prototypes.numpy(), teacher=teacher.numpy(),
               teacher_old_count=teacher_old_count.numpy(),
               eval=(cm.numpy(), float(eval_loss)))
    return ref, got


def test_task1_bacs_step_matches_jax(injected):
    """The task-1 BACS+ step after the ``mean`` growth: loss rtol 1e-5;
    gradients, clipped by value to 2 as both optimizers clip them, per
    tensor (each norm's scale and bias joined) to 1e-4; the update per
    tensor; the running statistics after the step's three train
    forwards and the folded prototypes to 1e-5."""
    ref, got = runs()
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    # the port's gradients are read after the step, clipped by value to 2
    # in place (``train/optim.py``); JAX's before its chain clips them
    gj = joined(got["grads"])
    rj = joined({k: np.clip(v, -2.0, 2.0) for k, v in ref["grads"].items()})
    assert gj.keys() == rj.keys()
    for k, r in rj.items():
        close(gj[k], r, 1e-4, msg=k)
    # the tokens past the 17 in use take no gradient
    assert not got["grads"]["base_classifier/class_tokens"][17:].any()
    hold_params(got["params"], ref["params"], dict(flat(grown_variables()[1])))
    assert got["stats"].keys() == ref["stats"].keys()
    for k, r in ref["stats"].items():
        close(got["stats"][k], r, 1e-5, msg=k)
    close(got["protos"], ref["protos"], 1e-5)


def test_teacher_attends_over_the_current_count(injected):
    """The previous model's ``image_feats`` (what BACS distils) at task 1:
    the snapshot's parameters over 17 tokens, to 1e-5 of JAX's teacher
    (the current task's module applied to ``prev_params``); at the old
    count of 16 they differ by far more (every patch attends to the
    tokens)."""
    ref, got = runs()
    close(got["teacher"], ref["teacher"], 1e-5)
    scale = float(np.abs(ref["teacher"]).max())
    assert float(np.abs(got["teacher_old_count"] - ref["teacher"]).max()) > 1e-3 * scale


def test_task1_eval_step_matches_jax(injected):
    """The task-1 eval step on the grown state: matrix equal, loss rtol
    1e-5."""
    ref, got = runs()
    np.testing.assert_array_equal(got["eval"][0], ref["eval"][0])
    np.testing.assert_allclose(got["eval"][1], ref["eval"][1], rtol=1e-5)


def test_predictor_on_transeg_matches_jax():
    """The Predictor with a TranSeg config (``transformer``, ``crop_size``
    and ``active_classes`` passed through, as ``bacs_tpu/serve.py`` does),
    17 of 21 classes, f32 on the CPU, against the JAX Predictor."""
    params, stats = flax_variables(False)
    cfg = {"_target_": "networks.TranSeg", "norm": "iabn_sync", "backbone": "resnet18",
           "transformer": TR}
    imgs = np.random.RandomState(4).randint(0, 256, (2, CROP, CROP, 3)).astype(np.uint8)
    ref_p, ref_c = JaxPredictor(cfg, N_CLASSES, params, stats, crop_size=CROP,
                                active_classes=17, dtype=jnp.float32).predict(imgs)
    pred = Predictor(cfg, N_CLASSES, params, stats, crop_size=CROP, active_classes=17,
                     dtype=torch.float32, device="cpu")
    assert pred.model.active_classes == 17
    got_p, got_c = pred.predict(imgs)
    assert got_p.dtype == np.uint8 and got_p.shape == (2, CROP, CROP)
    assert int(got_p.max()) < 17
    assert (got_p == np.asarray(ref_p)).mean() >= 0.999
    np.testing.assert_allclose(got_c.astype(np.float32), np.asarray(ref_c, np.float32),
                               atol=2e-3)
    # the weights the Predictor loaded are the Flax tree's
    sd = flax_to_state_dict(params, stats)
    assert all(torch.equal(v, sd[k]) for k, v in pred.model.state_dict().items())
