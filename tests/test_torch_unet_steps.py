"""The port's steps on UNet against the JAX package's, on the CPU.

UNet-3 (bilinear) at 32^2, f32, from the same Flax variables (initialised
by the JAX package, every norm vector and convolution bias redrawn by
``randomize_abn``), the nesterov SGD of ``conf/bacs/optimizer/nesterov.yaml``
under a poly schedule:

- CE: two train steps and the eval step before and after, against JAX
  ``make_steps`` (5 classes, batch 4).
- Task-1 BACS (``bacs_plus_bg``: weighted CE, alpha 0.8, beta 0.5, the
  detector) and PLOP steps, VOC-21 split 16 + 1, batch 4, against the JAX
  ``_train_step_impl`` written out to return the gradients, with the
  draws injected on both sides as ``tests/test_torch_bacs_step.py`` and
  ``tests/test_torch_mib_plop_step.py`` do (replay 4 from 8 slots, fixed
  Gumbel keys and crops, no autocontrast, detector dropout 0; PLOP's
  thresholds placed clear of every pixel's entropy).

UNet's logits are at label resolution, so every CE variant takes the
composed path (``methods/base.py:_fused_gate``) and the eval step the
plain argmax + confusion, as in JAX: no upsample kernel runs.

Tolerances.  The forward values are continuous, so losses, running
statistics and prototypes hold to f32 rounding (rtol 1e-5).  Gradients
and updates pass UNet's ReLU and max-pool kinks: where a pre-activation
or a window's top two lie within rounding, the packages may take
different branches and the batch norm's backward spreads that pixel over
its channel (``tests/test_torch_unet.py``), so they hold by the norm rule
of ``chip_smoke.py`` phase [8], ||port - JAX|| <= 5e-2 ||JAX|| over all
parameters (measured: the CE steps' update 1.5e-3, BACS's gradients and
update 9.9e-4, PLOP's 1.3e-3).
"""

import functools
import itertools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import bacs_tpu.data.transforms as jax_transforms
import bacs_tpu.methods.bacs as jax_bacs
import bacs_tpu.models.unet as jax_unet
from bacs_tpu.methods import create_method as jax_create_method
from bacs_tpu.methods.base import ModelContext as JaxModelContext
from bacs_tpu.models import create_network as jax_create_network
from bacs_tpu.train import buffer as jax_buffer
from bacs_tpu.train import optim as jax_optim
from bacs_tpu.train.state import TaskInfo as JaxTaskInfo
from bacs_tpu.train.state import TrainState as JaxTrainState
from bacs_tpu.train.step import make_steps as jax_make_steps
import bacs_tpu_torch.methods.bacs as port_bacs
from bacs_tpu_torch.ops import rng
from bacs_tpu_torch.data.transforms import apply_crop_params
from bacs_tpu_torch.methods import ModelContext, create_method
from bacs_tpu_torch.models import create_network
from bacs_tpu_torch.train import buffer as port_buffer
from bacs_tpu_torch.train import optim
from bacs_tpu_torch.train.state import TaskInfo, TrainState, frozen_copy
from bacs_tpu_torch.train.step import make_steps
from bacs_tpu_torch.utils.flax_weights import load_flax_variables, state_dict_to_flax
from torch_port_helpers import _one_thread, randomize_abn  # noqa: F401

CROP, BATCH, LAYERS = 32, 4, 3
OPT_CFG = {"_target_": "torch.optim.SGD", "lr": 0.01, "momentum": 0.9,
           "nesterov": True, "weight_decay": 1e-4}
MAX_ITERS = 10
NORM_RULE = 5e-2
# CE: 5 classes, one task
CE_CLASSES = 5
CE_TASK = dict(task_id=0, initial_classes=CE_CLASSES, increment=0,
               num_classes=CE_CLASSES, n_tasks=1, max_epochs=1)
# BACS and PLOP at task 1 of 16 + 1 (+ 4 later tasks)
N_CLASSES, N_TASKS, OLD, REPLAY, SLOTS = 21, 6, 16, 4, 8
TASK1 = dict(task_id=1, initial_classes=16, increment=1, num_classes=N_CLASSES,
             n_tasks=N_TASKS, max_epochs=30)
BACS = dict(use_bg_detector=True, bg_weighted_ce=True, alpha=0.8, beta=0.5,
            buffer_size=SLOTS, replay_minibatch_size=REPLAY)


def jax_model(n_classes, det):
    return jax_create_network("unet", n_classes, n_tasks=N_TASKS, use_bg_detector=det,
                              axis_name=None, num_layers=LAYERS)


def port_model(n_classes, det):
    model = create_network("unet", n_classes, n_tasks=N_TASKS, use_bg_detector=det,
                           num_layers=LAYERS)
    if det:
        model.seen_fg_network.dropout_rate = 0.0
    load_flax_variables(model, *flax_variables(n_classes, det))
    return model


@functools.lru_cache(maxsize=None)
def flax_variables(n_classes, det):
    x = np.zeros((1, CROP, CROP, 3), np.float32)
    m = jax_model(n_classes, det)
    v = jax.jit(lambda k, x: m.init(k, x, train=False))(jax.random.PRNGKey(0), x)
    rs = np.random.RandomState(7)
    return randomize_abn(v["params"], rs), randomize_abn(v["batch_stats"], rs)


def flat(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float32)


def norm_error(got, ref, base=None):
    """||got - ref|| / ||ref - base|| over every tensor (``base``: the
    parameters before the step, for updates)."""
    assert got.keys() == ref.keys()
    base = base or {k: 0.0 for k in ref}
    diff = sum(float(np.sum((got[k] - ref[k]) ** 2)) for k in ref)
    return (diff / sum(float(np.sum((ref[k] - base[k]) ** 2)) for k in ref)) ** 0.5


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


# ---------------------------------------------------------------- CE


def ce_batches():
    rs = np.random.RandomState(3)
    return [{"image": rs.randn(BATCH, CROP, CROP, 3).astype(np.float32),
             "label": labels_of(rs, BATCH, CE_CLASSES)} for _ in range(3)]


@functools.lru_cache(maxsize=None)
def jax_ce_run():
    params, stats = flax_variables(CE_CLASSES, False)
    t = tx()
    p = jax.tree.map(jnp.asarray, params)
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=p, batch_stats=jax.tree.map(jnp.asarray, stats),
        opt_state=t.init(p), rng=jax.random.PRNGKey(2), prototypes=jnp.zeros((1, 128)),
        proto_counts=jnp.zeros((1,)))
    ctx = JaxModelContext(model=jax_model(CE_CLASSES, False), task=JaxTaskInfo(**CE_TASK),
                          axis_name=None)
    train_step, eval_step, _ = jax_make_steps(
        ctx, jax_create_method("loss.CrossEntropy"), t, CE_CLASSES, mesh=None)
    data = [{k: jnp.asarray(v) for k, v in b.items()} for b in ce_batches()]
    zeros = lambda: jnp.zeros((CE_CLASSES, CE_CLASSES), jnp.int32)  # noqa: E731
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
    """Losses rtol 1e-5; the two steps' parameters by the norm rule on the
    update; running statistics rtol 1e-5 of their largest; the eval step
    before training equal in matrix and loss (rtol 1e-5), after it the
    loss within 1e-3 (the updates' kink drift; measured 1.3e-7) and the
    matrix counting every valid pixel."""
    ref = jax_ce_run()
    model = port_model(CE_CLASSES, False)
    state = TrainState(model, *port_opt(model))
    train_step, eval_step, put_batch = make_steps(
        ModelContext(TaskInfo(**CE_TASK)), create_method("loss.CrossEntropy"), CE_CLASSES,
        device="cpu")
    data = [put_batch(b) for b in ce_batches()]
    zeros = lambda: torch.zeros((CE_CLASSES, CE_CLASSES), dtype=torch.int32)  # noqa: E731
    cm0, eval0 = eval_step(state, zeros(), data[-1])
    losses = [float(train_step(state, b)[1]["loss"]) for b in data[:2]]
    cm, eval_loss = eval_step(state, zeros(), data[-1])
    params, stats = (dict(flat(t)) for t in state_dict_to_flax(model.state_dict()))

    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    np.testing.assert_array_equal(cm0.numpy(), ref["eval0"][0])
    np.testing.assert_allclose(float(eval0), ref["eval0"][1], rtol=1e-5)
    assert norm_error(params, ref["params"],
                      dict(flat(flax_variables(CE_CLASSES, False)[0]))) <= NORM_RULE
    for k, r in ref["stats"].items():
        np.testing.assert_allclose(stats[k], r, rtol=0, atol=1e-5 * np.abs(r).max(),
                                   err_msg=k)
    np.testing.assert_allclose(float(eval_loss), ref["eval"][1], rtol=1e-3)
    assert int(cm.sum()) == int((ce_batches()[-1]["label"] != 255).sum())


# ---------------------------------------------------------------- BACS, PLOP


@functools.lru_cache(maxsize=None)
def task1_inputs():
    rs = np.random.RandomState(5)
    batch = {"image": rs.randn(BATCH, CROP, CROP, 3).astype(np.float32),
             "label": labels_of(rs, BATCH, OLD + 1)}
    items = dict(images=rs.randn(10, CROP, CROP, 3).astype(np.float32),
                 logits=rs.randn(10, CROP, CROP, N_CLASSES).astype(np.float32),
                 labels=labels_of(rs, 10, OLD), losses=-rs.rand(10).astype(np.float32),
                 uniforms=(rs.rand(10).astype(np.float32), rs.rand(10).astype(np.float32)))
    d = jax_model(N_CLASSES, True).penultimate_dim
    protos = rs.randn(N_TASKS, d).astype(np.float32)
    counts = np.zeros(N_TASKS, np.float32)
    counts[0] = 50.0
    crop = dict(i=np.float32([1.5, 0.0, 10.25, 0.0]), j=np.float32([0.0, 3.25, 1.0, 0.0]),
                ch=np.float32([20.0, 32.0, 15.5, 32.0]),
                cw=np.float32([26.5, 17.0, 30.0, 32.0]),
                flip=np.array([True, False, False, True]))
    return batch, items, protos, counts, crop


def jax_buffer_filled():
    _, it, *_ = task1_inputs()
    buf = jax_buffer.init_buffer(SLOTS, (CROP, CROP), (CROP, CROP), N_CLASSES)
    return jax_buffer.add_batch(
        buf, None, jnp.asarray(it["images"]), jnp.asarray(it["logits"]),
        jnp.asarray(it["labels"]), jnp.asarray(it["losses"]), task_id=0, n_classes=OLD,
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
    monkeypatch.setattr(jax_unet, "BgDetector",
                        functools.partial(jax_unet.BgDetector, dropout_rate=0.0))
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


def plop_thresholds(model):
    """Per-class thresholds in the widest gap of the teacher's pixel
    entropies, none within 1e-5 of one (the margin rule of
    ``tests/test_torch_mib_plop_step.py``), and the entropy normaliser."""
    batch, *_ = task1_inputs()
    with torch.no_grad():
        sem = model.eval()(torch.from_numpy(batch["image"])).sem_logits[..., :OLD]
    probs = torch.softmax(sem.float(), -1)
    ent = (-(probs * torch.log(probs.clamp_min(1e-30))).sum(-1) / np.log(OLD)).numpy()
    pred = sem.argmax(-1).numpy()
    thresholds = np.full(N_CLASSES, 0.5, np.float32)
    for c in range(OLD):
        e = np.sort(np.concatenate([[0.0], ent[pred == c], [1.0]]))
        gap = int(np.argmax(np.diff(e)))
        thresholds[c] = (e[gap] + e[gap + 1]) / 2
    margin = np.abs(ent - thresholds[pred]).min()
    assert margin > 1e-5, margin
    return thresholds, np.float32(np.log(OLD))


def jax_task1(method_name, kwargs):
    params, stats = flax_variables(N_CLASSES, kwargs.get("use_bg_detector", False))
    batch, _, protos, counts, _ = task1_inputs()
    t = tx()
    p = jax.tree.map(jnp.asarray, params)
    bs = jax.tree.map(jnp.asarray, stats)
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=p, batch_stats=bs, opt_state=t.init(p),
        rng=jax.random.PRNGKey(2), prototypes=jnp.asarray(protos),
        proto_counts=jnp.asarray(counts), prev_params=p, prev_batch_stats=bs,
        buffer=jax_buffer_filled() if method_name == "loss.BACSLoss" else None)
    if method_name == "loss.PLOPLoss":
        th, max_ent = plop_thresholds(port_model(N_CLASSES, False))
        state = state.replace(plop_thresholds=jnp.asarray(th),
                              plop_max_entropy=jnp.float32(max_ent))
    ctx = JaxModelContext(model=jax_model(N_CLASSES, kwargs.get("use_bg_detector", False)),
                          task=JaxTaskInfo(**TASK1), axis_name=None)
    method = jax_create_method(method_name, **kwargs)
    data = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def step(state, data):
        def loss_fn(p):
            return method.compute_loss(ctx, p, state, data, True, jax.random.PRNGKey(9))

        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        updates, _ = t.update(grads, state.opt_state, state.params)
        return (loss, grads, optax.apply_updates(state.params, updates), aux.batch_stats,
                aux.state_updates)

    loss, grads, new_params, new_stats, upd = step(state, data)
    return dict(loss=float(loss), grads=dict(flat(grads)), params=dict(flat(new_params)),
                stats=dict(flat(new_stats)),
                protos=None if "prototypes" not in upd else np.asarray(upd["prototypes"]))


def port_task1(method_name, kwargs):
    det = kwargs.get("use_bg_detector", False)
    batch, items, protos, counts, _ = task1_inputs()
    model = port_model(N_CLASSES, det)
    state = TrainState(model, *port_opt(model), key=rng.key(0),
                       prototypes=torch.from_numpy(protos.copy()),
                       proto_counts=torch.from_numpy(counts.copy()),
                       prev_model=frozen_copy(model))
    if method_name == "loss.BACSLoss":
        state.buffer = port_buffer_from(jax_buffer_filled())
    if method_name == "loss.PLOPLoss":
        th, max_ent = plop_thresholds(model)
        state.plop_thresholds = torch.from_numpy(th)
        state.plop_max_entropy = torch.tensor(max_ent)
    train_step, _, put_batch = make_steps(ModelContext(TaskInfo(**TASK1)),
                                          create_method(method_name, **kwargs), N_CLASSES,
                                          device="cpu")
    state, metrics = train_step(state, put_batch(batch))
    grads = {k: p.grad for k, p in model.named_parameters()}
    params, stats = (dict(flat(t)) for t in state_dict_to_flax(model.state_dict()))
    return dict(loss=float(metrics["loss"]), grads=dict(flat(state_dict_to_flax(grads)[0])),
                params=params, stats=stats, protos=state.prototypes.numpy())


@pytest.mark.parametrize("method_name, kwargs", [
    ("loss.BACSLoss", BACS), ("loss.PLOPLoss", {})], ids=["bacs", "plop"])
def test_task1_step_matches_jax(method_name, kwargs, injected):
    """Loss rtol 1e-5; gradients and the update by the norm rule; running
    statistics after the step's train forwards and (BACS) the folded
    prototypes to 1e-5 of their largest values."""
    ref, got = jax_task1(method_name, kwargs), port_task1(method_name, kwargs)
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    assert norm_error(got["grads"], ref["grads"]) <= NORM_RULE
    p0 = dict(flat(flax_variables(N_CLASSES, bool(kwargs))[0]))
    assert norm_error(got["params"], ref["params"], p0) <= NORM_RULE
    assert got["stats"].keys() == ref["stats"].keys()
    for k, r in ref["stats"].items():
        np.testing.assert_allclose(got["stats"][k], r, rtol=0, atol=1e-5 * np.abs(r).max(),
                                   err_msg=k)
    if ref["protos"] is not None:
        np.testing.assert_allclose(got["protos"], ref["protos"], rtol=0,
                                   atol=1e-5 * np.abs(ref["protos"]).max())
