"""Every key the JAX package splits, drawn by the port from the same key, on
the CPU (``bacs_tpu_torch/ops/rng.py`` and each draw site).

The JAX side runs eagerly (``jax.disable_jit``), so each draw site sees a
concrete key; both packages' sites are wrapped to record the key words
(and, for a Bernoulli draw, its shape) they are called with, in program
order, and the two records are held equal:

- the train step's chain: three steps of JAX's jitted ``_train_step_impl``
  and of the port's ``train_step`` from one state key
  (``bacs_tpu/train/step.py:34-37``: ``key, step_key = split(key)``);
- a task-1 BACS step (``bacs_tpu/methods/bacs.py:141,217,290,304,433``:
  the main forward, the alpha sample, autocontrast and forward, the beta
  sample, augmentation and forward, the detector's dropout in each
  forward), with mixup (``:290,356``: the Beta draw) and with the merged
  replay (``:385-391``);
- BACS's and ER's task ends (``bacs.py:476-477,522-524``,
  ``er.py:229-231``: ``PRNGKey(4321 + task)`` and ``PRNGKey(1234 + task)``
  split per batch, the buffer's ``add_batch`` keys);
- a task-2 ER step (``er.py:99,128,139,167``: the partition's ``choice``,
  the sample within it, the replay's augmentation and forward);
- the DataModule's batch keys (``bacs_tpu/data/datamodule.py:305-319``)
  and the batches they augment.

Then the draws themselves, bit for bit from equal keys: a batch's crop
parameters and flips (``transforms.py:53,91,111,133``), the detector's
dropout mask inside the network's forward (``base.py:73``,
``bg_detector.py:53,68``: Flax's key for the module path
``seen_fg_network/dropout``), ER's partition draw (``jax.random.choice``
with ``p``) and its sample, the buffer's reservoir and eviction, and
mixup's Beta draws (``jax.random.beta``).  The networks are UNet-3 at 16^2
with the detector, the weights the port draws for a seed (JAX's, by
``tests/test_torch_seed_init.py``).
"""

import contextlib
import functools
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bacs_tpu.data.transforms as jax_transforms
import bacs_tpu.train.buffer as jax_buffer
import bacs_tpu.train.step as jax_step
from bacs_tpu.config import load_config as jax_load_config
from bacs_tpu.data.datamodule import create_datamodule as jax_create_datamodule
from bacs_tpu.methods import create_method as jax_create_method
from bacs_tpu.methods.base import ModelContext as JaxModelContext
from bacs_tpu.methods.base import StepAux as JaxStepAux
from bacs_tpu.models import create_network as jax_create_network
from bacs_tpu.train import optim as jax_optim
from bacs_tpu.train.state import TaskInfo as JaxTaskInfo
from bacs_tpu.train.state import TrainState as JaxTrainState
import bacs_tpu_torch.data.transforms as port_transforms
import bacs_tpu_torch.methods.bacs as port_bacs
import bacs_tpu_torch.methods.er as port_er
import bacs_tpu_torch.train.buffer as port_buffer
from bacs_tpu_torch.config import load_config
from bacs_tpu_torch.data.datamodule import create_datamodule
from bacs_tpu_torch.methods import ModelContext, create_method
from bacs_tpu_torch.methods.base import StepAux as PortStepAux
from bacs_tpu_torch.models import create_network
from bacs_tpu_torch.ops import rng
from bacs_tpu_torch.train import optim
from bacs_tpu_torch.train.state import TaskInfo, TrainState, frozen_copy
from bacs_tpu_torch.train.step import make_steps
from bacs_tpu_torch.utils.flax_init import init_weights
from bacs_tpu_torch.utils.flax_weights import state_dict_to_flax
from torch_port_helpers import _one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROP, BATCH, N_CLASSES, N_TASKS, OLD, SLOTS, REPLAY, SEED = 16, 4, 21, 6, 16, 8, 4, 3
TASK = dict(initial_classes=OLD, increment=1, num_classes=N_CLASSES, n_tasks=N_TASKS,
            max_epochs=30)
BACS = dict(use_bg_detector=True, bg_weighted_ce=True, alpha=0.8, beta=0.5,
            dark_plus_plus=True, buffer_size=SLOTS, replay_minibatch_size=REPLAY)
ER = dict(buffer_size=SLOTS, replay_minibatch_size=REPLAY)
OPT_CFG = {"_target_": "torch.optim.SGD", "lr": 0.01, "momentum": 0.9, "nesterov": True,
           "weight_decay": 1e-4}
STEP_KEY = 77  # the key a step hands its method, PRNGKey(77) in both packages


def words(k):
    return tuple(int(v) for v in np.asarray(k))


# ---------------------------------------------------------------- networks


@functools.lru_cache(maxsize=None)
def variables(det):
    """The port's seeded UNet-3 weights (JAX's ``model.init`` draws) in
    Flax's layout."""
    model = create_network("unet", N_CLASSES, n_tasks=N_TASKS, use_bg_detector=det,
                           num_layers=3)
    init_weights(model, SEED)
    return state_dict_to_flax(model.state_dict())


def jax_model(det):
    return jax_create_network("unet", N_CLASSES, n_tasks=N_TASKS, use_bg_detector=det,
                              axis_name=None, num_layers=3)


def port_model(det):
    model = create_network("unet", N_CLASSES, n_tasks=N_TASKS, use_bg_detector=det,
                           num_layers=3)
    init_weights(model, SEED)
    return model


@functools.lru_cache(maxsize=None)
def inputs():
    rs = np.random.RandomState(4)

    def labels(n, c):
        lab = rs.randint(0, c, (n, CROP, CROP)).astype(np.int32)
        lab[rs.rand(*lab.shape) < 0.4] = 0
        return lab

    batch = {"image": rs.randn(BATCH, CROP, CROP, 3).astype(np.float32),
             "label": labels(BATCH, OLD + 1)}
    items = [dict(image=rs.randn(6, CROP, CROP, 3).astype(np.float32),
                  logits=rs.randn(6, CROP, CROP, N_CLASSES).astype(np.float32),
                  label=labels(6, OLD), loss=-rs.rand(6).astype(np.float32)) for _ in range(3)]
    protos = rs.randn(N_TASKS, jax_model(True).penultimate_dim).astype(np.float32)
    return batch, items, protos


def jax_filled(slots, part=None, key=5):
    """A JAX buffer of ``slots`` filled from ``inputs`` by ``add_batch``
    (into partition ``part`` = (offset, size, task) if given), from a key."""
    _, items, _ = inputs()
    buf = jax_buffer.init_buffer(slots, (CROP, CROP), (CROP, CROP), N_CLASSES)
    k = jax.random.PRNGKey(key)
    for t, (lo, size) in enumerate(part or [(0, slots)]):
        sub = buf.replace(**{f: getattr(buf, f)[lo:lo + size] for f in SLOT_FIELDS})
        sub = sub.replace(num_seen=jnp.zeros((), jnp.int32))
        for it in items:
            k, s = jax.random.split(k)
            sub = jax_buffer.add_batch(sub, s, *(jnp.asarray(it[f]) for f in
                                                 ("image", "logits", "label", "loss")),
                                       task_id=t, n_classes=OLD)
        buf = buf.replace(**{f: getattr(buf, f).at[lo:lo + size].set(getattr(sub, f))
                             for f in SLOT_FIELDS}, class_counts=sub.class_counts,
                          num_seen=sub.num_seen)
    return buf


SLOT_FIELDS = ("images", "logits", "labels", "importance", "label_mask", "task_ids",
               "n_classes", "valid")


def port_buffer_from(jbuf):
    t = lambda a: torch.from_numpy(np.asarray(a).astype(np.float32))  # noqa: E731
    a = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return port_buffer.BufferState(
        images=t(jbuf.images).to(torch.bfloat16), logits=t(jbuf.logits).to(torch.bfloat16),
        labels=a(jbuf.labels), importance=t(jbuf.importance), label_mask=a(jbuf.label_mask),
        task_ids=a(jbuf.task_ids), n_classes=a(jbuf.n_classes), valid=a(jbuf.valid),
        class_counts=a(jbuf.class_counts), num_seen=int(jbuf.num_seen))


def jax_state(det, buf):
    params, stats = variables(det)
    _, _, protos = inputs()
    tx = jax_optim.make_optimizer(OPT_CFG, jax_optim.poly_schedule(0.01, 10))
    p, bs = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats)
    counts = np.zeros(N_TASKS, np.float32)
    counts[:2] = 50.0
    return JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=p, batch_stats=bs, opt_state=tx.init(p),
        rng=jax.random.PRNGKey(SEED), prototypes=jnp.asarray(protos),
        proto_counts=jnp.asarray(counts), prev_params=p, prev_batch_stats=bs, buffer=buf), tx


def port_state(det, buf):
    model = port_model(det)
    _, _, protos = inputs()
    counts = torch.zeros(N_TASKS)
    counts[:2] = 50.0
    opt, sched = optim.make_optimizer(OPT_CFG, model.parameters(), optim.poly_schedule(0.01, 10))
    return TrainState(model, opt, sched, key=rng.key(SEED),
                      prototypes=torch.from_numpy(protos.copy()), proto_counts=counts,
                      prev_model=frozen_copy(model),
                      buffer=None if buf is None else port_buffer_from(buf))


# ---------------------------------------------------------------- recorders


@contextlib.contextmanager
def jax_recorded(log):
    """Every JAX draw site records (site, key words[, shape]) as it runs,
    eagerly."""
    sample, add_batch, augment = jax_buffer.sample, jax_buffer.add_batch, \
        jax_transforms.replay_augment
    bern, beta, choice = jax.random.bernoulli, jax.random.beta, jax.random.choice
    forward = JaxModelContext.forward
    concrete = lambda k: not isinstance(k, jax.core.Tracer)  # noqa: E731

    def rec(site, k, *extra):
        if k is not None and concrete(k):
            log.append((site, words(k), *extra))

    def spy_forward(self, params, bs, x, train, rng_=None):
        if train:
            rec("forward", rng_)
        return forward(self, params, bs, x, train, rng_)

    def spy_bern(k, p=0.5, shape=None, *a, **kw):
        rec("bernoulli", k, tuple(shape or ()))
        return bern(k, p, shape, *a, **kw)

    with contextlib.ExitStack() as st, jax.disable_jit():
        st.enter_context(mock.patch.object(
            jax_buffer, "sample", lambda buf, k, n, task_id=None: (
                rec("sample", k), sample(buf, k, n, task_id=task_id))[1]))
        st.enter_context(mock.patch.object(
            jax_buffer, "add_batch", lambda buf, k, *a, **kw: (
                rec("add_batch", k), add_batch(buf, k, *a, **kw))[1]))
        st.enter_context(mock.patch.object(
            jax_transforms, "replay_augment", lambda k, im, lb: (
                rec("augment", k), augment(k, im, lb))[1]))
        st.enter_context(mock.patch.object(jax.random, "bernoulli", spy_bern))
        st.enter_context(mock.patch.object(
            jax.random, "beta", lambda k, a, b, shape=None, *x, **kw: (
                rec("beta", k, tuple(shape)), beta(k, a, b, shape, *x, **kw))[1]))
        st.enter_context(mock.patch.object(
            jax.random, "choice", lambda k, *a, **kw: (
                rec("choice", k), choice(k, *a, **kw))[1]))
        st.enter_context(mock.patch.object(JaxModelContext, "forward", spy_forward))
        yield


@contextlib.contextmanager
def port_recorded(log):
    """The port's draw sites record as ``jax_recorded`` does."""
    sample, add_batch = port_buffer.sample, port_buffer.add_batch
    augment, beta_sample = port_transforms.replay_augment, port_bacs.beta_sample
    bern, choice = rng.bernoulli, rng.choice
    forward = ModelContext.forward

    def spy_forward(self, model, x, train, key=None):
        if train:
            log.append(("forward", words(key)))
        return forward(self, model, x, train, key)

    def spy_augment(im, lb, key=None):
        log.append(("augment", words(key)))
        return augment(im, lb, key)

    with contextlib.ExitStack() as st:
        st.enter_context(mock.patch.object(
            port_buffer, "sample", lambda buf, n, key=None, **kw: (
                log.append(("sample", words(key))), sample(buf, n, key, **kw))[1]))
        st.enter_context(mock.patch.object(
            port_buffer, "add_batch", lambda *a, key=None, **kw: (
                log.append(("add_batch", words(key))), add_batch(*a, key=key, **kw))[1]))
        for module in (port_bacs, port_er):
            st.enter_context(mock.patch.object(module, "replay_augment", spy_augment))
        st.enter_context(mock.patch.object(
            rng, "bernoulli", lambda k, p, shape, device="cpu": (
                log.append(("bernoulli", words(k), tuple(shape))), bern(k, p, shape, device))[1]))
        st.enter_context(mock.patch.object(
            port_bacs, "beta_sample", lambda a, n, k, device: (
                log.append(("beta", words(k), (n,))), beta_sample(a, n, k, device))[1]))
        st.enter_context(mock.patch.object(
            rng, "choice", lambda k, p: (log.append(("choice", words(k))), choice(k, p))[1]))
        st.enter_context(mock.patch.object(ModelContext, "forward", spy_forward))
        yield


# ---------------------------------------------------------------- key trees


def jax_bacs_step(task_id, kw, buf):
    state, _ = jax_state(True, buf)
    batch, _, _ = inputs()
    ctx = JaxModelContext(model=jax_model(True), task=JaxTaskInfo(task_id=task_id, **TASK),
                          axis_name=None)
    method = jax_create_method(kw.pop("name"), **kw)
    log = []
    with jax_recorded(log):
        loss, _ = method.compute_loss(ctx, state.params, state,
                                      {k: jnp.asarray(v) for k, v in batch.items()}, True,
                                      jax.random.PRNGKey(STEP_KEY))
    return log, float(loss)


def port_bacs_step(task_id, kw, buf):
    state = port_state(True, buf)
    batch, _, _ = inputs()
    ctx = ModelContext(TaskInfo(task_id=task_id, **TASK))
    method = create_method(kw.pop("name"), **kw)
    log = []
    with port_recorded(log):
        loss, _ = method.compute_loss(ctx, state, {k: torch.from_numpy(v) for k, v in
                                                   batch.items()}, True, rng.key(STEP_KEY))
    return log, float(loss.detach())


STEPS = {
    "bacs": (1, dict(name="loss.BACSLoss", **BACS), SLOTS, None),
    "bacs_mixup": (1, dict(name="loss.BACSLoss", mixup=True, **BACS), SLOTS, None),
    "bacs_merged": (1, dict(name="loss.BACSLoss", merged_replay=True,
                            **{**BACS, "bg_weighted_ce": False}), SLOTS, None),
    "er_task2": (2, dict(name="loss.ExperienceReplay", **ER), SLOTS * N_TASKS,
                 [(0, SLOTS), (SLOTS, SLOTS)]),
}


@pytest.mark.parametrize("name", list(STEPS))
def test_step_draws_take_jax_keys(name):
    """The keys of every draw of one training step (and their order), and
    the step's loss (rtol 1e-4)."""
    task_id, kw, slots, part = STEPS[name]
    buf = jax_filled(slots, part)
    ref, ref_loss = jax_bacs_step(task_id, dict(kw), buf)
    got, got_loss = port_bacs_step(task_id, dict(kw), buf)
    sites = {s[0] for s in ref}
    assert {"forward", "sample", "augment" if name != "bacs_mixup" else "beta"} <= sites
    if name == "er_task2":
        assert "choice" in sites
    assert got == ref
    assert got_loss == pytest.approx(ref_loss, rel=1e-4)


class JaxKeyMethod:
    """A JAX method whose loss is its one parameter's square and which
    records, at run time, the key each train step hands it."""

    def __init__(self, seen):
        self.seen = seen

    def compute_loss(self, ctx, params, state, batch, train, k):
        jax.debug.callback(lambda w: self.seen.append(words(w)), k, ordered=True)
        return jnp.sum(params["w"] ** 2), JaxStepAux(logits=None, batch_stats={},
                                                      state_updates={}, metrics={})


class PortKeyMethod:
    """The port's counterpart of ``JaxKeyMethod``."""

    def __init__(self, seen):
        self.seen = seen

    def compute_loss(self, ctx, state, batch, train, key=None):
        self.seen.append(key)
        w = next(state.model.parameters())
        return (w ** 2).sum(), PortStepAux(sem_logits=None, output=None, n_cur=0)


def test_the_step_chain_takes_jax_keys():
    """Three train steps of ``bacs_tpu/train/step.py``'s jitted
    ``_train_step_impl`` and of the port's ``train_step`` from one state
    key: the key each step hands its method and the state's key after
    each (``key, step_key = split(key)``; the rank fold under data
    parallelism is ``tests/test_torch_rng.py``'s)."""
    import optax

    task = dict(task_id=0, initial_classes=2, increment=0, num_classes=2, n_tasks=1)
    seen = []
    tx = optax.sgd(0.1)
    step = jax.jit(functools.partial(
        jax_step._train_step_impl, JaxModelContext(model=None, task=JaxTaskInfo(**task)),
        JaxKeyMethod(seen), tx))
    p = {"w": jnp.ones(3)}
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=p, batch_stats={},
                          opt_state=tx.init(p), rng=jax.random.PRNGKey(SEED),
                          prototypes=jnp.zeros((1, 1)), proto_counts=jnp.zeros(1))
    ref_keys = []
    for _ in range(3):
        state, _ = step(state, {})
        ref_keys.append(words(state.rng))
    jax.effects_barrier()
    model = torch.nn.Linear(3, 1, bias=False)
    opt, sched = optim.make_optimizer(OPT_CFG, model.parameters(), optim.poly_schedule(0.1, 10))
    port = TrainState(model, opt, sched, key=rng.key(SEED))
    got = []
    train_step, _, _ = make_steps(ModelContext(TaskInfo(**task)), PortKeyMethod(got), 2,
                                  device="cpu")
    got_keys = []
    for _ in range(3):
        port, _ = train_step(port, {})
        got_keys.append(port.key)
    assert got == seen and len(set(seen)) == 3
    assert got_keys == ref_keys


@pytest.mark.parametrize("method", ["bacs", "er"])
def test_task_end_fills_take_jax_keys(method):
    """``end_task`` over three batches: every forward's and ``add_batch``'s
    key (JAX's ``PRNGKey(4321 + task)`` / ``PRNGKey(1234 + task)`` split
    per batch), and the buffer after it, bit for bit."""
    kw = (dict(name="loss.BACSLoss", **BACS) if method == "bacs"
          else dict(name="loss.ExperienceReplay", **ER))
    slots = SLOTS if method == "bacs" else SLOTS * N_TASKS
    _, items, _ = inputs()
    data = [{"image": it["image"], "label": it["label"]} for it in items]
    jbuf = jax_buffer.init_buffer(slots, (CROP, CROP), (CROP, CROP), N_CLASSES)
    state, _ = jax_state(method == "bacs", jbuf)
    ctx = JaxModelContext(model=jax_model(method == "bacs"),
                          task=JaxTaskInfo(task_id=0, **TASK), axis_name=None)
    jm = jax_create_method(kw.pop("name"), **kw)
    ref = []
    with jax_recorded(ref):
        jstate = jm.end_task(state, ctx, [{k: jnp.asarray(v) for k, v in d.items()}
                                          for d in data])
    pstate = port_state(method == "bacs", jax_buffer.init_buffer(
        slots, (CROP, CROP), (CROP, CROP), N_CLASSES))
    pm = create_method(("loss.BACSLoss" if method == "bacs" else "loss.ExperienceReplay"), **kw)
    got = []
    with port_recorded(got):
        pstate = pm.end_task(pstate, ModelContext(TaskInfo(task_id=0, **TASK)),
                             [{k: torch.from_numpy(v) for k, v in d.items()} for d in data])
    assert [s for s, *_ in ref].count("add_batch") >= 1
    assert got == ref
    for f in ("task_ids", "valid", "label_mask", "n_classes"):
        np.testing.assert_array_equal(getattr(pstate.buffer, f).numpy(),
                                      np.asarray(getattr(jstate.buffer, f)), err_msg=f)
    assert pstate.buffer.num_seen == int(jstate.buffer.num_seen)


# ---------------------------------------------------------------- the draws


@pytest.mark.parametrize("hw,n", [((64, 64), 16), ((37, 53), 5), ((512, 512), 16)])
def test_crop_parameters_and_flips_equal_jax(hw, n):
    """``train_transform``'s per-image draws (``split(key, n)``, then
    ``_augment_one``'s crop and flip keys): the region and the flip of
    every image bit for bit."""
    k = jax.random.PRNGKey(hw[0] + n)

    def one(r):
        r_crop, r_flip = jax.random.split(r)
        i, j, ch, cw = jax_transforms._sample_crop_params(r_crop, hw, hw[0])
        return i, j, ch, cw, jax.random.bernoulli(r_flip)

    ref = jax.jit(jax.vmap(one))(jax.random.split(k, n))
    got = port_transforms.sample_crop_params(n, hw, words(k))
    for name, a in zip(("i", "j", "ch", "cw", "flip"), ref):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(a), err_msg=name)
    assert 0 < int(got["flip"].sum()) < n


def test_train_transform_equals_jax():
    """The whole train transform from one key: the labels bit for bit, the
    images to f32 rounding."""
    rs = np.random.RandomState(2)
    imgs = rs.randint(0, 256, (6, 40, 40, 3)).astype(np.uint8)
    lbls = rs.randint(0, 6, (6, 40, 40)).astype(np.uint8)
    table = np.concatenate([np.arange(6), np.full(250, 255)]).astype(np.int32)
    k = jax.random.PRNGKey(8)
    ref = jax_transforms.train_transform(k, jnp.asarray(imgs), jnp.asarray(lbls),
                                         jnp.asarray(table), crop=32)
    got = port_transforms.train_transform(words(k), torch.from_numpy(imgs),
                                          torch.from_numpy(lbls), torch.from_numpy(table),
                                          crop=32)
    np.testing.assert_array_equal(got["label"].numpy(), np.asarray(ref["label"]))
    np.testing.assert_allclose(got["image"].numpy(), np.asarray(ref["image"]), rtol=0,
                               atol=2e-5)


def test_datamodule_batches_take_jax_keys():
    """``conf/continual_debug``'s DataModule, task 0's first epoch: each
    batch's augmentation key (the epoch's ``PRNGKey`` split per batch) and
    the augmented batch."""
    conf = os.path.join(ROOT, "conf", "continual_debug")
    overrides = ["dataset.dataset.crop_size=32", "training.debug=false",
                 "+dataset.dataset.n_train=24"]
    ref_keys, got_keys = [], []
    jt, pt = jax_transforms.train_transform, port_transforms.train_transform
    with mock.patch.object(jax_transforms, "train_transform", lambda k, *a, **kw: (
            ref_keys.append(words(k)), jt(k, *a, **kw))[1]):
        jdm = jax_create_datamodule(jax_load_config(conf, "config", overrides))
        jdm.set_task_id(0)
        ref = [jax.tree.map(np.asarray, b) for b in jdm.train_batches(0)]
    with mock.patch.object(port_transforms, "train_transform", lambda k, *a, **kw: (
            got_keys.append(k), pt(k, *a, **kw))[1]):
        pdm = create_datamodule(load_config(conf, "config", overrides), device="cpu")
        pdm.set_task_id(0)
        got = list(pdm.train_batches(0))
    assert got_keys == ref_keys and len(ref_keys) == len(ref) >= 2
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g["label"].numpy(), r["label"])
        np.testing.assert_allclose(g["image"].numpy(), r["image"], rtol=0, atol=2e-5)


def test_dropout_mask_equals_jax():
    """The detector's dropout in a train-mode forward: Flax's key of
    ``seen_fg_network/dropout`` under the forward's key, and the mask
    (the zeros of the trunk's output where its ReLU is not zero)."""
    params, stats = variables(True)
    x = np.random.RandomState(1).randn(2, CROP, CROP, 3).astype(np.float32)
    k = jax.random.PRNGKey(12)
    ref_log, got_log = [], []
    with jax_recorded(ref_log):
        out, _ = jax_model(True).apply({"params": params, "batch_stats": stats},
                                       jnp.asarray(x), train=True, mutable=["batch_stats"],
                                       rngs={"dropout": k})
    model = port_model(True).train()
    with port_recorded(got_log), torch.no_grad():
        got = model(torch.from_numpy(x), key=words(k))
    assert got_log == ref_log and len(ref_log) == 1 and len(ref_log[0][2]) == 4
    ref_pen, got_pen = np.asarray(out.penultimate), got.penultimate.numpy()
    assert ((ref_pen == 0) != (got_pen == 0)).mean() < 1e-3
    np.testing.assert_allclose(got_pen, ref_pen, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 42])
def test_er_partition_choice_equals_jax(seed):
    """``jax.random.choice(key, n, p=scores)`` for the partition, and
    ``sample``'s slots, for a spread of keys."""
    p = np.float32([0.2, 0.5, 0.3])
    keys = jax.random.split(jax.random.PRNGKey(seed), 64)
    ref = np.array([int(jax.random.choice(k, 3, p=jnp.asarray(p))) for k in keys])
    got = np.array([int(rng.choice(words(k), torch.from_numpy(p))) for k in keys])
    np.testing.assert_array_equal(got, ref)
    assert set(ref) == {0, 1, 2}
    jbuf = jax_filled(SLOTS)
    pbuf = port_buffer_from(jbuf)
    for k in keys[:8]:
        np.testing.assert_array_equal(
            port_buffer.sample(pbuf, REPLAY, words(k))["indices"].numpy(),
            np.asarray(jax_buffer.sample(jbuf, k, REPLAY)["indices"]))


def test_reservoir_and_eviction_equal_jax():
    """``add_batch`` from keys past the buffer's size (the reservoir draw and
    the score-weighted eviction): every slot field and counter."""
    jbuf = jax_filled(4, key=9)
    pbuf = port_buffer.init_buffer(4, (CROP, CROP), (CROP, CROP), N_CLASSES, device="cpu")
    _, items, _ = inputs()
    k = rng.key(9)
    for it in items:
        k, s = rng.split(k)
        port_buffer.add_batch(pbuf, *(torch.from_numpy(it[f]) for f in
                                      ("image", "logits", "label", "loss")),
                              task_id=0, n_classes=OLD, key=s)
    assert int(jbuf.num_seen) == pbuf.num_seen == 18
    for f in SLOT_FIELDS + ("class_counts",):
        np.testing.assert_array_equal(
            getattr(pbuf, f).float().numpy(), np.asarray(getattr(jbuf, f), np.float32), f)


@pytest.mark.parametrize("a", [1.0, 0.4, 2.0])
def test_mixup_beta_draws_equal_jax(a):
    """``jax.random.beta(key, a, a, (12,))`` bit for bit over a spread of
    keys (Marsaglia and Tsang's loops, XLA's CPU log and exp)."""
    for seed in range(8):
        k = jax.random.PRNGKey(100 + seed)
        ref = np.asarray(jax.random.beta(k, a, a, (12,)))
        np.testing.assert_array_equal(rng.beta(words(k), a, a, 12).numpy(), ref)
