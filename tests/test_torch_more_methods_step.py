"""The ER, SDR, iCaRL and Prototypes slice as a whole against the JAX
package, on the CPU, and MiB and PLOP with ``bg_weighted_ce``.

DeepLabV3-ResNet-18 at 64^2, batch 4, VOC-21 split 16+1 (task 1: 17
current classes, 16 old), f32, every ABN with the identity activation so
that the two packages agree to f32 rounding (``tests/test_torch_train_step.py``
explains why the leaky kink does not).  The current and the previous model
share their convolutions and differ in every ABN vector, so the
distillation terms are not ties.  One step of each method, the JAX side
``_train_step_impl`` (``bacs_tpu/train/step.py``) written out to return
the gradients and, on the state before the step, each term of the loss;
the port side ``make_steps``.

ER's replay draws are injected identically on both sides with monkeypatch
(the pattern of ``tests/test_torch_bacs_step.py``): the buffer sample takes
fixed Gumbel keys, the replay crop and flip fixed parameters; at task 1 the
replayed partition is task 0's, no draw.  ER's ``end_task`` takes the
uniforms JAX draws from its key.  MiB and PLOP with ``bg_weighted_ce`` run
on the network with the seen detector (dropout rate 0 on both sides).
"""

import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import bacs_tpu.data.transforms as jax_transforms
import bacs_tpu.methods.er as jax_er
import bacs_tpu.models.deeplab as jax_deeplab
from bacs_tpu.methods import create_method as jax_create_method
from bacs_tpu.methods.base import ModelContext as JaxModelContext
from bacs_tpu.models.norm import ABN as JaxABN
from bacs_tpu.train import buffer as jax_buffer
from bacs_tpu.train import optim as jax_optim
from bacs_tpu.train.state import TaskInfo as JaxTaskInfo
from bacs_tpu.train.state import TrainState as JaxTrainState
from bacs_tpu.train.step import make_steps as jax_make_steps
import bacs_tpu_torch.methods.er as port_er
from bacs_tpu_torch.data.transforms import apply_crop_params
from bacs_tpu_torch.methods import ModelContext, create_method
from bacs_tpu_torch.models.deeplab import DeepLabV3
from bacs_tpu_torch.models.norm import ABN
from bacs_tpu_torch.train import buffer as port_buffer
from bacs_tpu_torch.train import optim
from bacs_tpu_torch.train.state import TaskInfo, TrainState, frozen_copy
from bacs_tpu_torch.train.step import make_steps
from bacs_tpu_torch.utils.flax_weights import load_flax_variables, state_dict_to_flax
from torch_port_helpers import randomize_abn

CROP, BATCH, N_CLASSES, N_TASKS, OLD, SLOTS, REPLAY = 64, 4, 21, 6, 16, 8, 4
# the penultimate width: the backbone's 512, or the detector's trunk's 128
DIM = {False: 512, True: 128}
TASK = dict(initial_classes=16, increment=1, num_classes=N_CLASSES, n_tasks=N_TASKS,
            max_epochs=30)
OPT_CFG = {"_target_": "torch.optim.SGD", "lr": 0.01, "momentum": 0.9,
           "nesterov": True, "weight_decay": 1e-4}
MAX_ITERS = 10
ER = dict(buffer_size=SLOTS, replay_minibatch_size=REPLAY, alpha=0.7)
BGW = dict(bg_weighted_ce=True, use_bg_detector=True)
# (registry name, method kwargs, task, network with the seen detector)
CASES = {
    "er": ("loss.ExperienceReplay", ER, 1, False),
    "sdr": ("loss.SDR", {}, 1, False),
    "icarl": ("loss.IcarlLoss", {}, 1, False),
    "prototypes": ("loss.Prototypes", {}, 0, False),
    "mib_bgw": ("loss.MiB", BGW, 1, True),
    "plop_bgw": ("loss.PlopLoss", BGW, 1, True),
}


def jax_model(detector):
    return jax_deeplab.DeepLabV3(num_classes=N_CLASSES, backbone_name="resnet18",
                                 n_tasks=N_TASKS, use_bg_detector=detector,
                                 norm=functools.partial(JaxABN, activation="identity"))


def port_model(variables, detector):
    model = DeepLabV3(N_CLASSES, backbone_name="resnet18", n_tasks=N_TASKS,
                      use_bg_detector=detector,
                      norm=functools.partial(ABN, activation="identity"))
    if detector:
        model.seen_fg_network.dropout_rate = 0.0
    load_flax_variables(model, *variables)
    return model


@functools.lru_cache(maxsize=None)
def flax_variables(detector):
    """(current, previous) Flax (params, batch_stats): the same convolutions,
    every ABN vector drawn anew for each."""
    x = np.zeros((1, CROP, CROP, 3), np.float32)
    v = jax.jit(lambda k, x: jax_model(detector).init(k, x, train=False))(
        jax.random.PRNGKey(0), x)
    out = []
    for seed in (11, 12):
        rs = np.random.RandomState(seed)
        out.append((randomize_abn(v["params"], rs), randomize_abn(v["batch_stats"], rs)))
    return tuple(out)


def labels_of(rs, n, n_classes):
    """Labels in [0, n_classes), ~40 % background, ~5 % ignored."""
    lab = rs.randint(0, n_classes, (n, CROP, CROP)).astype(np.int32)
    lab[rs.rand(*lab.shape) < 0.4] = 0
    lab[rs.rand(*lab.shape) < 0.05] = 255
    return lab


@functools.lru_cache(maxsize=None)
def inputs():
    """Seeded numpy inputs: the task-1 batch, three task-0 batches, the
    task prototypes and counts, SDR's class prototypes and counts, ER's
    Gumbel keys and crop parameters."""
    rs = np.random.RandomState(5)
    batch = {"image": rs.randn(BATCH, CROP, CROP, 3).astype(np.float32),
             "label": labels_of(rs, BATCH, OLD + 1)}
    task0 = [{"image": rs.randn(BATCH, CROP, CROP, 3).astype(np.float32),
              "label": labels_of(rs, BATCH, OLD)} for _ in range(3)]
    protos = {k: rs.randn(N_TASKS, d).astype(np.float32) for k, d in DIM.items()}
    counts = np.zeros(N_TASKS, np.float32)
    counts[0] = 50.0
    class_protos = np.zeros((N_CLASSES, DIM[False]), np.float32)
    class_protos[:OLD] = rs.rand(OLD, DIM[False]).astype(np.float32)
    class_counts = np.zeros(N_CLASSES, np.float32)
    class_counts[:OLD] = rs.randint(1, 60, OLD).astype(np.float32)
    keys = np.asarray(jax.random.gumbel(jax.random.PRNGKey(21), (SLOTS * N_TASKS,)))
    crop = dict(i=np.float32([3.5, 0.0, 20.25, 0.0]), j=np.float32([0.0, 7.25, 1.0, 0.0]),
                ch=np.float32([40.0, 64.0, 30.5, 64.0]),
                cw=np.float32([52.5, 33.0, 60.0, 64.0]),
                flip=np.array([True, False, False, True]))
    return dict(batch=batch, task0=task0, protos=protos, counts=counts,
                class_protos=class_protos, class_counts=class_counts, keys=keys, crop=crop)


@pytest.fixture
def injected(monkeypatch):
    """ER's replay draws, made identical in both packages; the seen
    detector's dropout off in JAX."""
    inp = inputs()
    crop = inp["crop"]
    sample = jax_buffer.sample
    monkeypatch.setattr(jax_er.buffer_lib, "sample",
                        lambda buf, rng, n, task_id=None: sample(
                            buf, jax.random.PRNGKey(21), n, task_id=task_id))

    def jax_augment(rng, images, labels):
        def one(im, lb, i, j, ch, cw, f):
            img = jax_transforms._resize_region(im, i, j, ch, cw, CROP, "bilinear")
            lbl = jax_transforms._resize_region(lb, i, j, ch, cw, CROP, "nearest")
            return jnp.where(f, img[:, ::-1], img), jnp.where(f, lbl[:, ::-1], lbl)
        return jax.vmap(one)(images, labels, *(jnp.asarray(crop[k]) for k in
                                               ("i", "j", "ch", "cw", "flip")))

    monkeypatch.setattr(jax_transforms, "replay_augment", jax_augment)
    monkeypatch.setattr(jax_deeplab, "BgDetector",
                        functools.partial(jax_deeplab.BgDetector, dropout_rate=0.0))
    psample = port_buffer.sample
    keys = torch.from_numpy(inp["keys"].copy())
    monkeypatch.setattr(port_er.buffer_lib, "sample",
                        lambda buf, n, gen=None, task_id=None: psample(
                            buf, n, keys=keys, task_id=task_id))
    params = {k: torch.from_numpy(v) for k, v in crop.items()}
    monkeypatch.setattr(port_er, "replay_augment",
                        lambda im, lab, gen=None: apply_crop_params(im, lab, params))


def jax_uniforms(task_id, n_batches, n):
    """The reservoir's uniforms that JAX ``ExperienceReplayMethod.end_task``
    draws per batch from ``PRNGKey(1234 + task_id)``
    (``bacs_tpu/methods/er.py:224-236``, ``buffer.py:166-169``)."""
    rng, out = jax.random.PRNGKey(1234 + task_id), []
    for _ in range(n_batches):
        rng, sub = jax.random.split(rng)
        k1, k2 = jax.random.split(sub)
        out.append((torch.from_numpy(np.array(jax.random.uniform(k1, (n,)))),
                    torch.from_numpy(np.array(jax.random.uniform(k2, (n,))))))
    return out


@functools.lru_cache(maxsize=None)
def er_buffers():
    """ER's ``end_task`` of task 0 over the three task-0 batches into the
    8-slot partition 0 of a 6 x 8-slot buffer, in both packages: (the JAX
    buffer, the port's)."""
    (params, stats), _ = flax_variables(False)
    inp = inputs()
    ctx0 = dict(task_id=0, **TASK)
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=jax.tree.map(jnp.asarray, params),
        batch_stats=jax.tree.map(jnp.asarray, stats), opt_state=None,
        rng=jax.random.PRNGKey(2), prototypes=jnp.zeros((N_TASKS, DIM[False])),
        proto_counts=jnp.zeros((N_TASKS,)),
        buffer=jax_create_method("loss.ExperienceReplay", **ER).init_buffer(
            JaxTaskInfo(**ctx0), (CROP, CROP), (4, 4)))
    jctx = JaxModelContext(model=jax_model(False), task=JaxTaskInfo(**ctx0), axis_name=None)
    jdata = [{k: jnp.asarray(v) for k, v in b.items()} for b in inp["task0"]]
    ref = jax_create_method("loss.ExperienceReplay", **ER).end_task(jstate, jctx, jdata)

    method = create_method("loss.ExperienceReplay", **ER)
    model = port_model(flax_variables(False)[0], False)
    opt, sched = optim.make_optimizer(OPT_CFG, model.parameters(),
                                      optim.poly_schedule(0.01, MAX_ITERS))
    state = TrainState(model, opt, sched, prototypes=torch.zeros(N_TASKS, DIM[False]),
                       proto_counts=torch.zeros(N_TASKS),
                       buffer=method.init_buffer(TaskInfo(**ctx0), (CROP, CROP), (4, 4),
                                                 device="cpu"))
    queue = iter(jax_uniforms(0, len(inp["task0"]), BATCH))
    add = port_buffer.add_batch
    saved = port_er.buffer_lib.add_batch
    port_er.buffer_lib.add_batch = lambda *a, **kw: add(*a, **{**kw, "uniforms": next(queue)})
    try:
        data = [{k: torch.from_numpy(v) for k, v in b.items()} for b in inp["task0"]]
        state = method.end_task(state, ModelContext(TaskInfo(**ctx0)), data)
    finally:
        port_er.buffer_lib.add_batch = saved
    return ref.buffer, state.buffer


def port_buffer_from(jbuf):
    """The JAX buffer's arrays as a port ``BufferState``."""
    t = torch.from_numpy
    return port_buffer.BufferState(
        images=t(np.asarray(jbuf.images).astype(np.float32)).to(torch.bfloat16),
        logits=t(np.asarray(jbuf.logits).astype(np.float32)).to(torch.bfloat16),
        **{f: t(np.array(getattr(jbuf, f))) for f in (
            "labels", "importance", "label_mask", "task_ids", "n_classes", "valid",
            "class_counts")},
        num_seen=int(jbuf.num_seen))


def jax_state(name, tx):
    """The JAX state before the step: (params, statistics) of the case's
    network, the previous model at task 1, the case's extra fields."""
    _, _, task_id, detector = CASES[name]
    (params, stats), (pp, ps) = flax_variables(detector)
    inp = inputs()
    p = jax.tree.map(jnp.asarray, params)
    extra = {}
    if task_id > 0 and name != "er":
        extra = dict(prev_params=jax.tree.map(jnp.asarray, pp),
                     prev_batch_stats=jax.tree.map(jnp.asarray, ps))
    if name == "er":
        extra["buffer"] = er_buffers()[0]
    if name == "sdr":
        extra.update(class_prototypes=jnp.asarray(inp["class_protos"]),
                     class_proto_counts=jnp.asarray(inp["class_counts"]))
    return JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=p, batch_stats=jax.tree.map(jnp.asarray, stats),
        opt_state=tx.init(p), rng=jax.random.PRNGKey(2),
        prototypes=jnp.asarray(inp["protos"][detector]), proto_counts=jnp.asarray(inp["counts"]),
        **extra)


def port_state(name):
    _, _, task_id, detector = CASES[name]
    cur, prev = flax_variables(detector)
    inp = inputs()
    model = port_model(cur, detector)
    opt, sched = optim.make_optimizer(OPT_CFG, model.parameters(),
                                      optim.poly_schedule(0.01, MAX_ITERS))
    state = TrainState(model, opt, sched, generator=torch.Generator().manual_seed(0),
                       prototypes=torch.from_numpy(inp["protos"][detector].copy()),
                       proto_counts=torch.from_numpy(inp["counts"].copy()))
    if task_id > 0 and name != "er":
        state.prev_model = frozen_copy(port_model(prev, detector))
    if name == "er":
        state.buffer = port_buffer_from(er_buffers()[0])
    if name == "sdr":
        state.class_prototypes = torch.from_numpy(inp["class_protos"].copy())
        state.class_proto_counts = torch.from_numpy(inp["class_counts"].copy())
    return state


def flat(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float32)


def joined(d):
    """Each ABN's scale and bias joined: with identity activations a norm
    whose output reaches the loss only through 1 x 1 convolutions into the
    next one has a bias gradient of exactly 0, rounding noise in both
    packages (``chip_smoke.py``, ``abn_joined``)."""
    out = {}
    for k, v in d.items():
        stem, leaf = k.rsplit("/", 1)
        if leaf in ("scale", "bias") and f"{stem}/scale" in d:
            out[stem] = np.concatenate([d[f"{stem}/scale"], d[f"{stem}/bias"]])
        else:
            out[k] = v
    return out


def step_batch(name):
    """The case's batch: task 0's labels (16 classes) at task 0, else the
    task-1 batch (17)."""
    inp = inputs()
    return inp["task0"][0] if CASES[name][2] == 0 else inp["batch"]


def jax_terms(name, method, ctx, state, data, rng):
    """Each term of the loss on ``state`` (inside the step's jit)."""
    task = ctx.task
    p, image, mask = state.params, data["image"], data["label"]
    if name == "er":
        main, _, _, bs, _ = method.compute_base_loss(ctx, p, state, image, mask, True, rng,
                                                     same_task=True)
        return main, method._replay_er_loss(ctx, p, state, bs, rng)[0]
    if name == "sdr":
        out, _ = ctx.forward(p, state.batch_stats, image, True, rng)
        feats = out.penultimate
        ce = method.uce_with_upsample(ctx, out.sem_logits[..., :ctx.n_cur],
                                      out.logits[..., :ctx.n_cur], mask, task.old_classes)
        protos, _ = method._update_class_prototypes(state, feats, mask, task, None)
        old_out = ctx.forward_prev(state, image)
        return (ce, method._feature_sparsification(mask, feats, task),
                method._clustering_separation(mask, feats, protos, task),
                method._proto_distillation(ctx, old_out, feats, mask, protos, task),
                method.loss_kd * method.ukd_with_upsample(ctx, out, old_out, mask))
    return ()


def port_terms(name, method, ctx, state, data):
    image, mask = data["image"], data["label"]
    if name == "er":
        main = method.compute_base_loss(ctx, state, image, mask, True, same_task=True).loss
        return main, method._replay_er_loss(ctx, state, None)
    if name == "sdr":
        out = ctx.forward(state.model, image, True)
        terms = method.distill_terms(ctx, state, out, image, mask)
        return (method.uce_with_upsample(ctx, out, mask), terms["sparsification"],
                terms["clustering_separation"], terms["proto_distillation"], terms["ukd"])
    return ()


@functools.lru_cache(maxsize=None)
def jax_step(name):
    target, kw, task_id, detector = CASES[name]
    data = {k: jnp.asarray(v) for k, v in step_batch(name).items()}
    tx = jax_optim.make_optimizer(OPT_CFG, jax_optim.poly_schedule(0.01, MAX_ITERS))
    state = jax_state(name, tx)
    ctx = JaxModelContext(model=jax_model(detector),
                          task=JaxTaskInfo(task_id=task_id, **TASK), axis_name=None)
    method = jax_create_method(target, **kw)
    rng = jax.random.PRNGKey(9)

    @jax.jit
    def step(state, data):
        def loss_fn(p):
            return method.compute_loss(ctx, p, state, data, True, rng)

        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        updates, _ = tx.update(grads, state.opt_state, state.params)
        return (loss, grads, optax.apply_updates(state.params, updates), aux.batch_stats,
                aux.state_updates, jax_terms(name, method, ctx, state, data, rng))

    loss, grads, params, stats, upd, terms = step(state, data)
    return dict(loss=float(loss), grads=dict(flat(grads)), params=dict(flat(params)),
                stats=dict(flat(stats)), p0=dict(flat(state.params)),
                updates={k: np.asarray(v) for k, v in upd.items()},
                terms=[float(t) for t in terms])


@functools.lru_cache(maxsize=None)
def port_step(name):
    target, kw, task_id, _ = CASES[name]
    ctx = ModelContext(TaskInfo(task_id=task_id, **TASK))
    method = create_method(target, **kw)
    train_step, _, put_batch = make_steps(ctx, method, N_CLASSES, device="cpu")
    data = put_batch(step_batch(name))
    state, metrics = train_step(port_state(name), data)
    grads = {k: p.grad for k, p in state.model.named_parameters()}
    params, stats = state_dict_to_flax(state.model.state_dict())
    updates = {k: getattr(state, k).numpy() for k in (
        "prototypes", "proto_counts", "class_prototypes", "class_proto_counts")
        if getattr(state, k) is not None}
    terms = port_terms(name, method, ctx, port_state(name), data)
    return dict(loss=float(metrics["loss"]), grads=dict(flat(state_dict_to_flax(grads)[0])),
                params=dict(flat(params)), stats=dict(flat(stats)), updates=updates,
                terms=[float(t.detach()) for t in terms], state=state, method=method,
                ctx=ctx)


@pytest.mark.parametrize("name", list(CASES))
def test_step_matches_jax(name, injected):
    """One step: loss rtol 1e-5; every gradient tensor and every SGD update
    within 1e-4 of the tensor's largest value (each ABN's scale and bias
    joined; an update beyond one ulp of its parameter); the running
    statistics rtol 1e-5; the state updates JAX's step returns (task and
    class prototypes and counts) rtol 1e-5 of their largest value, the
    counts equal."""
    ref, got = jax_step(name), port_step(name)
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    gj, rj = joined(got["grads"]), joined(ref["grads"])
    assert gj.keys() == rj.keys()
    for k, r in rj.items():
        np.testing.assert_allclose(gj[k], r, rtol=0, atol=1e-4 * np.abs(r).max(), err_msg=k)
    p0 = ref["p0"]
    for k, r in ref["params"].items():
        upd = np.abs(r - p0[k]).max()
        ulp = np.finfo(np.float32).eps * np.abs(p0[k]).max()
        np.testing.assert_allclose(got["params"][k], r, rtol=0, atol=1e-4 * upd + ulp,
                                   err_msg=k)
    assert got["stats"].keys() == ref["stats"].keys()
    for k, r in ref["stats"].items():
        np.testing.assert_allclose(got["stats"][k], r, rtol=1e-5, atol=1e-5 * np.abs(r).max(),
                                   err_msg=k)
    for k, r in ref["updates"].items():
        if "counts" in k:
            np.testing.assert_array_equal(got["updates"][k], r, err_msg=k)
        else:
            np.testing.assert_allclose(got["updates"][k], r, rtol=1e-5,
                                       atol=1e-5 * np.abs(r).max(), err_msg=k)
    assert got["state"].step == 1


@pytest.mark.parametrize("name", ["er", "sdr"])
def test_loss_terms_match_jax(name, injected):
    """Each term on the state before the step, rtol 1e-5: ER's main CE (K1's
    plain version) and its replay CE (K4's), the step's loss their sum with
    alpha applied twice; SDR's unbiased CE (K6's), sparsification,
    clustering and separation, prototype distillation and loss_kd times
    the unbiased KD (K7's), their sum the step's loss."""
    ref, got = jax_step(name), port_step(name)
    np.testing.assert_allclose(got["terms"], ref["terms"], rtol=1e-5)
    # SDR's sparsification is 0 here: with identity activations the
    # normalised features sum below 0 (the ops test holds the term itself)
    positive = [t for i, t in enumerate(got["terms"]) if not (name == "sdr" and i == 1)]
    assert all(t > 0 for t in positive), got["terms"]
    if name == "er":
        main, replay = got["terms"]
        total = main + ER["alpha"] ** 2 * replay
    else:
        total = sum(got["terms"])
    np.testing.assert_allclose(total, got["loss"], rtol=1e-5)


def test_er_end_task_matches_jax():
    """ER's ``end_task`` of task 0, eval mode, into partition 0 of 8 slots
    over three batches of 4: it stops once 8 items were offered (two
    batches), on the uniforms JAX draws.  Slot decisions, labels, class
    masks and counts equal; images equal (bf16 storage of the same
    inputs); importances (minus the mean class-weighted NLL) rtol 1e-5;
    stored bf16 logits within one bf16 rounding of values that agree to
    1e-5 of the largest."""
    jbuf, buf = er_buffers()
    assert buf.num_seen == int(jbuf.num_seen) == 2 * BATCH
    assert int(buf.valid.sum()) == SLOTS and bool(buf.valid[:SLOTS].all())
    for f in ("valid", "task_ids", "n_classes", "label_mask", "class_counts", "labels"):
        np.testing.assert_array_equal(getattr(buf, f).numpy(), np.asarray(getattr(jbuf, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(buf.images.float().numpy(),
                                  np.asarray(jbuf.images).astype(np.float32))
    np.testing.assert_allclose(buf.importance.numpy(), np.asarray(jbuf.importance), rtol=1e-5)
    jlogits = np.asarray(jbuf.logits).astype(np.float32)
    np.testing.assert_allclose(buf.logits.float().numpy(), jlogits, rtol=2 ** -7,
                               atol=1e-5 * np.abs(jlogits).max())


def test_sdr_end_task_keeps_class_prototypes(injected):
    """SDR's ``end_task`` after its task-1 step: the class prototypes and
    counts of the step (held to JAX's by ``test_step_matches_jax``) stay
    as they are, the previous model becomes a frozen copy of the trained
    one, as JAX's ``end_task`` copies the parameters."""
    got = port_step("sdr")
    state, method, ctx = got["state"], got["method"], got["ctx"]
    before = state.class_prototypes.clone(), state.class_proto_counts.clone()
    state = method.end_task(state, ctx, [])
    assert torch.equal(state.class_prototypes, before[0])
    assert torch.equal(state.class_proto_counts, before[1])
    ref = jax_step("sdr")["updates"]
    np.testing.assert_allclose(state.class_prototypes.numpy(), ref["class_prototypes"],
                               rtol=1e-5, atol=1e-5 * np.abs(ref["class_prototypes"]).max())
    assert not state.prev_model.training
    for (k, p), q in zip(state.model.named_parameters(), state.prev_model.parameters()):
        assert torch.equal(p, q) and not q.requires_grad, k


@pytest.mark.parametrize("name", ["er", "sdr", "icarl", "plop_bgw"])
def test_eval_step_at_task_1_matches_jax(name, injected):
    """The task-1 eval step: the confusion matrix (K2's plain version)
    equal, every valid pixel counted, and the loss rtol 1e-5: ER's CE (K1),
    SDR's unbiased CE (K6), iCaRL's CE of the full-resolution logits and
    PLOP with ``bg_weighted_ce``'s CE over the valid pixels."""
    target, kw, task_id, detector = CASES[name]
    batch = inputs()["batch"]
    tx = jax_optim.make_optimizer(OPT_CFG, jax_optim.poly_schedule(0.01, MAX_ITERS))
    jctx = JaxModelContext(model=jax_model(detector), task=JaxTaskInfo(task_id=1, **TASK),
                           axis_name=None)
    _, jeval, _ = jax_make_steps(jctx, jax_create_method(target, **kw), tx, N_CLASSES,
                                 mesh=None)
    ref_cm, ref_loss = jeval(jax_state(name, tx), jnp.zeros((N_CLASSES, N_CLASSES), jnp.int32),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    ctx = ModelContext(TaskInfo(task_id=1, **TASK))
    _, eval_step, put_batch = make_steps(ctx, create_method(target, **kw), N_CLASSES,
                                         device="cpu")
    cm, loss = eval_step(port_state(name), torch.zeros((N_CLASSES,) * 2, dtype=torch.int32),
                         put_batch(batch))
    np.testing.assert_array_equal(cm.numpy(), np.asarray(ref_cm))
    assert int(cm.sum()) == int((batch["label"] != 255).sum())
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)


def test_registry_builds_every_jax_name():
    """``create_method`` builds each method under every JAX registry name."""
    from bacs_tpu.methods import _METHODS as JAX_METHODS
    from bacs_tpu_torch.methods import _METHODS

    assert _METHODS.keys() == JAX_METHODS.keys()
    for key, cls in JAX_METHODS.items():
        assert type(create_method(key)).__name__ == cls.__name__, key
    for name in ("loss.ExperienceReplay", "loss.SDR", "loss.IcarlLoss", "loss.Prototypes",
                 "Icarl_Loss", "experience_replay"):
        create_method(name)
