"""The BACS slice as a whole against the JAX package, on the CPU.

DeepLabV3-ResNet-18 with the background detector at 64^2, VOC-21 split 16+1
(task 1: 17 current classes, 16 old), the ``bacs_plus_bg.yaml`` method
(weighted CE, alpha 0.8, beta 0.5) with replay batches of 4 from an 8-slot
buffer, batch 4, f32, from the same Flax variables.  Every ABN has the
identity activation, so the network is smooth and the two packages agree
to f32 rounding (``tests/test_torch_train_step.py`` explains why the leaky
kink does not); the detector keeps its ReLU.

Replay batches of 4, not 2: the ASPP's global-pooling ABN normalises over
the batch alone, ill-conditioned over two images (the same file explains
it).  The random draws are injected identically on both sides with
monkeypatch (the pattern of ``tests/test_method_parity.py:528-600``): the
two buffer samples take fixed Gumbel keys, the replay crop and flip take
fixed parameters, the detector's dropout has rate 0, and the autocontrast
does not apply: its stretched [0, 1] images have a mean far above their
spread, so the stem's batch variance E[x^2] - E[x]^2 cancels and both
packages' rounding grows to ~3e-4 of the gradients
(``test_torch_bacs_ops.py`` holds the stretch itself to JAX).  The JAX side is ``_train_step_impl`` (``bacs_tpu/train/step.py``)
written out to return the gradients too; the port side is ``make_steps``.
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
import bacs_tpu.models.deeplab as jax_deeplab
from bacs_tpu.methods import create_method as jax_create_method
from bacs_tpu.methods.base import ModelContext as JaxModelContext
from bacs_tpu.models.norm import ABN as JaxABN
from bacs_tpu.train import buffer as jax_buffer
from bacs_tpu.train import optim as jax_optim
from bacs_tpu.train.state import TaskInfo as JaxTaskInfo
from bacs_tpu.train.state import TrainState as JaxTrainState
import bacs_tpu_torch.methods.bacs as port_bacs
from bacs_tpu_torch.data.transforms import apply_crop_params
from bacs_tpu_torch.methods import ModelContext, create_method
from bacs_tpu_torch.methods.base import proto_updates
from bacs_tpu_torch.models.deeplab import DeepLabV3
from bacs_tpu_torch.models.norm import ABN
from bacs_tpu_torch.train import buffer as port_buffer
from bacs_tpu_torch.train import optim
from bacs_tpu_torch.train.state import TaskInfo, TrainState, frozen_copy
from bacs_tpu_torch.train.step import make_steps
from bacs_tpu_torch.utils.flax_weights import load_flax_variables, state_dict_to_flax
from torch_port_helpers import randomize_abn

CROP, BATCH, REPLAY, SLOTS, N_CLASSES, N_TASKS, D = 64, 4, 4, 8, 21, 6, 128
TASK = dict(initial_classes=16, increment=1, num_classes=N_CLASSES, n_tasks=N_TASKS,
            max_epochs=30)
METHOD = dict(use_bg_detector=True, bg_weighted_ce=True, alpha=0.8, beta=0.5,
              buffer_size=SLOTS, replay_minibatch_size=REPLAY)
OPT_CFG = {"_target_": "torch.optim.SGD", "lr": 0.01, "momentum": 0.9,
           "nesterov": True, "weight_decay": 1e-4}
MAX_ITERS = 10


def jax_model():
    return jax_deeplab.DeepLabV3(
        num_classes=N_CLASSES, backbone_name="resnet18", n_tasks=N_TASKS,
        use_bg_detector=True, norm=functools.partial(JaxABN, activation="identity"))


def port_model():
    model = DeepLabV3(N_CLASSES, backbone_name="resnet18", n_tasks=N_TASKS,
                      use_bg_detector=True,
                      norm=functools.partial(ABN, activation="identity"))
    model.seen_fg_network.dropout_rate = 0.0
    params, stats = flax_variables()
    load_flax_variables(model, params, stats)
    return model


@functools.lru_cache(maxsize=None)
def flax_variables():
    x = np.zeros((1, CROP, CROP, 3), np.float32)
    v = jax.jit(lambda k, x: jax_model().init(k, x, train=False))(jax.random.PRNGKey(0), x)
    rs = np.random.RandomState(11)
    return randomize_abn(v["params"], rs), randomize_abn(v["batch_stats"], rs)


def labels_of(rs, n, n_classes):
    """Labels in [0, n_classes), ~40 % background, ~5 % ignored."""
    lab = rs.randint(0, n_classes, (n, CROP, CROP)).astype(np.int32)
    lab[rs.rand(*lab.shape) < 0.4] = 0
    lab[rs.rand(*lab.shape) < 0.05] = 255
    return lab


@functools.lru_cache(maxsize=None)
def inputs():
    """Seeded numpy inputs: the task-1 batch, task-0 batches, the buffer's
    items and uniforms, prototypes, the Gumbel keys and crop parameters."""
    rs = np.random.RandomState(5)
    batch = {"image": rs.randn(BATCH, CROP, CROP, 3).astype(np.float32),
             "label": labels_of(rs, BATCH, 17)}
    task0 = [{"image": rs.randn(BATCH, CROP, CROP, 3).astype(np.float32),
              "label": labels_of(rs, BATCH, 16)} for _ in range(3)]
    items = dict(images=rs.randn(10, CROP, CROP, 3).astype(np.float32),
                 logits=rs.randn(10, 4, 4, N_CLASSES).astype(np.float32),
                 labels=labels_of(rs, 10, 16),
                 losses=-rs.rand(10).astype(np.float32),
                 uniforms=(rs.rand(10).astype(np.float32),
                           rs.rand(10).astype(np.float32)))
    protos = rs.randn(N_TASKS, D).astype(np.float32)
    counts = np.zeros(N_TASKS, np.float32)
    counts[0] = 50.0
    keys = [np.asarray(jax.random.gumbel(jax.random.PRNGKey(k), (SLOTS,)))
            for k in (21, 22)]
    crop = dict(i=np.float32([3.5, 0.0, 20.25, 0.0]), j=np.float32([0.0, 7.25, 1.0, 0.0]),
                ch=np.float32([40.0, 64.0, 30.5, 64.0]),
                cw=np.float32([52.5, 33.0, 60.0, 64.0]),
                flip=np.array([True, False, False, True]))
    return batch, task0, items, protos, counts, keys, crop


def jax_buffer_filled():
    _, _, it, *_ = inputs()
    buf = jax_buffer.init_buffer(SLOTS, (CROP, CROP), (4, 4), N_CLASSES)
    return jax_buffer.add_batch(
        buf, None, jnp.asarray(it["images"]), jnp.asarray(it["logits"]),
        jnp.asarray(it["labels"]), jnp.asarray(it["losses"]), task_id=0, n_classes=16,
        uniforms=tuple(jnp.asarray(u) for u in it["uniforms"]))


def port_buffer_from(jbuf):
    """The JAX buffer's arrays as a port ``BufferState`` (bf16 storage)."""
    t = lambda a: torch.from_numpy(np.asarray(a).astype(np.float32))  # noqa: E731
    return port_buffer.BufferState(
        images=t(jbuf.images).to(torch.bfloat16), logits=t(jbuf.logits).to(torch.bfloat16),
        labels=torch.from_numpy(np.asarray(jbuf.labels)),
        importance=t(jbuf.importance), label_mask=torch.from_numpy(np.asarray(jbuf.label_mask)),
        task_ids=torch.from_numpy(np.asarray(jbuf.task_ids)),
        n_classes=torch.from_numpy(np.asarray(jbuf.n_classes)),
        valid=torch.from_numpy(np.asarray(jbuf.valid)),
        class_counts=torch.from_numpy(np.asarray(jbuf.class_counts)),
        num_seen=int(jbuf.num_seen))


@pytest.fixture
def injected(monkeypatch):
    """The replay draws of both packages, made identical."""
    *_, keys, crop = inputs()
    # JAX: the two samples (alpha first, then beta) take fixed keys; the
    # autocontrast does not apply (p = 0); the crop and flip are fixed; no
    # dropout
    jkeys = itertools.cycle([jax.random.PRNGKey(21), jax.random.PRNGKey(22)])
    sample = jax_buffer.sample
    monkeypatch.setattr(jax_bacs.buffer_lib, "sample",
                        lambda buf, rng, n, task_id=None: sample(buf, next(jkeys), n))
    autocontrast = jax_bacs.random_autocontrast
    monkeypatch.setattr(jax_bacs, "random_autocontrast",
                        lambda rng, x, p=0.5: autocontrast(rng, x, 0.0))

    def jax_augment(rng, images, labels):
        one = lambda im, lb, i, j, ch, cw, f: (  # noqa: E731
            jnp.where(f, jax_transforms._resize_region(im, i, j, ch, cw, CROP, "bilinear")[:, ::-1],
                      jax_transforms._resize_region(im, i, j, ch, cw, CROP, "bilinear")),
            jnp.where(f, jax_transforms._resize_region(lb, i, j, ch, cw, CROP, "nearest")[:, ::-1],
                      jax_transforms._resize_region(lb, i, j, ch, cw, CROP, "nearest")))
        return jax.vmap(one)(images, labels, *(jnp.asarray(crop[k]) for k in
                                               ("i", "j", "ch", "cw", "flip")))

    monkeypatch.setattr(jax_transforms, "replay_augment", jax_augment)
    monkeypatch.setattr(jax_deeplab, "BgDetector",
                        functools.partial(jax_deeplab.BgDetector, dropout_rate=0.0))
    # the port: the same keys, autocontrast and crop parameters
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


def flat(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float32)


def jax_task1_state(tx, params, stats):
    _, _, _, protos, counts, _, _ = inputs()
    p = jax.tree.map(jnp.asarray, params)
    bs = jax.tree.map(jnp.asarray, stats)
    return JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=p, batch_stats=bs, opt_state=tx.init(p),
        rng=jax.random.PRNGKey(2), prototypes=jnp.asarray(protos),
        proto_counts=jnp.asarray(counts), prev_params=p, prev_batch_stats=bs,
        buffer=jax_buffer_filled())


def port_task1_state():
    _, _, _, protos, counts, _, _ = inputs()
    model = port_model()
    opt, sched = optim.make_optimizer(OPT_CFG, model.parameters(),
                                      optim.poly_schedule(0.01, MAX_ITERS))
    return TrainState(model, opt, sched, generator=torch.Generator().manual_seed(0),
                      prototypes=torch.from_numpy(protos.copy()),
                      proto_counts=torch.from_numpy(counts.copy()),
                      prev_model=frozen_copy(model),
                      buffer=port_buffer_from(jax_buffer_filled()))


def jax_step_and_terms():
    """One task-1 step (``_train_step_impl`` with the gradients returned)
    and, on the initial state, each term of the loss."""
    params, stats = flax_variables()
    batch, *_ = inputs()
    tx = jax_optim.make_optimizer(OPT_CFG, jax_optim.poly_schedule(0.01, MAX_ITERS))
    state = jax_task1_state(tx, params, stats)
    ctx = JaxModelContext(model=jax_model(), task=JaxTaskInfo(task_id=1, **TASK),
                          axis_name=None)
    method = jax_create_method("loss.BACSLoss", **METHOD)
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

    @jax.jit
    def terms(state, data):
        p, image, mask = state.params, data["image"], data["label"]
        main, out, old_out, bs, seen = method.compute_base_loss(
            ctx, p, state, image, mask, True, rng, use_weighted_ce=True,
            need_old_out=True)
        distill = method._teacher_distill(old_out.attentions[-1], out.attentions[-1],
                                          seen, mask)
        updates = method.prototype_updates(ctx, state, out.penultimate, mask, True)
        alpha, bs, _ = method._dark_logits(ctx, p, state, bs, rng)
        beta, _, updates = method._dark_pp(ctx, p, state, bs, rng, updates)
        return main, distill, alpha, beta, updates

    loss, grads, new_params, new_stats, upd = step(state, data)
    t = terms(state, data)
    return dict(
        loss=float(loss), grads=dict(flat(grads)), params=dict(flat(new_params)),
        stats=dict(flat(new_stats)), protos=np.asarray(upd["prototypes"]),
        counts=np.asarray(upd["proto_counts"]),
        terms=[float(v) for v in t[:4]], term_protos=np.asarray(t[4]["prototypes"]))


def port_step_and_terms():
    batch, *_ = inputs()
    ctx = ModelContext(TaskInfo(task_id=1, **TASK))
    method = create_method("loss.BACSLoss", **METHOD)
    train_step, _, put_batch = make_steps(ctx, method, N_CLASSES, device="cpu")
    data = put_batch(batch)
    state = port_task1_state()
    state, metrics = train_step(state, data)
    grads = {k: p.grad for k, p in state.model.named_parameters()}
    params, stats = state_dict_to_flax(state.model.state_dict())

    s = port_task1_state()
    base = method.compute_base_loss(ctx, s, data["image"], data["label"], True,
                                    use_weighted_ce=True, need_old_out=True)
    distill = method._teacher_distill(base.old_out.attentions[-1],
                                      base.out.attentions[-1], base.seen_prob,
                                      data["label"])
    alpha = method._dark_logits(ctx, s, None)
    beta, upd = method._dark_pp(ctx, s, None, proto_updates(base))
    return dict(
        loss=float(metrics["loss"]), grads=dict(flat(state_dict_to_flax(grads)[0])),
        params=dict(flat(params)), stats=dict(flat(stats)),
        protos=state.prototypes.numpy(), counts=state.proto_counts.numpy(),
        terms=[float(v.detach()) for v in (base.loss, distill, alpha, beta)],
        term_protos=upd["prototypes"].numpy(), state=state)


def joined(d):
    """Each ABN's (and the trunk norm's) scale and bias joined: with
    identity activations a norm whose output reaches the loss only through
    1 x 1 convolutions into the next one has a bias gradient of exactly 0,
    and both packages return rounding noise there (``chip_smoke.py``,
    ``abn_joined``)."""
    out = {}
    for k, v in d.items():
        stem, leaf = k.rsplit("/", 1)
        if leaf in ("scale", "bias") and f"{stem}/scale" in d:
            out[stem] = np.concatenate([d[f"{stem}/scale"], d[f"{stem}/bias"]])
        else:
            out[k] = v
    return out


@functools.lru_cache(maxsize=None)
def runs():
    return jax_step_and_terms(), port_step_and_terms()


def test_bacs_step_matches_jax(injected):
    """Loss rtol 1e-5; gradients (the zero ones of the detector trunk
    included) and the SGD update per tensor within 1e-4 of the tensor's
    largest value; running statistics after the three train forwards and
    the prototypes to 1e-5 (of their largest value); the feature counts
    equal."""
    ref, got = runs()
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    gj, rj = joined(got["grads"]), joined(ref["grads"])
    assert gj.keys() == rj.keys()
    for k, r in rj.items():
        np.testing.assert_allclose(gj[k], r, rtol=0, atol=1e-4 * np.abs(r).max(),
                                   err_msg=k)
    trunk = [k for k in ref["grads"] if k.startswith("seen_fg_network/base_")]
    assert len(trunk) == 3
    for k in trunk:  # no gradient reaches the trunk at task 1
        assert not ref["grads"][k].any() and not got["grads"][k].any(), k
    p0 = dict(flat(flax_variables()[0]))
    for k, r in ref["params"].items():
        upd = np.abs(r - p0[k]).max()
        assert upd > 0, k  # every parameter moves, the trunk by decay alone
        ulp = np.finfo(np.float32).eps * np.abs(p0[k]).max()
        np.testing.assert_allclose(got["params"][k], r, rtol=0,
                                   atol=1e-4 * upd + ulp, err_msg=k)
    assert got["stats"].keys() == ref["stats"].keys()
    for k, r in ref["stats"].items():
        np.testing.assert_allclose(got["stats"][k], r, rtol=1e-5,
                                   atol=1e-5 * np.abs(r).max(), err_msg=k)
    np.testing.assert_allclose(got["counts"], ref["counts"], rtol=0, atol=0)
    # the features folded agree to ~1e-5 of their largest value
    np.testing.assert_allclose(got["protos"], ref["protos"], rtol=1e-5,
                               atol=1e-5 * np.abs(ref["protos"]).max())
    assert got["state"].step == 1


def test_bacs_loss_terms_match_jax(injected):
    """Each term on the initial state: the seen-weighted CE plus the
    detector's focal term (K3's plain version), the teacher distillation,
    the alpha dark-logits MSE and the beta class-weighted replay CE (K4's
    plain version), rtol 1e-5; and their weighted sum is the step's loss.
    The prototypes after both folds (main and beta batch) as the step's."""
    ref, got = runs()
    np.testing.assert_allclose(got["terms"], ref["terms"], rtol=1e-5)
    main, distill, alpha, beta = got["terms"]
    assert min(main, distill, alpha, beta) > 0
    np.testing.assert_allclose(main + distill + 0.8 * alpha + 0.5 * beta, got["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["term_protos"], ref["term_protos"], rtol=1e-5,
                               atol=1e-5 * np.abs(ref["term_protos"]).max())


def jax_uniforms(task_id, n_batches, n):
    """The reservoir's uniforms that JAX ``BACSMethod.end_task`` draws per
    batch (``bacs_tpu/methods/bacs.py:476-525``, ``buffer.py:166-169``)."""
    rng, out = jax.random.PRNGKey(4321 + task_id), []
    for _ in range(n_batches):
        rng, sub = jax.random.split(rng)
        k1, k2 = jax.random.split(jax.random.split(sub, 3)[2])
        out.append((torch.from_numpy(np.array(jax.random.uniform(k1, (n,)))),
                    torch.from_numpy(np.array(jax.random.uniform(k2, (n,))))))
    return out


def test_end_task_matches_jax(injected, monkeypatch):
    """``end_task`` of task 0 over 3 batches of 4 into 8 slots: the prototype
    sweep (eval mode, every count 0 before), the previous-model snapshot
    (the statistics before the fill), and the fill in train mode with the
    uniforms JAX draws, the backbone's statistics drifting twice and the
    others once.  Buffer decisions bit-identical; images and labels equal;
    importances rtol 1e-5; stored bf16 logits within one bf16 rounding of
    values that agree to 1e-5 of the largest."""
    params, stats = flax_variables()
    _, task0, *_ = inputs()
    task = dict(task_id=0, **TASK)
    method_kw = dict(METHOD)

    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=jax.tree.map(jnp.asarray, params),
        batch_stats=jax.tree.map(jnp.asarray, stats), opt_state=None,
        rng=jax.random.PRNGKey(2), prototypes=jnp.zeros((N_TASKS, D)),
        proto_counts=jnp.zeros((N_TASKS,)),
        buffer=jax_buffer.init_buffer(SLOTS, (CROP, CROP), (4, 4), N_CLASSES))
    jctx = JaxModelContext(model=jax_model(), task=JaxTaskInfo(**task), axis_name=None)
    jdata = [{k: jnp.asarray(v) for k, v in b.items()} for b in task0]
    ref = jax_create_method("loss.BACSLoss", **method_kw).end_task(jstate, jctx, jdata)

    queue = iter(jax_uniforms(0, len(task0), BATCH))
    add = port_buffer.add_batch
    monkeypatch.setattr(port_bacs.buffer_lib, "add_batch",
                        lambda *a, **kw: add(*a, **{**kw, "uniforms": next(queue)}))
    method = create_method("loss.BACSLoss", **method_kw)
    model = port_model()
    opt, sched = optim.make_optimizer(OPT_CFG, model.parameters(),
                                      optim.poly_schedule(0.01, MAX_ITERS))
    state = TrainState(model, opt, sched, prototypes=torch.zeros(N_TASKS, D),
                       proto_counts=torch.zeros(N_TASKS),
                       buffer=method.init_buffer(TaskInfo(**task), (CROP, CROP), (4, 4),
                                                 device="cpu"))
    data = [{k: torch.from_numpy(v) for k, v in b.items()} for b in task0]
    state = method.end_task(state, ModelContext(TaskInfo(**task)), data)

    np.testing.assert_array_equal(state.proto_counts.numpy(), np.asarray(ref.proto_counts))
    np.testing.assert_allclose(state.prototypes.numpy(), np.asarray(ref.prototypes),
                               rtol=1e-5, atol=1e-5 * np.abs(np.asarray(ref.prototypes)).max())
    assert not any(p.requires_grad for p in state.prev_model.parameters())
    assert not state.prev_model.training
    for got_sd, ref_stats in ((state.prev_model.state_dict(), ref.prev_batch_stats),
                              (state.model.state_dict(), ref.batch_stats)):
        got = dict(flat(state_dict_to_flax(got_sd)[1]))
        for k, r in flat(ref_stats):
            np.testing.assert_allclose(got[k], r, rtol=1e-5, atol=1e-5 * np.abs(r).max(),
                                       err_msg=k)
    # the fill drifted the backbone twice, the rest once
    before, after = dict(flat(stats)), dict(flat(ref.batch_stats))
    assert all(not np.array_equal(before[k], after[k]) for k in before)

    buf, jbuf = state.buffer, ref.buffer
    assert buf.num_seen == int(jbuf.num_seen) == 3 * BATCH
    for f in ("valid", "task_ids", "n_classes", "label_mask", "class_counts", "labels"):
        np.testing.assert_array_equal(getattr(buf, f).numpy(), np.asarray(getattr(jbuf, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(buf.images.float().numpy(),
                                  np.asarray(jbuf.images).astype(np.float32))
    np.testing.assert_allclose(buf.importance.numpy(), np.asarray(jbuf.importance), rtol=1e-5)
    jlogits = np.asarray(jbuf.logits).astype(np.float32)
    np.testing.assert_allclose(buf.logits.float().numpy(), jlogits, rtol=2 ** -7,
                               atol=1e-5 * np.abs(jlogits).max())


def test_eval_step_at_task_1_matches_jax(injected, monkeypatch):
    """The eval step needs nothing new at task 1: the CE loss of the 17
    active classes (K1's plain version) and the confusion matrix (K2's)
    against JAX ``make_steps``; ``make_steps`` defaults to the card and
    raises without one."""
    from bacs_tpu.train.step import make_steps as jax_make_steps

    params, stats = flax_variables()
    batch, *_ = inputs()
    tx = jax_optim.make_optimizer(OPT_CFG, jax_optim.poly_schedule(0.01, MAX_ITERS))
    jctx = JaxModelContext(model=jax_model(), task=JaxTaskInfo(task_id=1, **TASK),
                           axis_name=None)
    _, jeval, _ = jax_make_steps(jctx, jax_create_method("loss.BACSLoss", **METHOD), tx,
                                 N_CLASSES, mesh=None)
    ref_cm, ref_loss = jeval(jax_task1_state(tx, params, stats),
                             jnp.zeros((N_CLASSES, N_CLASSES), jnp.int32),
                             {k: jnp.asarray(v) for k, v in batch.items()})

    ctx = ModelContext(TaskInfo(task_id=1, **TASK))
    method = create_method("loss.BACSLoss", **METHOD)
    _, eval_step, put_batch = make_steps(ctx, method, N_CLASSES, device="cpu")
    cm, loss = eval_step(port_task1_state(), torch.zeros((N_CLASSES,) * 2, dtype=torch.int32),
                         put_batch(batch))
    np.testing.assert_array_equal(cm.numpy(), np.asarray(ref_cm))
    assert int(cm.sum()) == int((batch["label"] != 255).sum())
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_steps(ctx, method, N_CLASSES)
