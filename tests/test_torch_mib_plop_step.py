"""The MiB and PLOP slice as a whole against the JAX package, on the CPU.

DeepLabV3-ResNet-18 at 64^2, batch 4, VOC-21 split 16+1 (task 1: 17
current classes, 16 old), f32, every ABN with the identity activation so
that the two packages agree to f32 rounding (``tests/test_torch_train_step.py``
explains why the leaky kink does not).  The current and the previous model
share their convolutions and differ in every ABN vector, so the
distillation terms are not ties.  At the task boundary both sides run the
MiB imprinting of the new class (``multihead_init``); then one task-1 train
step of each method, the JAX side ``_train_step_impl``
(``bacs_tpu/train/step.py``) written out to return the gradients, the port
side ``make_steps``.

PLOP's pseudo-labels compare an entropy with a threshold, so a pixel within
rounding of its threshold could take another branch in the two packages.
The step injects the same thresholds on both sides, each class's set in the
widest gap of its pixels' entropies, and asserts that no pixel lies within
1e-5 of its threshold (nor has two top logits within 1e-5).  Likewise
``begin_task``'s histogram bins by truncation: its labels mark as
background only pixels whose entropy lies more than 1e-5 from a bin edge.
"""

import functools
import math

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import bacs_tpu.models.deeplab as jax_deeplab
from bacs_tpu.methods import create_method as jax_create_method
from bacs_tpu.methods.base import ModelContext as JaxModelContext
from bacs_tpu.models.norm import ABN as JaxABN
from bacs_tpu.ops.losses import pixel_entropy as jax_pixel_entropy
from bacs_tpu.train import learner as jax_learner
from bacs_tpu.train import optim as jax_optim
from bacs_tpu.train.state import TaskInfo as JaxTaskInfo
from bacs_tpu.train.state import TrainState as JaxTrainState
from bacs_tpu.train.step import make_steps as jax_make_steps
from bacs_tpu_torch.ops import rng
from bacs_tpu_torch.methods import ModelContext, create_method
from bacs_tpu_torch.models.deeplab import DeepLabV3
from bacs_tpu_torch.models.norm import ABN
from bacs_tpu_torch.ops.losses import pixel_entropy
from bacs_tpu_torch.ops.upsample_ce import upsample_plain
from bacs_tpu_torch.train import learner, optim
from bacs_tpu_torch.train.state import TaskInfo, TrainState, frozen_copy
from bacs_tpu_torch.train.step import make_steps
from bacs_tpu_torch.utils.flax_weights import load_flax_variables, state_dict_to_flax
from torch_port_helpers import _one_thread, randomize_abn  # noqa: F401

CROP, BATCH, N_CLASSES, N_TASKS, OLD = 64, 4, 21, 6, 16
TASK = dict(initial_classes=16, increment=1, num_classes=N_CLASSES, n_tasks=N_TASKS,
            max_epochs=30)
OPT_CFG = {"_target_": "torch.optim.SGD", "lr": 0.01, "momentum": 0.9,
           "nesterov": True, "weight_decay": 1e-4}
MAX_ITERS = 10
MAX_ENTROPY = math.log(OLD + 1)
METHODS = ["loss.MiB", "loss.PlopLoss"]


def jax_model():
    return jax_deeplab.DeepLabV3(num_classes=N_CLASSES, backbone_name="resnet18",
                                 n_tasks=N_TASKS,
                                 norm=functools.partial(JaxABN, activation="identity"))


def port_model(variables):
    model = DeepLabV3(N_CLASSES, backbone_name="resnet18", n_tasks=N_TASKS,
                      norm=functools.partial(ABN, activation="identity"))
    load_flax_variables(model, *variables)
    return model


@functools.lru_cache(maxsize=None)
def flax_variables():
    """(current, previous) Flax (params, batch_stats): the same convolutions,
    every ABN vector drawn anew for each."""
    x = np.zeros((1, CROP, CROP, 3), np.float32)
    v = jax.jit(lambda k, x: jax_model().init(k, x, train=False))(jax.random.PRNGKey(0), x)
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


def teacher_entropy(logits):
    """(normalised entropy / log C_cur, argmax, top-2 gap) of the previous
    model's logits [N, H, W, 16], in f64."""
    up = logits.double()
    p = torch.softmax(up, dim=-1)
    top2 = up.topk(2, dim=-1).values
    return (pixel_entropy(p) / MAX_ENTROPY).numpy(), up.argmax(-1).numpy(), (
        top2[..., 0] - top2[..., 1]).numpy()


@functools.lru_cache(maxsize=None)
def inputs():
    """The task-1 batch, PLOP's injected thresholds and two begin_task
    batches, all from seeded numpy, the thresholds and the begin_task
    labels fitted to the previous model's entropies as the module's
    docstring says."""
    rs = np.random.RandomState(5)
    batch = {"image": rs.randn(BATCH, CROP, CROP, 3).astype(np.float32),
             "label": labels_of(rs, BATCH, OLD + 1)}
    prev = port_model(flax_variables()[1]).eval()
    with torch.no_grad():
        sem = prev(torch.from_numpy(batch["image"])).sem_logits[..., :OLD]
    ent, pred, gap = teacher_entropy(upsample_plain(sem, (CROP, CROP)))
    bg = batch["label"] < OLD
    thresholds = np.zeros(N_CLASSES, np.float32)
    for c in range(OLD):
        vals = np.unique(ent[bg & (pred == c)])  # sorted
        gaps = np.diff(vals)
        if len(gaps) and gaps.max() > 1e-4:  # in the widest gap
            i = int(np.argmax(gaps))
            thresholds[c] = (vals[i] + vals[i + 1]) / 2
        else:  # above them all (or a class never predicted)
            thresholds[c] = (vals[-1] if len(vals) else 0.0) + 1e-3
    assert np.abs(ent - thresholds[pred])[bg].min() > 1e-5
    assert gap[bg].min() > 1e-5

    begin = []
    for _ in range(2):
        image = rs.randn(BATCH, CROP, CROP, 3).astype(np.float32)
        with torch.no_grad():
            logits = prev(torch.from_numpy(image)).logits[..., :OLD]
        vals = teacher_entropy(logits)[0] * 100
        far = np.abs(vals - np.round(vals)) > 1e-3  # 1e-5 of the entropy
        label = rs.randint(1, OLD + 1, (BATCH, CROP, CROP)).astype(np.int32)
        label[far & (rs.rand(*label.shape) < 0.5)] = 0
        begin.append({"image": image, "label": label})
    return batch, thresholds, begin


def jax_state(method, tx):
    (params, stats), (prev_params, prev_stats) = flax_variables()
    p = jax.tree.map(jnp.asarray, params)
    _, thresholds, _ = inputs()
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=p, batch_stats=jax.tree.map(jnp.asarray, stats),
        opt_state=tx.init(p), rng=jax.random.PRNGKey(2),
        prototypes=jnp.zeros((N_TASKS, 1)), proto_counts=jnp.zeros((N_TASKS,)),
        prev_params=jax.tree.map(jnp.asarray, prev_params),
        prev_batch_stats=jax.tree.map(jnp.asarray, prev_stats))
    if method == "loss.PlopLoss":
        state = state.replace(plop_thresholds=jnp.asarray(thresholds),
                              plop_max_entropy=jnp.float32(MAX_ENTROPY))
    return jax_learner.multihead_init(state, JaxTaskInfo(task_id=1, **TASK))


def port_state(method):
    cur, prev = flax_variables()
    _, thresholds, _ = inputs()
    model = port_model(cur)
    opt, sched = optim.make_optimizer(OPT_CFG, model.parameters(),
                                      optim.poly_schedule(0.01, MAX_ITERS))
    state = TrainState(model, opt, sched, key=rng.key(0),
                       prev_model=frozen_copy(port_model(prev)))
    if method == "loss.PlopLoss":
        state.plop_thresholds = torch.from_numpy(thresholds.copy())
        state.plop_max_entropy = torch.tensor(MAX_ENTROPY, dtype=torch.float32)
    return learner.multihead_init(state, TaskInfo(task_id=1, **TASK))


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


@functools.lru_cache(maxsize=None)
def jax_step(method_name):
    batch, *_ = inputs()
    tx = jax_optim.make_optimizer(OPT_CFG, jax_optim.poly_schedule(0.01, MAX_ITERS))
    state = jax_state(method_name, tx)
    ctx = JaxModelContext(model=jax_model(), task=JaxTaskInfo(task_id=1, **TASK),
                          axis_name=None)
    method = jax_create_method(method_name)
    rng = jax.random.PRNGKey(9)

    @jax.jit
    def step(state, data):
        def loss_fn(p):
            return method.compute_loss(ctx, p, state, data, True, rng)

        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        updates, _ = tx.update(grads, state.opt_state, state.params)
        return loss, grads, optax.apply_updates(state.params, updates), aux.batch_stats

    loss, grads, params, stats = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(loss=float(loss), grads=dict(flat(grads)), params=dict(flat(params)),
                stats=dict(flat(stats)), p0=dict(flat(state.params)))


@functools.lru_cache(maxsize=None)
def port_step(method_name):
    batch, *_ = inputs()
    ctx = ModelContext(TaskInfo(task_id=1, **TASK))
    method = create_method(method_name)
    train_step, _, put_batch = make_steps(ctx, method, N_CLASSES, device="cpu")
    state = port_state(method_name)
    state, metrics = train_step(state, put_batch(batch))
    grads = {k: p.grad for k, p in state.model.named_parameters()}
    params, stats = state_dict_to_flax(state.model.state_dict())
    return dict(loss=float(metrics["loss"]), grads=dict(flat(state_dict_to_flax(grads)[0])),
                params=dict(flat(params)), stats=dict(flat(stats)), step=state.step)


@pytest.mark.parametrize("method", METHODS, ids=["mib", "plop"])
def test_task1_step_matches_jax(method):
    """One task-1 step after the imprinting: loss rtol 1e-5; every gradient
    tensor and every SGD update within 1e-4 of the tensor's largest value
    (each ABN's scale and bias joined; an update beyond one ulp of its
    parameter); the running statistics rtol 1e-5."""
    ref, got = jax_step(method), port_step(method)
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    gj, rj = joined(got["grads"]), joined(ref["grads"])
    assert gj.keys() == rj.keys()
    for k, r in rj.items():
        np.testing.assert_allclose(gj[k], r, rtol=0, atol=1e-4 * np.abs(r).max(), err_msg=k)
    p0 = ref["p0"]
    for k, r in ref["params"].items():
        upd = np.abs(r - p0[k]).max()
        assert upd > 0, k
        ulp = np.finfo(np.float32).eps * np.abs(p0[k]).max()
        np.testing.assert_allclose(got["params"][k], r, rtol=0, atol=1e-4 * upd + ulp,
                                   err_msg=k)
    assert got["stats"].keys() == ref["stats"].keys()
    for k, r in ref["stats"].items():
        np.testing.assert_allclose(got["stats"][k], r, rtol=1e-5, atol=1e-5 * np.abs(r).max(),
                                   err_msg=k)
    assert got["step"] == 1


def test_plop_begin_task_matches_jax():
    """PLOP's ``begin_task`` of task 1 over two batches, from the previous
    model: the port's int64 histogram equal to the one JAX's ``hist_batch``
    builds (``bacs_tpu/methods/plop.py:59-73``, written out here on the JAX
    forward), every background pixel counted, and the thresholds of
    JAX ``begin_task`` to 1e-6; the entropy normaliser log 17."""
    (params, stats), (prev_params, prev_stats) = flax_variables()
    _, _, begin = inputs()
    tx = jax_optim.make_optimizer(OPT_CFG, jax_optim.poly_schedule(0.01, MAX_ITERS))
    jstate = jax_state("loss.MiB", tx)
    jctx = JaxModelContext(model=jax_model(), task=JaxTaskInfo(task_id=1, **TASK),
                           axis_name=None)
    jdata = [{k: jnp.asarray(v) for k, v in b.items()} for b in begin]
    ref = jax_create_method("loss.PlopLoss").begin_task(jstate, jctx, jdata)
    ref_hist = np.zeros((OLD + 1, 100), np.int64)
    fwd = jax.jit(lambda s, x: jctx.forward_prev(s, x).logits[..., :OLD])
    for b in begin:
        probs = jax.nn.softmax(fwd(jstate, jnp.asarray(b["image"])), axis=-1)
        vals = np.asarray(jax_pixel_entropy(probs) / MAX_ENTROPY)
        bins = np.clip((vals * 100).astype(np.int32), 0, 99)
        idx = np.asarray(jnp.argmax(probs, axis=-1)) * 100 + bins
        np.add.at(ref_hist.reshape(-1), idx[b["label"] == 0], 1)

    method = create_method("loss.PlopLoss")
    ctx = ModelContext(TaskInfo(task_id=1, **TASK))
    state = port_state("loss.PlopLoss")
    state.plop_thresholds = state.plop_max_entropy = None
    data = [{k: torch.from_numpy(v) for k, v in b.items()} for b in begin]
    hist = method.entropy_histogram(state, ctx, data)
    assert hist.dtype == torch.int64
    np.testing.assert_array_equal(hist.numpy(), ref_hist)
    assert int(hist.sum()) == sum(int((b["label"] == 0).sum()) for b in begin)
    state = method.begin_task(state, ctx, data)
    np.testing.assert_allclose(state.plop_thresholds.numpy(), np.asarray(ref.plop_thresholds),
                               rtol=0, atol=1e-6)
    assert float(state.plop_max_entropy) == float(np.float32(MAX_ENTROPY))
    assert float(ref.plop_max_entropy) == float(np.float32(MAX_ENTROPY))
    # task 0 has no previous model: nothing to do
    ctx0 = ModelContext(TaskInfo(task_id=0, **TASK))
    assert method.begin_task(port_state("loss.MiB"), ctx0, data).plop_thresholds is None


@pytest.mark.parametrize("method", METHODS, ids=["mib", "plop"])
def test_eval_step_at_task_1_matches_jax(method, monkeypatch):
    """The task-1 eval step takes the CE branch (the sum over N H W, K1's
    plain version) and the confusion matrix (K2's) as JAX ``make_steps``;
    ``make_steps`` defaults to the card and raises without one."""
    batch, *_ = inputs()
    tx = jax_optim.make_optimizer(OPT_CFG, jax_optim.poly_schedule(0.01, MAX_ITERS))
    jctx = JaxModelContext(model=jax_model(), task=JaxTaskInfo(task_id=1, **TASK),
                           axis_name=None)
    _, jeval, _ = jax_make_steps(jctx, jax_create_method(method), tx, N_CLASSES, mesh=None)
    ref_cm, ref_loss = jeval(jax_state(method, tx),
                             jnp.zeros((N_CLASSES, N_CLASSES), jnp.int32),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    ctx = ModelContext(TaskInfo(task_id=1, **TASK))
    _, eval_step, put_batch = make_steps(ctx, create_method(method), N_CLASSES, device="cpu")
    cm, loss = eval_step(port_state(method), torch.zeros((N_CLASSES,) * 2, dtype=torch.int32),
                         put_batch(batch))
    np.testing.assert_array_equal(cm.numpy(), np.asarray(ref_cm))
    assert int(cm.sum()) == int((batch["label"] != 255).sum())
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_steps(ctx, create_method(method), N_CLASSES)


def test_bg_weighted_ce_raises():
    """``bg_weighted_ce`` builds under every name (its steps are held to JAX
    by ``tests/test_torch_more_methods_step.py``); a training step with it
    on a network without the seen detector raises, naming the config key."""
    batch, *_ = inputs()
    data = {k: torch.from_numpy(v) for k, v in batch.items()}
    ctx = ModelContext(TaskInfo(task_id=1, **TASK))
    for name in ("loss.MiB", "loss.PlopLoss", "plop", "mib"):
        method = create_method(name, bg_weighted_ce=True)
        assert method.bg_weighted_ce
        with pytest.raises(ValueError, match="training.bg_detector"):
            method.compute_loss(ctx, port_state("loss.MiB"), data, True)
    assert type(create_method("loss.MiB")).__name__ == "MiBMethod"
    assert type(create_method("ploploss")).__name__ == "PlopMethod"


@pytest.mark.parametrize("method", METHODS, ids=["mib", "plop"])
def test_composed_path_matches_the_kernel_path(method):
    """With ``fused_ce=False`` both methods run their losses composed on the
    full-resolution logits (PLOP's pseudo-labels through ``pseudo_labels``)
    and give the kernel path's loss (its plain versions here), rtol 1e-5."""
    batch, *_ = inputs()
    data = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses = []
    for fused in (True, False):
        ctx = ModelContext(TaskInfo(task_id=1, **TASK), fused_ce=fused)
        state = port_state(method)
        with torch.no_grad():
            loss, _ = create_method(method).compute_loss(ctx, state, data, True)
        losses.append(float(loss))
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
