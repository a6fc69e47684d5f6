"""The training slice as a whole: the port's ``make_steps`` against the JAX
``make_steps(mesh=None)``, on the CPU.

DeepLabV3-ResNet-18 at 64^2, 5 classes, f32, from the same Flax variables
(initialised by the JAX package, ABN vectors redrawn by ``randomize_abn``),
the nesterov SGD of ``conf/bacs/optimizer/nesterov.yaml`` under a poly
schedule, and the same seeded numpy batches: two train steps, then one
eval step.  The JAX steps are run once per process (cached).

Batch 4, not 2: the ASPP's global-pooling ABN normalises over the batch
alone, and over two images it maps every channel to about +-1, where the
f32 rounding of E[x^2] - mean^2 is amplified into the head's output; from
four images on the head agrees as the backbone does.

Two networks:

- ``identity``: every ABN with the identity activation (leaky slope 1),
  so the network is smooth and the two packages agree to f32 rounding;
  this holds the step's arithmetic (ABN backward, running statistics,
  clip, weight decay, nesterov momentum, the schedule's second rate)
  tightly.
- ``leaky``: the configured ``iabn_sync`` (leaky-ReLU 0.01).  Its first
  loss and its eval step on the initial weights agree as tightly, but its
  gradients do not: where a pre-activation lies within f32 rounding of 0,
  the two packages take different sides of the leaky kink, and through
  the ABN backward's per-channel means such a pixel moves its whole
  channel's gradient.  With 4 x 4 head pixels per image a few such pixels
  move the gradients by a few percent, so the trained parameters are held
  to the update's scale (``update_error`` <= 0.25), not to rounding (the
  smooth network's bound is 1e-4).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bacs_tpu.methods import create_method as jax_create_method
from bacs_tpu.methods.base import ModelContext as JaxModelContext
from bacs_tpu.models import create_network as jax_create_network
from bacs_tpu.models.deeplab import DeepLabV3 as JaxDeepLabV3
from bacs_tpu.models.norm import ABN as JaxABN
from bacs_tpu.train import optim as jax_optim
from bacs_tpu.train.state import TaskInfo as JaxTaskInfo
from bacs_tpu.train.state import TrainState as JaxTrainState
from bacs_tpu.train.step import make_steps as jax_make_steps
from bacs_tpu_torch.methods import ModelContext, create_method
from bacs_tpu_torch.models import base as models_base
from bacs_tpu_torch.models import create_network
from bacs_tpu_torch.models.deeplab import DeepLabV3
from bacs_tpu_torch.models.norm import ABN
from bacs_tpu_torch.train import optim
from bacs_tpu_torch.train.state import TaskInfo, TrainState
from bacs_tpu_torch.train.step import make_steps
from bacs_tpu_torch.utils.flax_weights import load_flax_variables, state_dict_to_flax
from torch_port_helpers import randomize_abn

CROP, NUM_CLASSES, BATCH, STEPS = 64, 5, 4, 2
OPT_CFG = {"_target_": "torch.optim.SGD", "lr": 0.01, "momentum": 0.9,
           "nesterov": True, "weight_decay": 1e-4}
MAX_ITERS = 10
TASK = dict(task_id=0, initial_classes=NUM_CLASSES, increment=0,
            num_classes=NUM_CLASSES, n_tasks=1, max_epochs=1)


def jax_model(activation):
    if activation == "leaky":
        return jax_create_network("networks.DeepLabV3", num_classes=NUM_CLASSES,
                                  norm="iabn_sync", axis_name=None,
                                  backbone="resnet18")
    return JaxDeepLabV3(num_classes=NUM_CLASSES, backbone_name="resnet18",
                        norm=functools.partial(JaxABN, activation="identity"))


def port_model(activation):
    if activation == "leaky":
        return create_network("networks.DeepLabV3", NUM_CLASSES, backbone="resnet18")
    return DeepLabV3(NUM_CLASSES, backbone_name="resnet18",
                     norm=functools.partial(ABN, activation="identity"))


@functools.lru_cache(maxsize=None)
def flax_variables():
    """Randomised (params, batch_stats): the shapes do not depend on the
    activation, so one init serves both networks."""
    m = jax_model("leaky")
    x = np.zeros((1, CROP, CROP, 3), np.float32)
    v = jax.jit(lambda k, x: m.init(k, x, train=False))(jax.random.PRNGKey(0), x)
    rs = np.random.RandomState(7)
    return randomize_abn(v["params"], rs), randomize_abn(v["batch_stats"], rs)


def batches():
    """STEPS train batches and one eval batch; ~5 % of labels ignored."""
    rs = np.random.RandomState(3)
    out = []
    for _ in range(STEPS + 1):
        labels = rs.randint(0, NUM_CLASSES, (BATCH, CROP, CROP)).astype(np.int32)
        labels[rs.rand(*labels.shape) < 0.05] = 255
        out.append({"image": rs.randn(BATCH, CROP, CROP, 3).astype(np.float32),
                    "label": labels})
    return out


def flat(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float32)


@functools.lru_cache(maxsize=None)
def jax_run(activation):
    """JAX: eval on the initial weights, STEPS train steps, eval again."""
    params, stats = flax_variables()
    net = jax_model(activation)
    tx = jax_optim.make_optimizer(OPT_CFG, jax_optim.poly_schedule(0.01, MAX_ITERS))
    p = jax.tree.map(jnp.asarray, params)
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=p,
        batch_stats=jax.tree.map(jnp.asarray, stats), opt_state=tx.init(p),
        rng=jax.random.PRNGKey(2), prototypes=jnp.zeros((1, 512)),
        proto_counts=jnp.zeros((1,)),
    )
    ctx = JaxModelContext(model=net, task=JaxTaskInfo(**TASK), axis_name=None)
    train_step, eval_step, _ = jax_make_steps(
        ctx, jax_create_method("loss.CrossEntropy"), tx, NUM_CLASSES, mesh=None)
    data = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches()]
    zeros = lambda: jnp.zeros((NUM_CLASSES, NUM_CLASSES), jnp.int32)  # noqa: E731
    cm0, eval0 = eval_step(state, zeros(), data[-1])
    losses = []
    for b in data[:STEPS]:
        state, metrics = train_step(state, b)
        losses.append(float(metrics["loss"]))
    cm, eval_loss = eval_step(state, zeros(), data[-1])
    return dict(
        eval0=(np.asarray(cm0), float(eval0)), losses=losses,
        params=dict(flat(state.params)), stats=dict(flat(state.batch_stats)),
        eval=(np.asarray(cm), float(eval_loss)),
    )


def port_steps(activation, fused_ce=True):
    params, stats = flax_variables()
    model = port_model(activation)
    load_flax_variables(model, params, stats)
    opt, sched = optim.make_optimizer(OPT_CFG, model.parameters(),
                                      optim.poly_schedule(0.01, MAX_ITERS))
    ctx = ModelContext(TaskInfo(**TASK), fused_ce=fused_ce)
    steps = make_steps(ctx, create_method("loss.CrossEntropy"), NUM_CLASSES,
                       device="cpu")
    return TrainState(model, opt, sched), steps


def port_run(activation, fused_ce=True):
    state, (train_step, eval_step, put_batch) = port_steps(activation, fused_ce)
    data = [put_batch(b) for b in batches()]
    zeros = lambda: torch.zeros((NUM_CLASSES, NUM_CLASSES), dtype=torch.int32)  # noqa: E731
    cm0, eval0 = eval_step(state, zeros(), data[-1])
    losses = []
    for b in data[:STEPS]:
        state, metrics = train_step(state, b)
        losses.append(float(metrics["loss"]))
    cm, eval_loss = eval_step(state, zeros(), data[-1])
    params, stats = state_dict_to_flax(state.model.state_dict())
    return dict(
        eval0=(cm0.numpy(), float(eval0)), losses=losses,
        params=dict(flat(params)), stats=dict(flat(stats)),
        eval=(cm.numpy(), float(eval_loss)), state=state,
    )


def update_error(got, ref):
    """||update_port - update_jax|| / ||update_jax|| over all parameters."""
    p0 = dict(flat(flax_variables()[0]))
    assert got.keys() == ref.keys() == p0.keys()
    diff = sum(float(np.sum((got[k] - ref[k]) ** 2)) for k in p0)
    norm = sum(float(np.sum((ref[k] - p0[k]) ** 2)) for k in p0)
    return (diff / norm) ** 0.5


@pytest.mark.parametrize("activation", ["identity", "leaky"])
def test_train_steps_match_jax(activation):
    ref, got = jax_run(activation), port_run(activation)
    assert got["state"].step == got["state"].epoch_step == STEPS
    # before any update the two networks are the same function
    np.testing.assert_allclose(got["losses"][0], ref["losses"][0], rtol=1e-5)
    if activation == "identity":
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
        assert update_error(got["params"], ref["params"]) <= 1e-4
        for k, r in ref["params"].items():
            np.testing.assert_allclose(got["params"][k], r, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        stats_rtol = 1e-5
    else:
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-3)
        assert update_error(got["params"], ref["params"]) <= 0.25
        stats_rtol = 1e-2
    assert got["stats"].keys() == ref["stats"].keys()
    for k, r in ref["stats"].items():
        np.testing.assert_allclose(got["stats"][k], r, rtol=stats_rtol,
                                   atol=stats_rtol * np.abs(r).max(), err_msg=k)


@pytest.mark.parametrize("activation", ["identity", "leaky"])
def test_eval_step_matches_jax(activation):
    """Loss and confusion matrix: on the initial weights for both networks
    (rtol 1e-5, equal matrices), after two train steps for the smooth one."""
    ref, got = jax_run(activation), port_run(activation)
    np.testing.assert_array_equal(got["eval0"][0], ref["eval0"][0])
    np.testing.assert_allclose(got["eval0"][1], ref["eval0"][1], rtol=1e-5)
    assert int(got["eval0"][0].sum()) == int((batches()[-1]["label"] != 255).sum())
    if activation == "identity":
        np.testing.assert_array_equal(got["eval"][0], ref["eval"][0])
        np.testing.assert_allclose(got["eval"][1], ref["eval"][1], rtol=1e-5)


def test_composed_path_matches_the_kernel_path():
    """``fused_ce=False`` takes cross_entropy and argmax + confusion_matrix
    on the full-resolution logits: the same losses and matrices."""
    fused, composed = port_run("identity"), port_run("identity", fused_ce=False)
    np.testing.assert_allclose(composed["losses"], fused["losses"], rtol=1e-5)
    for key in ("eval0", "eval"):
        np.testing.assert_array_equal(composed[key][0], fused[key][0])
        np.testing.assert_allclose(composed[key][1], fused[key][1], rtol=1e-5)


def test_kernel_path_never_builds_full_res_logits(monkeypatch):
    def no_logits(*_):
        raise AssertionError("full-resolution logits were built")

    monkeypatch.setattr(models_base, "resize_bilinear", no_logits)
    state, (train_step, eval_step, put_batch) = port_steps("leaky")
    b = put_batch(batches()[0])
    state, metrics = train_step(state, b)
    assert state.model.training and np.isfinite(float(metrics["loss"]))
    cm, loss = eval_step(state, torch.zeros((NUM_CLASSES,) * 2, dtype=torch.int32), b)
    assert not state.model.training and int(cm.sum()) == int((b["label"] != 255).sum())


def test_put_batch_and_unported_options(monkeypatch):
    ctx = ModelContext(TaskInfo(**TASK))
    method = create_method("loss.CrossEntropy")
    _, _, put_batch = make_steps(ctx, method, NUM_CLASSES, device="cpu")
    b = put_batch({"image": np.zeros((1, 8, 8, 3), np.uint8),
                   "label": np.zeros((1, 8, 8), np.int32)})
    assert b["image"].dtype == torch.float32 and b["label"].dtype == torch.int32
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_steps(ctx, method, NUM_CLASSES, mesh=object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_steps(ctx, method, NUM_CLASSES)
