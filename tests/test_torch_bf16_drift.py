"""The bf16 eval-mode drift of a random network, the port against JAX, on
the CPU.

``chip_smoke.py`` phase [26] saw the eval-mode outputs of its random
RN101 leave the finite range within a few bf16 train steps.  Here the
same question at a CPU size: DeepLabV3-ResNet-18 at 64^2, 5 classes,
batch 4, from the same Flax variables (ABN vectors redrawn by
``randomize_abn``), nesterov SGD at lr 0.01 under the poly schedule,
convolutions in bf16 on f32 master weights in both packages
(``create_network(dtype=bf16)``), and after each of four train steps the
running statistics and the eval loss of one held-out batch.

Measured (this file's inputs): in f32 the two packages' eval losses stay
within 1e-3 of each other (6.739 at the start, 1.63 after four steps); in
bf16 both blow up, JAX's eval loss to 3.5e5 after the second step and
2.0e10 after the third, the port's a step earlier (1.2e7 after the first):
the drift is shared with JAX.  At lr 0 (the running statistics move, the
weights do not) both fall from 6.7 to 1.66 in bf16, within 7.6 % of each
other on the way: the drift comes from the bf16 updates of a random
network whose running statistics lag behind its weights; the one
statistic that is ill-conditioned in bf16 in both packages is the ASPP's
global-pool ABN (E[x^2] - E[x]^2 of bf16 squares over 4 pooled values a
channel), which already moves the first bf16 train loss by 2.5 % between
the packages (f32: 1e-6).
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
from bacs_tpu.train import optim as jax_optim
from bacs_tpu.train.state import TaskInfo as JaxTaskInfo
from bacs_tpu.train.state import TrainState as JaxTrainState
from bacs_tpu.train.step import make_steps as jax_make_steps
from bacs_tpu_torch.methods import ModelContext, create_method
from bacs_tpu_torch.models import create_network
from bacs_tpu_torch.train import optim
from bacs_tpu_torch.train.state import TaskInfo, TrainState
from bacs_tpu_torch.train.step import make_steps
from bacs_tpu_torch.utils.flax_weights import load_flax_variables, state_dict_to_flax
from torch_port_helpers import _one_thread, randomize_abn  # noqa: F401

CROP, NUM_CLASSES, BATCH, STEPS = 64, 5, 4, 4
TASK = dict(task_id=0, initial_classes=NUM_CLASSES, increment=0,
            num_classes=NUM_CLASSES, n_tasks=1, max_epochs=1)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def flax_variables():
    m = jax_create_network("networks.DeepLabV3", num_classes=NUM_CLASSES, axis_name=None,
                           backbone="resnet18")
    x = np.zeros((1, CROP, CROP, 3), np.float32)
    v = jax.jit(lambda k, x: m.init(k, x, train=False))(jax.random.PRNGKey(0), x)
    rs = np.random.RandomState(7)
    return randomize_abn(v["params"], rs), randomize_abn(v["batch_stats"], rs)


def batches():
    """STEPS train batches and the held-out eval batch."""
    rs = np.random.RandomState(3)
    return [{"image": rs.randn(BATCH, CROP, CROP, 3).astype(np.float32),
             "label": rs.randint(0, NUM_CLASSES, (BATCH, CROP, CROP)).astype(np.int32)}
            for _ in range(STEPS + 1)]


@functools.lru_cache(maxsize=None)
def runs(dtype, lr):
    """(JAX eval losses, port eval losses, JAX train losses, port train
    losses): the eval losses before the first step and after each."""
    params, stats = flax_variables()
    jdt, tdt = DTYPES[dtype]
    cfg = {"_target_": "torch.optim.SGD", "lr": lr, "momentum": 0.9, "nesterov": True,
           "weight_decay": 1e-4}
    tx = jax_optim.make_optimizer(cfg, jax_optim.poly_schedule(lr, 100))
    p = jax.tree.map(jnp.asarray, params)
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=p, batch_stats=jax.tree.map(jnp.asarray, stats),
        opt_state=tx.init(p), rng=jax.random.PRNGKey(2), prototypes=jnp.zeros((1, 512)),
        proto_counts=jnp.zeros((1,)))
    net = jax_create_network("networks.DeepLabV3", num_classes=NUM_CLASSES, axis_name=None,
                             backbone="resnet18", dtype=jdt)
    jtrain, jeval, _ = jax_make_steps(
        JaxModelContext(model=net, task=JaxTaskInfo(**TASK), axis_name=None),
        jax_create_method("loss.CrossEntropy"), tx, NUM_CLASSES, mesh=None)
    model = create_network("deeplab", NUM_CLASSES, backbone="resnet18", dtype=tdt,
                           param_dtype=torch.float32)
    load_flax_variables(model, params, stats)
    pstate = TrainState(model, *optim.make_optimizer(cfg, model.parameters(),
                                                     optim.poly_schedule(lr, 100)))
    ptrain, peval, put = make_steps(ModelContext(TaskInfo(**TASK)),
                                    create_method("loss.CrossEntropy"), NUM_CLASSES,
                                    device="cpu")
    data = batches()
    held = data[-1]
    jzero = lambda: jnp.zeros((NUM_CLASSES, NUM_CLASSES), jnp.int32)  # noqa: E731
    tzero = lambda: torch.zeros((NUM_CLASSES, NUM_CLASSES), dtype=torch.int32)  # noqa: E731
    jheld = {k: jnp.asarray(v) for k, v in held.items()}
    out = dict(jax_eval=[float(jeval(state, jzero(), jheld)[1])],
               port_eval=[float(peval(pstate, tzero(), put(held))[1])],
               jax_train=[], port_train=[])
    for b in data[:STEPS]:
        state, m = jtrain(state, {k: jnp.asarray(v) for k, v in b.items()})
        pstate, pm = ptrain(pstate, put(b))
        out["jax_train"].append(float(m["loss"]))
        out["port_train"].append(float(pm["loss"]))
        out["jax_eval"].append(float(jeval(state, jzero(), jheld)[1]))
        out["port_eval"].append(float(peval(pstate, tzero(), put(held))[1]))
        if "stats_err" not in out:  # after the first step: max rel err per tensor
            ref = dict(flat(state.batch_stats))
            got = dict(flat(state_dict_to_flax(model.state_dict())[1]))
            errs = {k: float(np.abs(got[k] - r).max() / np.abs(r).max())
                    for k, r in ref.items()}
            out["stats_err"] = max(errs.values())
            out["backbone_stats_err"] = max(v for k, v in errs.items()
                                            if k.startswith("backbone/"))
    return out


def flat(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float32)


def test_f32_eval_losses_agree_and_stay_sane():
    """f32: the running statistics after the first step within 1e-4 of
    JAX's (each tensor's largest value), the eval loss before and after
    every step within 5e-3 of JAX's (the leaky kink moves the updates,
    ``tests/test_torch_train_step.py``), and it falls below its start in
    both."""
    r = runs("f32", 0.01)
    assert r["stats_err"] <= 1e-4, r["stats_err"]
    np.testing.assert_allclose(r["port_eval"], r["jax_eval"], rtol=5e-3)
    assert max(r["jax_eval"][1:]) < r["jax_eval"][0]
    assert max(r["port_eval"][1:]) < r["port_eval"][0]


def test_bf16_statistics_alone_do_not_drift():
    """bf16 at lr 0: the weights stay, the running statistics move.  After
    the first step the backbone's statistics are within 2e-2 of JAX's
    (each tensor's largest value; measured 4.0e-3); the ASPP's are not
    held (measured 1.1: its global-pool ABN takes E[x^2] - E[x]^2 of bf16
    squares over 4 pooled values a channel whose spread is small beside
    their mean, in both packages, and the two libraries' bf16 rounding
    lands on different sides of that cancellation, which feeds
    ``red_bn``).  Both packages' eval losses stay finite and below their
    start, within 1e-1
    of each other at every step (bf16 rounding of different convolution
    libraries, measured 7.6 %) and 1e-2 at the last (measured 2e-3)."""
    r = runs("bf16", 0.0)
    assert r["backbone_stats_err"] <= 2e-2, r["backbone_stats_err"]
    for key in ("jax_eval", "port_eval"):
        assert all(np.isfinite(r[key])) and max(r[key][1:]) < r[key][0], r
    np.testing.assert_allclose(r["port_eval"], r["jax_eval"], rtol=1e-1)
    np.testing.assert_allclose(r["port_eval"][-1], r["jax_eval"][-1], rtol=1e-2)


def test_bf16_drift_is_shared_with_jax():
    """bf16 at lr 0.01: the eval loss before any update agrees with JAX's
    to 5e-3 (measured 2.2e-3), the first train loss to 5e-2 (measured
    2.5 %); then the eval loss of BOTH packages leaves the sane range
    within the four steps (above 100 times its start: JAX's reaches 2.0e10,
    the port's 1.2e7), while every train loss stays finite and below 2:
    the drift is the bf16 training of this random network in both
    packages, not a fault of the port."""
    r = runs("bf16", 0.01)
    np.testing.assert_allclose(r["port_eval"][0], r["jax_eval"][0], rtol=5e-3)
    np.testing.assert_allclose(r["port_train"][0], r["jax_train"][0], rtol=5e-2)
    for key in ("jax_train", "port_train"):
        assert all(np.isfinite(r[key])) and max(r[key]) < 2.0, r
    for key in ("jax_eval", "port_eval"):
        assert max(r[key][1:]) > 100 * r[key][0], r
