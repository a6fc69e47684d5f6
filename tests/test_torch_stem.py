"""The fused stem (K12, ``network.fused_stem``) against the JAX package, on
the CPU.

- ``fused_abn_pool``: the port's plain versions against
  ``bacs_tpu.ops.stem_pool.fused_abn_pool`` (its jnp fallback off the TPU)
  in f32, values and the gradients of ``sum(p * w) + sum(p^2)``, at the
  cases of ``tests/test_stem_pool.py`` plus ties (inputs on a few levels,
  so the first-max routing decides the gradient), odd pooled sizes and
  C = 64.  Tolerance: p, mean and var rtol 1e-5 (the two packages' rsqrt
  may differ by an ulp); dc, dscale and dbias rtol 1e-4 of each tensor's
  largest value (f32 sums in another order).
- the ABN module with ``pool=True, fused_stem=True`` against the Flax
  module: output, gradients and running statistics, to the same
  tolerances; with odd H or W both take the unfused branch.
- one DeepLabV3-ResNet-18 64^2 CE train step and eval step with
  ``fused_stem=True`` against JAX ``make_steps``: the smooth network
  (identity activations) to f32 rounding, the leaky one to the update's
  scale (see ``tests/test_torch_train_step.py`` for why).
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
from bacs_tpu.ops.stem_pool import fused_abn_pool as jax_fused_abn_pool
from bacs_tpu.train import optim as jax_optim
from bacs_tpu.train.state import TaskInfo as JaxTaskInfo
from bacs_tpu.train.state import TrainState as JaxTrainState
from bacs_tpu.train.step import make_steps as jax_make_steps
from bacs_tpu_torch.methods import ModelContext, create_method
from bacs_tpu_torch.models import create_network
from bacs_tpu_torch.models import norm as norm_mod
from bacs_tpu_torch.models.deeplab import DeepLabV3
from bacs_tpu_torch.models.norm import ABN
from bacs_tpu_torch.ops import stem_pool
from bacs_tpu_torch.ops.stem_pool import fused_abn_pool
from bacs_tpu_torch.train import optim
from bacs_tpu_torch.train.state import TaskInfo, TrainState
from bacs_tpu_torch.train.step import make_steps
from bacs_tpu_torch.utils.flax_weights import load_flax_variables, state_dict_to_flax
from torch_port_helpers import _one_thread, randomize_abn  # noqa: F401

VALUE_RTOL, GRAD_RTOL = 1e-5, 1e-4


def _close(got, ref, rtol, name=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    err = np.abs(got - ref).max() if ref.size else 0.0
    assert err <= rtol * max(np.abs(ref).max(), 1e-30), (name, err, np.abs(ref).max())


def _inputs(shape, seed, scale=None, levels=None):
    rs = np.random.RandomState(seed)
    c = rs.randn(*shape).astype(np.float32)
    if levels:  # ties: every value on one of `levels` levels
        c = np.round(c * levels / 4).astype(np.float32) * (4.0 / levels)
    ch = shape[-1]
    s = (rs.rand(ch) + 0.5).astype(np.float32) if scale is None else np.asarray(scale, np.float32)
    b = (rs.randn(ch) * 0.1).astype(np.float32)
    n, h, w, _ = shape
    w_out = rs.randn(n, h // 2, w // 2, ch).astype(np.float32)
    return c, s, b, w_out


@jax.jit
def _jax_stem_jit(c, s, b, w):
    def loss(c, s, b):
        p, _, _ = jax_fused_abn_pool(c, s, b)
        return jnp.sum(p * w) + jnp.sum(jnp.square(p))

    return (*jax_fused_abn_pool(c, s, b), *jax.grad(loss, argnums=(0, 1, 2))(c, s, b))


def _jax_stem(c, s, b, w):
    return [np.asarray(x) for x in _jax_stem_jit(c, s, b, w)]


def _port_stem(c, s, b, w):
    ct, st, bt = (torch.tensor(x, requires_grad=True) for x in (c, s, b))
    p, mean, var = fused_abn_pool(ct, st, bt)
    (torch.sum(p * torch.from_numpy(w)) + torch.sum(p * p)).backward()
    return [x.detach().numpy() for x in (p, mean, var, ct.grad, st.grad, bt.grad)]


STEM_CASES = {
    "16x20": dict(shape=(2, 16, 20, 8), seed=0),
    "negative_scale": dict(shape=(1, 8, 8, 4), seed=1, scale=[-1.0, 0.7, -0.3, 2.0]),
    "12x16": dict(shape=(2, 12, 16, 8), seed=2),
    "ties": dict(shape=(2, 12, 16, 8), seed=5, levels=3),
    "non_square_odd_pooled": dict(shape=(3, 6, 2, 5), seed=6),
    "c64": dict(shape=(2, 8, 12, 64), seed=7),
}


@pytest.mark.parametrize("case", list(STEM_CASES))
def test_fused_abn_pool_matches_jax(case):
    args = _inputs(**STEM_CASES[case])
    ref, got = _jax_stem(*args), _port_stem(*args)
    for name, g, r, tol in zip(("p", "mean", "var", "dc", "dscale", "dbias"), got, ref,
                               (VALUE_RTOL,) * 3 + (GRAD_RTOL,) * 3):
        _close(g, r, tol, f"{case}: {name}")
    if case == "ties":  # the ties are real: most windows repeat their max
        # (the scale is positive, so y is increasing in c per channel)
        c = torch.from_numpy(args[0])
        n, h, w, ch = c.shape
        cp = torch.nn.functional.pad(c, (0, 0, 1, 1, 1, 1), value=-1e30)
        planes = torch.stack([cp[:, ky:ky + h:2, kx:kx + w:2, :]
                              for ky in range(3) for kx in range(3)])
        repeats = (planes == planes.amax(dim=0)).sum(dim=0)
        assert float((repeats > 1).float().mean()) > 0.3


def test_plain_backward_is_the_gather_of_the_forward():
    """The gather backward's da routes each window's dap to its first max:
    with g = 1 and the other vectors 0, dc sums dap over the windows whose
    argmax a cell is, so sum(dc) = sum(dap), and a tie goes to the first
    cell in scan order."""
    c = torch.zeros((1, 4, 4, 1))  # all equal: every window's first cell wins
    vec = torch.zeros((7, 1))
    vec[0], vec[2] = 1.0, 1.0  # a = 1, g = 1
    dap = torch.arange(1.0, 5.0).reshape(1, 2, 2, 1)
    dc = stem_pool.stem_pool_grad_plain(c, dap, vec, 0.01)
    assert float(dc.sum()) == float(dap.sum())
    # window (t, u) starts at input (2t - 1, 2u - 1), clipped to the image
    assert dc[0, 0, 0, 0] == 1 and dc[0, 1, 0, 0] == 3 and dc[0, 0, 1, 0] == 2
    assert dc[0, 1, 1, 0] == 4 and int((dc != 0).sum()) == 4


def test_cuda_wrappers_raise_off_the_card():
    c = torch.zeros((1, 4, 4, 2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        stem_pool._check("stem_pool_fwd", c, torch.zeros((2, 2)), 2)


# ---------------------------------------------------------------- module


def _jax_module(x, params, stats, fused_stem):
    mod = JaxABN(features=x.shape[-1], pool=True, fused_stem=fused_stem)
    w = np.random.RandomState(11).randn(*_pooled_shape(x.shape)).astype(np.float32)

    def loss(params, x):
        y, mut = mod.apply({"params": params,
                            "batch_stats": jax.tree.map(jnp.asarray, stats)}, x,
                           mutable=["batch_stats"])
        return jnp.sum(y * w) + jnp.sum(jnp.square(y)), (y, mut["batch_stats"])

    grad_fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
    (_, (y, new_stats)), grads = grad_fn(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    return np.asarray(y), grads, new_stats, w


def _pooled_shape(shape):
    n, h, w, c = shape
    return (n, (h + 1) // 2, (w + 1) // 2, c)


@pytest.mark.parametrize("shape", [(2, 16, 16, 8), (2, 15, 16, 8), (2, 16, 13, 8)])
def test_abn_module_fused_stem_matches_flax(shape, monkeypatch):
    rs = np.random.RandomState(3)
    x = rs.randn(*shape).astype(np.float32)
    ch = shape[-1]
    params = {"scale": (rs.rand(ch) + 0.5).astype(np.float32),
              "bias": (rs.randn(ch) * 0.1).astype(np.float32)}
    stats = {"mean": (rs.randn(ch) * 0.1).astype(np.float32),
             "var": (rs.rand(ch) + 0.5).astype(np.float32)}
    y_ref, (g_params, g_x), new_stats, w = _jax_module(x, params, stats, True)

    taken = []
    monkeypatch.setattr(norm_mod, "fused_abn_pool",
                        lambda *a: taken.append(1) or fused_abn_pool(*a))
    mod = ABN(ch, pool=True, fused_stem=True).train()
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(params["scale"]))
        mod.bias.copy_(torch.from_numpy(params["bias"]))
        mod.running_mean.copy_(torch.from_numpy(stats["mean"]))
        mod.running_var.copy_(torch.from_numpy(stats["var"]))
    xt = torch.tensor(x.transpose(0, 3, 1, 2), requires_grad=True)
    y = mod(xt)
    wt = torch.from_numpy(w.transpose(0, 3, 1, 2))
    (torch.sum(y * wt) + torch.sum(y * y)).backward()
    # the fused branch only for even H and W, as in JAX (norm.py:109-132)
    assert len(taken) == (shape[1] % 2 == 0 and shape[2] % 2 == 0)
    _close(y.detach().numpy().transpose(0, 2, 3, 1), y_ref, VALUE_RTOL, "y")
    _close(xt.grad.numpy().transpose(0, 2, 3, 1), g_x, GRAD_RTOL, "dx")
    _close(mod.weight.grad.numpy(), g_params["scale"], GRAD_RTOL, "dscale")
    _close(mod.bias.grad.numpy(), g_params["bias"], GRAD_RTOL, "dbias")
    _close(mod.running_mean.numpy(), new_stats["mean"], VALUE_RTOL, "running mean")
    _close(mod.running_var.numpy(), new_stats["var"], VALUE_RTOL, "running var")


def test_create_network_gates():
    """``fused_stem`` reaches every ABN, as the JAX factory passes it, and
    only the stem pools; ``fused_abn=false`` trains every ABN through the
    non-fused branch; ``remat`` chooses the blocks recomputed in the backward
    (held to the plain step by ``tests/test_torch_accumulate.py``)."""
    net = create_network("networks.DeepLabV3", 3, backbone="resnet18", fused_stem=True)
    abns = [m for m in net.modules() if isinstance(m, ABN)]
    assert all(m.fused_stem for m in abns) and sum(m.pool for m in abns) == 1
    assert not any(m.fused_stem for m in create_network(
        "networks.DeepLabV3", 3, backbone="resnet18").modules() if isinstance(m, ABN))
    assert not any(m.fusable for m in create_network(
        "networks.DeepLabV3", 3, backbone="resnet18", fused_abn=False).modules()
        if isinstance(m, ABN))
    net = create_network("networks.DeepLabV3", 3, backbone="resnet18", remat=[3],
                         fused_stem=True)
    assert net.backbone.remat_blocks == {"mod4_block1", "mod4_block2"}


# ---------------------------------------------------------------- train step

CROP, NUM_CLASSES, BATCH, STEPS = 64, 5, 4, 2
OPT_CFG = {"_target_": "torch.optim.SGD", "lr": 0.01, "momentum": 0.9,
           "nesterov": True, "weight_decay": 1e-4}
MAX_ITERS = 10
TASK = dict(task_id=0, initial_classes=NUM_CLASSES, increment=0,
            num_classes=NUM_CLASSES, n_tasks=1, max_epochs=1)


def _jax_net(activation):
    if activation == "leaky":
        return jax_create_network("networks.DeepLabV3", num_classes=NUM_CLASSES,
                                  norm="iabn_sync", axis_name=None,
                                  backbone="resnet18", fused_stem=True)
    return JaxDeepLabV3(num_classes=NUM_CLASSES, backbone_name="resnet18",
                        norm=functools.partial(JaxABN, activation="identity",
                                               fused_stem=True))


def _port_net(activation):
    if activation == "leaky":
        return create_network("networks.DeepLabV3", NUM_CLASSES, backbone="resnet18",
                              fused_stem=True)
    return DeepLabV3(NUM_CLASSES, backbone_name="resnet18",
                     norm=functools.partial(ABN, activation="identity", fused_stem=True))


@functools.lru_cache(maxsize=None)
def _variables():
    m = _jax_net("leaky")
    x = np.zeros((1, CROP, CROP, 3), np.float32)
    v = jax.jit(lambda k, x: m.init(k, x, train=False))(jax.random.PRNGKey(0), x)
    rs = np.random.RandomState(7)
    return randomize_abn(v["params"], rs), randomize_abn(v["batch_stats"], rs)


def _batches():
    rs = np.random.RandomState(3)
    out = []
    for _ in range(STEPS + 1):
        labels = rs.randint(0, NUM_CLASSES, (BATCH, CROP, CROP)).astype(np.int32)
        labels[rs.rand(*labels.shape) < 0.05] = 255
        out.append({"image": rs.randn(BATCH, CROP, CROP, 3).astype(np.float32),
                    "label": labels})
    return out


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float32)


@functools.lru_cache(maxsize=None)
def _jax_run(activation):
    params, stats = _variables()
    tx = jax_optim.make_optimizer(OPT_CFG, jax_optim.poly_schedule(0.01, MAX_ITERS))
    p = jax.tree.map(jnp.asarray, params)
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=p,
        batch_stats=jax.tree.map(jnp.asarray, stats), opt_state=tx.init(p),
        rng=jax.random.PRNGKey(2), prototypes=jnp.zeros((1, 512)),
        proto_counts=jnp.zeros((1,)))
    ctx = JaxModelContext(model=_jax_net(activation), task=JaxTaskInfo(**TASK), axis_name=None)
    train_step, eval_step, _ = jax_make_steps(
        ctx, jax_create_method("loss.CrossEntropy"), tx, NUM_CLASSES, mesh=None)
    data = [{k: jnp.asarray(v) for k, v in b.items()} for b in _batches()]
    losses = []
    for b in data[:STEPS]:
        state, metrics = train_step(state, b)
        losses.append(float(metrics["loss"]))
    cm, eval_loss = eval_step(state, jnp.zeros((NUM_CLASSES,) * 2, jnp.int32), data[-1])
    return dict(losses=losses, params=dict(_flat(state.params)),
                stats=dict(_flat(state.batch_stats)), eval=(np.asarray(cm), float(eval_loss)))


def _port_run(activation, monkeypatch):
    taken = []
    monkeypatch.setattr(norm_mod, "fused_abn_pool",
                        lambda *a: taken.append(1) or fused_abn_pool(*a))
    params, stats = _variables()
    model = _port_net(activation)
    load_flax_variables(model, params, stats)
    opt, sched = optim.make_optimizer(OPT_CFG, model.parameters(),
                                      optim.poly_schedule(0.01, MAX_ITERS))
    train_step, eval_step, put_batch = make_steps(
        ModelContext(TaskInfo(**TASK)), create_method("loss.CrossEntropy"), NUM_CLASSES,
        device="cpu")
    state = TrainState(model, opt, sched)
    data = [put_batch(b) for b in _batches()]
    losses = []
    for b in data[:STEPS]:
        state, metrics = train_step(state, b)
        losses.append(float(metrics["loss"]))
    cm, eval_loss = eval_step(state, torch.zeros((NUM_CLASSES,) * 2, dtype=torch.int32),
                              data[-1])
    assert len(taken) == STEPS  # one fused stem per train forward, none in eval
    p, s = state_dict_to_flax(state.model.state_dict())
    return dict(losses=losses, params=dict(_flat(p)), stats=dict(_flat(s)),
                eval=(cm.numpy(), float(eval_loss)))


@pytest.mark.parametrize("activation", ["identity", "leaky"])
def test_fused_stem_train_and_eval_step_match_jax(activation, monkeypatch):
    ref, got = _jax_run(activation), _port_run(activation, monkeypatch)
    np.testing.assert_allclose(got["losses"][0], ref["losses"][0], rtol=1e-5)
    p0 = dict(_flat(_variables()[0]))
    diff = sum(float(np.sum((got["params"][k] - ref["params"][k]) ** 2)) for k in p0)
    norm = sum(float(np.sum((ref["params"][k] - p0[k]) ** 2)) for k in p0)
    if activation == "identity":
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
        assert (diff / norm) ** 0.5 <= 1e-4
        np.testing.assert_array_equal(got["eval"][0], ref["eval"][0])
        np.testing.assert_allclose(got["eval"][1], ref["eval"][1], rtol=1e-5)
        stats_rtol = 1e-5
    else:
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-3)
        assert (diff / norm) ** 0.5 <= 0.25
        stats_rtol = 1e-2
    for k, r in ref["stats"].items():
        np.testing.assert_allclose(got["stats"][k], r, rtol=stats_rtol,
                                   atol=stats_rtol * np.abs(r).max(), err_msg=k)
