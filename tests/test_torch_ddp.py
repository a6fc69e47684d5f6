"""Data parallelism: the port's two-rank steps against JAX's 2-device mesh.

Two gloo ranks on the CPU (``bacs_tpu_torch.parallel.spawn``, started once
by the module's ``ranks`` fixture, every case run in them) against the JAX
package's ``shard_map`` over a 2-device ``data`` mesh of the conftest's
virtual CPU devices, from the same Flax variables (ABN vectors redrawn by
``randomize_abn``) and the same seeded numpy inputs.  Each rank takes its
contiguous half of the global batch.

- CE step, DeepLabV3-ResNet-18 at 32^2, global batch 8, the fused stem, the
  synchronized norm with the identity activation (smooth, so the packages
  agree to rounding): the loss within 1e-4, every updated parameter and
  running statistic per tensor within 1e-4 of its largest value, the eval
  step's confusion matrix equal.  Rank 1's shard holds 40 % ignored pixels
  and rank 0's none, so the loss the ranks average (the mean of the two
  shard means, as JAX pmeans it) differs from the global batch's mean;
  the test checks that it does.
- The same step on the configured leaky network, at
  ``tests/test_multidevice.py``'s tolerance (rtol 5e-3, atol 5e-4), and its
  eval confusion matrix on the initial weights equal.
- Synchronized norms: ``iabn_sync`` (fused), ``abn_sync`` with
  ``fused=False``, ``bn`` with ``sync`` (ReLU), ``abr_sync`` (renorm; these
  three the non-fused branch) and Flax's ``BatchNorm``, in
  train mode: outputs, input and parameter gradients (averaged across the
  ranks as the step does), and the running statistics with the variance's
  n x world Bessel factor, within 1e-5.
- The fused stem (K12's plain version) fed all-reduced statistics against
  JAX's ``fused_abn_pool`` with ``axis_name``, forward and backward.
- A task-1 BACS step (``tests/test_torch_bacs_step.py``'s set-up: the
  detector, replay 4 from 8 slots, the draws injected alike on every rank
  and device) whose prototype folds sum across the ranks, and SDR's
  per-class prototypes: held as the one-device tests hold them.

``Predictor(n_devices=2)`` on two CPU replicas is bit-equal to one device
and holds to JAX's two-device Predictor as ``tests/test_torch_serve.py``
holds one device.

JAX is imported inside the reference functions: the ranks import this
module to run their cases and need none of it.
"""

import functools
import itertools
from unittest import mock

import numpy as np
import pytest
import torch

import bacs_tpu_torch.methods.bacs as port_bacs
from bacs_tpu_torch.ops import rng
from bacs_tpu_torch import parallel
from bacs_tpu_torch.data.transforms import apply_crop_params
from bacs_tpu_torch.methods import ModelContext, create_method
from bacs_tpu_torch.models.deeplab import DeepLabV3
from bacs_tpu_torch.models.norm import ABN, BatchNorm, make_norm
from bacs_tpu_torch.ops.stem_pool import fused_abn_pool
from bacs_tpu_torch.serve import Predictor
from bacs_tpu_torch.train import buffer as port_buffer
from bacs_tpu_torch.train import optim
from bacs_tpu_torch.train.state import TaskInfo, TrainState, frozen_copy
from bacs_tpu_torch.train.step import make_steps
from bacs_tpu_torch.utils.flax_weights import load_flax_variables, state_dict_to_flax
from torch_port_helpers import _one_thread, randomize_abn  # noqa: F401

CROP, N_CLASSES, GLOBAL = 32, 5, 8
OPT_CFG = {"_target_": "torch.optim.SGD", "lr": 0.01, "momentum": 0.9,
           "nesterov": True, "weight_decay": 1e-4}
MAX_ITERS = 10
TASK = dict(task_id=0, initial_classes=N_CLASSES, increment=0, num_classes=N_CLASSES,
            n_tasks=1, max_epochs=1)
# case -> (norm string, make_norm options); batchnorm is Flax's nn.BatchNorm
NORMS = {"iabn_sync": ("iabn_sync", {}), "abn_sync_plain": ("abn_sync", {"fused": False}),
         "bn": ("bn", {"sync": True}), "abr_sync": ("abr_sync", {}),
         "batchnorm": (None, {})}
# the BACS step (tests/test_torch_bacs_step.py), at 32^2 and a global batch of 8
B_CROP, B_CLASSES, B_TASKS, SLOTS, REPLAY = 32, 21, 6, 8, 4
B_TASK = dict(task_id=1, initial_classes=16, increment=1, num_classes=B_CLASSES,
              n_tasks=B_TASKS, max_epochs=30)
B_METHOD = dict(use_bg_detector=True, bg_weighted_ce=True, alpha=0.8, beta=0.5,
                buffer_size=SLOTS, replay_minibatch_size=REPLAY)



def _rows(global_batch, group):
    """This rank's (lo, hi) of a global batch."""
    return parallel.rank_rows(global_batch, parallel.world_size(group), parallel.rank(group))

def flat(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float32)


def joined(d):
    """Each norm's scale and bias as one vector: a bias whose output
    reaches the loss only through 1 x 1 convolutions into the next norm has
    a gradient of exactly 0, and both packages update it by rounding noise
    (``tests/test_torch_bacs_step.py``)."""
    out = {}
    for k, v in d.items():
        stem, leaf = k.rsplit("/", 1)
        if leaf in ("scale", "bias") and f"{stem}/scale" in d:
            out[stem] = np.concatenate([d[f"{stem}/scale"], d[f"{stem}/bias"]])
        else:
            out[k] = v
    return out


def assert_trees_close(got, ref, rel):
    got, ref = joined(got), joined(ref)
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        np.testing.assert_allclose(got[k], r, rtol=0, atol=rel * np.abs(r).max(), err_msg=k)


# ---------------------------------------------------------------- inputs


@functools.lru_cache(maxsize=None)
def inputs():
    rs = np.random.RandomState(3)
    labels = rs.randint(0, N_CLASSES, (GLOBAL, CROP, CROP)).astype(np.int32)
    labels[GLOBAL // 2:][rs.rand(GLOBAL // 2, CROP, CROP) < 0.4] = 255  # rank 1's shard
    ce = {"image": rs.randn(GLOBAL, CROP, CROP, 3).astype(np.float32), "label": labels}
    norm_x = rs.randn(4, 3, 5, 8).astype(np.float32) * 2 + 0.5
    norm_w = rs.randn(4, 3, 5, 8).astype(np.float32)
    stem_c = rs.randn(4, 8, 8, 16).astype(np.float32)
    stem_w = rs.randn(4, 4, 4, 16).astype(np.float32)
    sdr = dict(feats=rs.randn(4, 4, 4, 16).astype(np.float32),
               mask=rs.randint(0, 7, (4, 16, 16)).astype(np.int32),
               protos=rs.randn(N_CLASSES + 2, 16).astype(np.float32),
               counts=rs.randint(0, 30, N_CLASSES + 2).astype(np.float32))
    return dict(ce=ce, norm_x=norm_x, norm_w=norm_w, stem_c=stem_c, stem_w=stem_w, sdr=sdr)


def bacs_labels(rs, n, n_classes, crop):
    lab = rs.randint(0, n_classes, (n, crop, crop)).astype(np.int32)
    lab[rs.rand(*lab.shape) < 0.4] = 0
    lab[rs.rand(*lab.shape) < 0.05] = 255
    return lab


@functools.lru_cache(maxsize=None)
def bacs_inputs():
    rs = np.random.RandomState(5)
    batch = {"image": rs.randn(GLOBAL, B_CROP, B_CROP, 3).astype(np.float32),
             "label": bacs_labels(rs, GLOBAL, 17, B_CROP)}
    items = dict(images=rs.randn(10, B_CROP, B_CROP, 3).astype(np.float32),
                 logits=rs.randn(10, 2, 2, B_CLASSES).astype(np.float32),
                 labels=bacs_labels(rs, 10, 16, B_CROP),
                 losses=-rs.rand(10).astype(np.float32),
                 uniforms=(rs.rand(10).astype(np.float32), rs.rand(10).astype(np.float32)))
    protos = rs.randn(B_TASKS, 128).astype(np.float32)
    counts = np.zeros(B_TASKS, np.float32)
    counts[0] = 50.0
    crop = dict(i=np.float32([3.5, 0.0, 10.25, 0.0]), j=np.float32([0.0, 7.25, 1.0, 0.0]),
                ch=np.float32([20.0, 32.0, 15.5, 32.0]), cw=np.float32([26.5, 17.0, 30.0, 32.0]),
                flip=np.array([True, False, False, True]))
    return batch, items, protos, counts, crop


# ---------------------------------------------------------------- the ranks


def port_net(variant):
    if variant == "smooth":
        norm = functools.partial(make_norm("iabn_sync", fused_stem=True), activation="identity")
    else:
        norm = make_norm("iabn_sync", fused_stem=True)
    return DeepLabV3(N_CLASSES, backbone_name="resnet18", norm=norm)


def rank_ce(group, variant, trees, data):
    model = port_net(variant)
    load_flax_variables(model, *trees)
    state = TrainState(model, *optim.make_optimizer(OPT_CFG, model.parameters(),
                                                    optim.poly_schedule(0.01, MAX_ITERS)))
    ctx = ModelContext(TaskInfo(**TASK), group=group)
    train_step, eval_step, put = make_steps(ctx, create_method("loss.CrossEntropy"), N_CLASSES,
                                            device="cpu")
    lo, hi = _rows(GLOBAL, group)
    b = put({k: v[lo:hi] for k, v in data.items()})
    zeros = lambda: torch.zeros((N_CLASSES, N_CLASSES), dtype=torch.int32)  # noqa: E731
    cm0, _ = eval_step(state, zeros(), b)
    state, metrics = train_step(state, b)
    cm, eval_loss = eval_step(state, zeros(), b)
    params, stats = state_dict_to_flax(state.model.state_dict())
    return dict(loss=float(metrics["loss"]), params=dict(flat(params)),
                stats=dict(flat(stats)), cm0=cm0.numpy(), cm=cm.numpy(),
                eval_loss=float(eval_loss))


def port_norm(kind, c):
    norm, kw = NORMS[kind]
    return BatchNorm(c) if norm is None else make_norm(norm, **kw)(c)


def rank_norm(group, kind, variables, x, w):
    lo, hi = _rows(x.shape[0], group)
    m = port_norm(kind, x.shape[-1]).train()
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(variables["scale"]))
        m.bias.copy_(torch.from_numpy(variables["bias"]))
        m.running_mean.copy_(torch.from_numpy(variables["mean"]))
        m.running_var.copy_(torch.from_numpy(variables["var"]))
    xt = torch.from_numpy(x[lo:hi]).permute(0, 3, 1, 2).requires_grad_()
    with parallel.synchronized(group):
        y = m(xt)
        (y * torch.from_numpy(w[lo:hi]).permute(0, 3, 1, 2)).sum().backward()
    grads = [m.weight.grad, m.bias.grad]
    parallel.all_reduce_(grads, group)
    return dict(y=y.detach().permute(0, 2, 3, 1).numpy(),
                dx=xt.grad.permute(0, 2, 3, 1).numpy(),
                dscale=grads[0].numpy(), dbias=grads[1].numpy(),
                mean=m.running_mean.numpy(), var=m.running_var.numpy())


def rank_stem(group, c, w, scale, bias):
    lo, hi = _rows(c.shape[0], group)
    ct = torch.from_numpy(c[lo:hi]).requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    p, mean, var = fused_abn_pool(ct, st, bt, 1e-5, 0.01, group)
    (p * torch.from_numpy(w[lo:hi])).sum().backward()
    grads = [st.grad, bt.grad]
    parallel.all_reduce_(grads, group)
    return dict(p=p.detach().numpy(), mean=mean.numpy(), var=var.numpy(),
                dc=ct.grad.numpy(), dscale=grads[0].numpy(), dbias=grads[1].numpy())


@torch.no_grad()
def rank_sdr(group, d):
    lo, hi = _rows(d["feats"].shape[0], group)
    task = TaskInfo(task_id=1, initial_classes=N_CLASSES, increment=2,
                    num_classes=N_CLASSES + 2, n_tasks=2, max_epochs=1)
    state = TrainState(None, None, None, class_prototypes=torch.from_numpy(d["protos"]),
                       class_proto_counts=torch.from_numpy(d["counts"]))
    protos, counts = create_method("loss.SDR")._update_class_prototypes(
        state, torch.from_numpy(d["feats"][lo:hi]), torch.from_numpy(d["mask"][lo:hi]),
        task, group)
    return dict(protos=protos.numpy(), counts=counts.numpy())


def port_bacs_net():
    model = DeepLabV3(B_CLASSES, backbone_name="resnet18", n_tasks=B_TASKS,
                      use_bg_detector=True,
                      norm=functools.partial(ABN, activation="identity", sync=True))
    model.seen_fg_network.dropout_rate = 0.0
    return model


def rank_bacs(group, trees, buf, keys):
    batch, _, protos, counts, crop = bacs_inputs()
    model = port_bacs_net()
    load_flax_variables(model, *trees)
    opt, sched = optim.make_optimizer(OPT_CFG, model.parameters(),
                                      optim.poly_schedule(0.01, MAX_ITERS))
    state = TrainState(model, opt, sched, key=rng.key(0),
                       prototypes=torch.from_numpy(protos.copy()),
                       proto_counts=torch.from_numpy(counts.copy()),
                       prev_model=frozen_copy(model), buffer=buf)
    ctx = ModelContext(TaskInfo(**B_TASK), group=group)
    train_step, _, put = make_steps(ctx, create_method("loss.BACSLoss", **B_METHOD), B_CLASSES,
                                    device="cpu")
    lo, hi = _rows(GLOBAL, group)
    b = put({k: v[lo:hi] for k, v in batch.items()})
    # the draws of tests/test_torch_bacs_step.py's `injected`, alike on every rank
    pkeys = itertools.cycle([torch.from_numpy(k.copy()) for k in keys])
    sample, autocontrast = port_buffer.sample, port_bacs.random_autocontrast
    params = {k: torch.from_numpy(v) for k, v in crop.items()}
    with mock.patch.object(port_bacs.buffer_lib, "sample",
                           lambda buf, n, gen=None: sample(buf, n, keys=next(pkeys))), \
            mock.patch.object(port_bacs, "random_autocontrast",
                              lambda x, gen=None, p=0.5: autocontrast(x, gen, 0.0)), \
            mock.patch.object(port_bacs, "replay_augment",
                              lambda im, lab, gen=None: apply_crop_params(im, lab, params)):
        state, metrics = train_step(state, b)
    p, s = state_dict_to_flax(state.model.state_dict())
    return dict(loss=float(metrics["loss"]), params=dict(flat(p)), stats=dict(flat(s)),
                protos=state.prototypes.numpy(), counts=state.proto_counts.numpy())


def rank_cases(group, device, cases):
    """Every case of this file on one rank: {name: result}."""
    return {name: fn(group, *args) for name, (fn, args) in cases.items()}


# ---------------------------------------------------------------- JAX references


def mesh():
    import jax
    from jax.sharding import Mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    return Mesh(np.array(jax.devices()[:2]), ("data",))


def jax_net(variant, axis_name):
    from bacs_tpu.models import create_network
    from bacs_tpu.models.deeplab import DeepLabV3 as JaxDeepLabV3
    from bacs_tpu.models.norm import ABN as JaxABN

    if variant == "smooth":
        return JaxDeepLabV3(num_classes=N_CLASSES, backbone_name="resnet18", axis_name=axis_name,
                            norm=functools.partial(JaxABN, activation="identity",
                                                   axis_name=axis_name, fused_stem=True))
    return create_network("networks.DeepLabV3", num_classes=N_CLASSES, norm="iabn_sync",
                          axis_name=axis_name, backbone="resnet18", fused_stem=True)


@functools.lru_cache(maxsize=None)
def ce_trees():
    import jax

    m = jax_net("leaky", None)
    v = jax.jit(lambda k, x: m.init(k, x, train=False))(
        jax.random.PRNGKey(0), np.zeros((1, CROP, CROP, 3), np.float32))
    rs = np.random.RandomState(7)
    return randomize_abn(v["params"], rs), randomize_abn(v["batch_stats"], rs)


@functools.lru_cache(maxsize=None)
def jax_ce(variant):
    import jax
    import jax.numpy as jnp

    from bacs_tpu.methods import create_method as jax_create_method
    from bacs_tpu.methods.base import ModelContext as JaxModelContext
    from bacs_tpu.train import optim as jax_optim
    from bacs_tpu.train.state import TaskInfo as JaxTaskInfo
    from bacs_tpu.train.state import TrainState as JaxTrainState
    from bacs_tpu.train.step import make_steps as jax_make_steps

    params, stats = ce_trees()
    tx = jax_optim.make_optimizer(OPT_CFG, jax_optim.poly_schedule(0.01, MAX_ITERS))
    p = jax.tree.map(jnp.asarray, params)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=p,
                          batch_stats=jax.tree.map(jnp.asarray, stats), opt_state=tx.init(p),
                          rng=jax.random.PRNGKey(2), prototypes=jnp.zeros((1, 512)),
                          proto_counts=jnp.zeros((1,)))
    ctx = JaxModelContext(model=jax_net(variant, "data"), task=JaxTaskInfo(**TASK),
                          axis_name="data")
    train_step, eval_step, put = jax_make_steps(
        ctx, jax_create_method("loss.CrossEntropy"), tx, N_CLASSES, mesh=mesh())
    b = put({k: jnp.asarray(v) for k, v in inputs()["ce"].items()})
    zeros = lambda: jnp.zeros((N_CLASSES, N_CLASSES), jnp.int32)  # noqa: E731
    cm0, _ = eval_step(state, zeros(), b)
    state, metrics = train_step(state, b)
    cm, eval_loss = eval_step(state, zeros(), b)
    return dict(loss=float(metrics["loss"]), params=dict(flat(state.params)),
                stats=dict(flat(state.batch_stats)), cm0=np.asarray(cm0), cm=np.asarray(cm),
                eval_loss=float(eval_loss))


def jax_norm_module(kind, c):
    from flax import linen as nn

    from bacs_tpu.models.norm import make_norm as jax_make_norm

    norm, kw = NORMS[kind]
    if norm is None:
        return nn.BatchNorm(momentum=0.9, axis_name="data")
    return jax_make_norm(norm, axis_name="data", **kw)(c)


@functools.lru_cache(maxsize=None)
def norm_variables(kind):
    rs = np.random.RandomState(len(kind))
    c = inputs()["norm_x"].shape[-1]
    return dict(scale=rs.uniform(0.5, 1.5, c).astype(np.float32),
                bias=rs.uniform(-0.3, 0.3, c).astype(np.float32),
                mean=rs.uniform(-0.3, 0.3, c).astype(np.float32),
                var=rs.uniform(0.5, 2.0, c).astype(np.float32))


@functools.lru_cache(maxsize=None)
def jax_norm(kind):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    x, w = inputs()["norm_x"], inputs()["norm_w"]
    v = norm_variables(kind)
    module = jax_norm_module(kind, x.shape[-1])
    params = {"scale": jnp.asarray(v["scale"]), "bias": jnp.asarray(v["bias"])}
    stats = {"mean": jnp.asarray(v["mean"]), "var": jnp.asarray(v["var"])}

    def f(params, xs, ws):
        def loss(params, xs):
            y, mut = module.apply({"params": params, "batch_stats": stats}, xs,
                                  use_running_average=False, mutable=["batch_stats"])
            return jnp.sum(y * ws), (y, mut["batch_stats"])

        (_, (y, bs)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            params, xs)
        return y, bs, jax.lax.pmean(gp, "data"), gx

    y, bs, gp, gx = jax.jit(jax.shard_map(
        f, mesh=mesh(), in_specs=(P(), P("data"), P("data")),
        out_specs=(P("data"), P(), P(), P("data")), check_vma=False))(params, x, w)
    return dict(y=np.asarray(y), dx=np.asarray(gx), dscale=np.asarray(gp["scale"]),
                dbias=np.asarray(gp["bias"]), mean=np.asarray(bs["mean"]),
                var=np.asarray(bs["var"]))


@functools.lru_cache(maxsize=None)
def stem_vectors():
    rs = np.random.RandomState(9)
    return rs.uniform(0.5, 1.5, 16).astype(np.float32), rs.uniform(-0.3, 0.3, 16).astype(np.float32)


@functools.lru_cache(maxsize=None)
def jax_stem():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from bacs_tpu.ops.stem_pool import fused_abn_pool as jax_fused_abn_pool

    c, w = inputs()["stem_c"], inputs()["stem_w"]
    scale, bias = stem_vectors()

    def f(c, s, b, w):
        def loss(c, s, b):
            p, mean, var = jax_fused_abn_pool(c, s, b, 1e-5, 0.01, "data")
            return jnp.sum(p * w), (p, mean, var)

        (_, (p, mean, var)), (dc, ds, db) = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(c, s, b)
        return p, mean, var, dc, jax.lax.pmean(ds, "data"), jax.lax.pmean(db, "data")

    out = jax.jit(jax.shard_map(
        f, mesh=mesh(), in_specs=(P("data"), P(), P(), P("data")),
        out_specs=(P("data"), P(), P(), P("data"), P(), P()), check_vma=False))(
        jnp.asarray(c), jnp.asarray(scale), jnp.asarray(bias), jnp.asarray(w))
    return dict(zip(("p", "mean", "var", "dc", "dscale", "dbias"), map(np.asarray, out)))


@functools.lru_cache(maxsize=None)
def jax_sdr():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from bacs_tpu.methods import create_method as jax_create_method
    from bacs_tpu.train.state import TaskInfo as JaxTaskInfo

    d = inputs()["sdr"]
    task = JaxTaskInfo(task_id=1, initial_classes=N_CLASSES, increment=2,
                       num_classes=N_CLASSES + 2, n_tasks=2, max_epochs=1)
    method = jax_create_method("loss.SDR")

    class State:
        class_prototypes = jnp.asarray(d["protos"])
        class_proto_counts = jnp.asarray(d["counts"])

    out = jax.jit(jax.shard_map(
        lambda f, m: method._update_class_prototypes(State, f, m, task, "data"),
        mesh=mesh(), in_specs=(P("data"), P("data")), out_specs=(P(), P()),
        check_vma=False))(jnp.asarray(d["feats"]), jnp.asarray(d["mask"]))
    return dict(protos=np.asarray(out[0]), counts=np.asarray(out[1]))


@functools.lru_cache(maxsize=None)
def bacs_setup():
    """(flax trees, the JAX buffer, the port buffer, the Gumbel keys)."""
    import jax
    import jax.numpy as jnp

    from bacs_tpu.train import buffer as jax_buffer

    _, items, *_ = bacs_inputs()
    m = jax_bacs_net(None)
    v = jax.jit(lambda k, x: m.init(k, x, train=False))(
        jax.random.PRNGKey(0), np.zeros((1, B_CROP, B_CROP, 3), np.float32))
    rs = np.random.RandomState(11)
    trees = randomize_abn(v["params"], rs), randomize_abn(v["batch_stats"], rs)
    jbuf = jax_buffer.add_batch(
        jax_buffer.init_buffer(SLOTS, (B_CROP, B_CROP), (2, 2), B_CLASSES), None,
        jnp.asarray(items["images"]), jnp.asarray(items["logits"]),
        jnp.asarray(items["labels"]), jnp.asarray(items["losses"]), task_id=0, n_classes=16,
        uniforms=tuple(jnp.asarray(u) for u in items["uniforms"]))
    t = lambda a: torch.from_numpy(np.asarray(a).astype(np.float32))  # noqa: E731
    pbuf = port_buffer.BufferState(
        images=t(jbuf.images).to(torch.bfloat16), logits=t(jbuf.logits).to(torch.bfloat16),
        labels=torch.from_numpy(np.array(jbuf.labels)), importance=t(jbuf.importance),
        label_mask=torch.from_numpy(np.array(jbuf.label_mask)),
        task_ids=torch.from_numpy(np.array(jbuf.task_ids)),
        n_classes=torch.from_numpy(np.array(jbuf.n_classes)),
        valid=torch.from_numpy(np.array(jbuf.valid)),
        class_counts=torch.from_numpy(np.array(jbuf.class_counts)),
        num_seen=int(jbuf.num_seen))
    keys = [np.asarray(jax.random.gumbel(jax.random.PRNGKey(k), (SLOTS,))) for k in (21, 22)]
    return trees, jbuf, pbuf, keys


def jax_bacs_net(axis_name):
    from bacs_tpu.models import deeplab as jax_deeplab
    from bacs_tpu.models.norm import ABN as JaxABN

    return jax_deeplab.DeepLabV3(
        num_classes=B_CLASSES, backbone_name="resnet18", n_tasks=B_TASKS,
        use_bg_detector=True, axis_name=axis_name,
        norm=functools.partial(JaxABN, activation="identity", axis_name=axis_name))


@functools.lru_cache(maxsize=None)
def jax_bacs():
    import jax
    import jax.numpy as jnp

    import bacs_tpu.data.transforms as jax_transforms
    import bacs_tpu.methods.bacs as jax_bacs_mod
    from bacs_tpu.methods import create_method as jax_create_method
    from bacs_tpu.methods.base import ModelContext as JaxModelContext
    from bacs_tpu.models import deeplab as jax_deeplab
    from bacs_tpu.train import buffer as jax_buffer
    from bacs_tpu.train import optim as jax_optim
    from bacs_tpu.train.state import TaskInfo as JaxTaskInfo
    from bacs_tpu.train.state import TrainState as JaxTrainState
    from bacs_tpu.train.step import make_steps as jax_make_steps

    batch, _, protos, counts, crop = bacs_inputs()
    (params, stats), jbuf, _, _ = bacs_setup()
    tx = jax_optim.make_optimizer(OPT_CFG, jax_optim.poly_schedule(0.01, MAX_ITERS))
    p = jax.tree.map(jnp.asarray, params)
    bs = jax.tree.map(jnp.asarray, stats)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=p, batch_stats=bs,
                          opt_state=tx.init(p), rng=jax.random.PRNGKey(2),
                          prototypes=jnp.asarray(protos), proto_counts=jnp.asarray(counts),
                          # copies: the mesh step donates its state
                          prev_params=jax.tree.map(jnp.copy, p),
                          prev_batch_stats=jax.tree.map(jnp.copy, bs), buffer=jbuf)
    jkeys = itertools.cycle([jax.random.PRNGKey(21), jax.random.PRNGKey(22)])
    sample, autocontrast = jax_buffer.sample, jax_bacs_mod.random_autocontrast

    def augment(rng, images, labels):
        def one(im, lb, i, j, ch, cw, f):
            ri = jax_transforms._resize_region(im, i, j, ch, cw, B_CROP, "bilinear")
            rl = jax_transforms._resize_region(lb, i, j, ch, cw, B_CROP, "nearest")
            return jnp.where(f, ri[:, ::-1], ri), jnp.where(f, rl[:, ::-1], rl)

        return jax.vmap(one)(images, labels, *(jnp.asarray(crop[k]) for k in
                                               ("i", "j", "ch", "cw", "flip")))

    with mock.patch.object(jax_bacs_mod.buffer_lib, "sample",
                           lambda buf, rng, n, task_id=None: sample(buf, next(jkeys), n)), \
            mock.patch.object(jax_bacs_mod, "random_autocontrast",
                              lambda rng, x, p=0.5: autocontrast(rng, x, 0.0)), \
            mock.patch.object(jax_transforms, "replay_augment", augment), \
            mock.patch.object(jax_deeplab, "BgDetector",
                              functools.partial(jax_deeplab.BgDetector, dropout_rate=0.0)):
        ctx = JaxModelContext(model=jax_bacs_net("data"), task=JaxTaskInfo(**B_TASK),
                              axis_name="data")
        train_step, _, put = jax_make_steps(
            ctx, jax_create_method("loss.BACSLoss", **B_METHOD), tx, B_CLASSES, mesh=mesh())
        state, metrics = train_step(state, put({k: jnp.asarray(v) for k, v in batch.items()}))
    return dict(loss=float(metrics["loss"]), params=dict(flat(state.params)),
                stats=dict(flat(state.batch_stats)), protos=np.asarray(state.prototypes),
                counts=np.asarray(state.proto_counts))


# ---------------------------------------------------------------- the fixture


@pytest.fixture(scope="module")
def ranks():
    """Every case's result on each of two gloo ranks, one spawn."""
    trees, _, pbuf, keys = bacs_setup()
    data = inputs()
    cases = {f"ce_{v}": (rank_ce, (v, ce_trees(), data["ce"])) for v in ("smooth", "leaky")}
    cases.update({f"norm_{k}": (rank_norm, (k, norm_variables(k), data["norm_x"],
                                            data["norm_w"])) for k in NORMS})
    cases["stem"] = (rank_stem, (data["stem_c"], data["stem_w"], *stem_vectors()))
    cases["sdr"] = (rank_sdr, (data["sdr"],))
    cases["bacs"] = (rank_bacs, (trees, pbuf, keys))
    return parallel.spawn(rank_cases, 2, (cases,), threads=1)


def both(ranks, name):
    """Rank 0's result, after checking rank 1's replicated values agree."""
    r0, r1 = ranks[0][name], ranks[1][name]
    for key in ("loss", "params", "stats", "protos", "counts", "dscale", "dbias", "mean",
                "var", "cm", "cm0"):
        if key in r0:
            a, b = r0[key], r1[key]
            if isinstance(a, dict):
                assert all(np.array_equal(a[k], b[k]) for k in a), key
            else:
                np.testing.assert_array_equal(a, b, err_msg=key)
    return r0


def test_ce_step_smooth_matches_jax_mesh(ranks):
    ref, got = jax_ce("smooth"), both(ranks, "ce_smooth")
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-4)
    assert_trees_close(got["params"], ref["params"], 1e-4)
    assert_trees_close(got["stats"], ref["stats"], 1e-4)
    np.testing.assert_array_equal(got["cm0"], ref["cm0"])
    np.testing.assert_array_equal(got["cm"], ref["cm"])
    np.testing.assert_allclose(got["eval_loss"], ref["eval_loss"], rtol=1e-4)
    # the confusion matrix counts every valid pixel of the global batch
    assert int(got["cm"].sum()) == int((inputs()["ce"]["label"] != 255).sum())


def test_ce_loss_is_the_mean_of_the_shard_means(ranks):
    """With ignored pixels in one shard only, the averaged shard means and
    the global batch's mean differ; the ranks report the former, as JAX."""
    model = port_net("smooth")
    load_flax_variables(model, *ce_trees())
    data = inputs()["ce"]
    with torch.no_grad():  # one train-mode forward: the global batch's statistics
        logits = model.train()(torch.from_numpy(data["image"])).logits
    nll = torch.nn.functional.cross_entropy(
        logits.permute(0, 3, 1, 2), torch.from_numpy(data["label"]).long(),
        ignore_index=255, reduction="none")
    valid = torch.from_numpy(data["label"] != 255)
    whole = float(nll[valid].mean())
    halves = [float(nll[s][valid[s]].mean())
              for s in (slice(0, GLOBAL // 2), slice(GLOBAL // 2, GLOBAL))]
    got = both(ranks, "ce_smooth")["loss"]
    assert abs(whole - np.mean(halves)) > 1e-3
    np.testing.assert_allclose(got, np.mean(halves), rtol=1e-5)


def test_ce_step_leaky_matches_jax_mesh(ranks):
    """``tests/test_multidevice.py:84-90``'s tolerance: the leaky kink."""
    ref, got = jax_ce("leaky"), both(ranks, "ce_leaky")
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    for tree in ("params", "stats"):
        assert got[tree].keys() == ref[tree].keys()
        for k, r in ref[tree].items():
            np.testing.assert_allclose(got[tree][k], r, rtol=5e-3, atol=5e-4, err_msg=k)
    np.testing.assert_array_equal(got["cm0"], ref["cm0"])


@pytest.mark.parametrize("kind", list(NORMS))
def test_synchronized_norm_matches_flax(ranks, kind):
    """Outputs and input gradients of each rank's rows, the averaged
    parameter gradients, and the running statistics (the variance
    Bessel-corrected over the global rows) against the Flax module under
    ``shard_map``."""
    ref, got = jax_norm(kind), both(ranks, f"norm_{kind}")
    rows = slice(0, inputs()["norm_x"].shape[0] // 2)
    for key in ("y", "dx"):
        np.testing.assert_allclose(got[key], ref[key][rows], rtol=1e-5, atol=1e-5, err_msg=key)
    np.testing.assert_allclose(ranks[1][f"norm_{kind}"]["y"], ref["y"][2:], rtol=1e-5,
                               atol=1e-5)
    for key in ("dscale", "dbias", "mean", "var"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-5, atol=1e-5, err_msg=key)


def test_fused_stem_with_all_reduced_statistics_matches_jax(ranks):
    """K12's plain version, its moments and backward means averaged across
    the ranks, against ``fused_abn_pool(axis_name=...)``."""
    ref, got = jax_stem(), both(ranks, "stem")
    for key in ("p", "dc"):
        np.testing.assert_allclose(got[key], ref[key][:2], rtol=1e-5, atol=1e-5, err_msg=key)
        np.testing.assert_allclose(ranks[1]["stem"][key], ref[key][2:], rtol=1e-5, atol=1e-5)
    for key in ("mean", "var", "dscale", "dbias"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-5, atol=1e-5, err_msg=key)


def test_sdr_class_prototypes_sum_across_ranks(ranks):
    ref, got = jax_sdr(), both(ranks, "sdr")
    np.testing.assert_array_equal(got["counts"], ref["counts"])
    np.testing.assert_allclose(got["protos"], ref["protos"], rtol=1e-5, atol=1e-6)


def test_bacs_step_with_prototype_psum_matches_jax_mesh(ranks):
    """The task-1 BACS step: the loss within 1e-5, parameters and running
    statistics per tensor within 1e-4 of their largest value, the
    prototypes (folded from both shards) within 1e-5 and their counts
    equal."""
    ref, got = jax_bacs(), both(ranks, "bacs")
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    assert_trees_close(got["params"], ref["params"], 1e-4)
    assert_trees_close(got["stats"], ref["stats"], 1e-4)
    np.testing.assert_array_equal(got["counts"], ref["counts"])
    np.testing.assert_allclose(got["protos"], ref["protos"], rtol=0,
                               atol=1e-5 * np.abs(ref["protos"]).max())


def test_predictor_on_two_cpu_replicas():
    """Bit-equal to one device; against JAX's two-device Predictor as
    ``tests/test_torch_serve.py`` holds one device to JAX's."""
    import jax.numpy as jnp

    from bacs_tpu.serve import Predictor as JaxPredictor

    cfg = {"_target_": "networks.DeepLabV3", "norm": "iabn_sync", "backbone": "resnet18"}
    params, stats = ce_trees()
    kw = dict(crop_size=CROP, dtype=torch.float32, conf_dtype="float16")
    imgs = np.random.RandomState(0).randint(0, 256, (4, CROP, CROP, 3)).astype(np.uint8)
    one = Predictor(cfg, N_CLASSES, params, stats, device="cpu", **kw)
    two = Predictor(cfg, N_CLASSES, params, stats, device="cpu", n_devices=2, **kw)
    assert two.n_devices == 2 and len(two.replicas) == 2
    assert two.replicas[1] is not two.model
    (p1, c1), (p2, c2) = one.predict(imgs), two.predict(imgs)
    np.testing.assert_array_equal(p2, p1)
    np.testing.assert_array_equal(c2, c1)
    with pytest.raises(ValueError, match="divisible"):
        two.predict(imgs[:3])
    mesh()
    ref = JaxPredictor(cfg, N_CLASSES, params, stats, crop_size=CROP, dtype=jnp.float32,
                       conf_dtype="float16", n_devices=2)
    assert ref.n_devices == 2
    rp, rc = ref.predict(imgs)
    assert (p2 == np.asarray(rp)).mean() >= 0.999
    np.testing.assert_allclose(c2.astype(np.float32), np.asarray(rc).astype(np.float32),
                               atol=2e-3)
