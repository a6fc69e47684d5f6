"""The port's TranSeg against the Flax TranSeg, on the CPU.

``Attention`` and ``Block`` (hidden 32, 2 and 8 heads), ``TransformerHead``
and ``TranSeg`` (ResNet-18 backbone at 32^2, hidden 32, 4 heads, 2
layers, feed-forward 64, 8 classes) in f32, from the same Flax variables:
initialised by the JAX package, every 1-D ``scale`` and ``bias`` (ABN,
LayerNorm, Dense and convolution biases) and ``mask_norm`` redrawn, carried
across by ``utils/flax_weights.py``.  Forward and gradients, with
``active_classes`` below and at ``num_classes``, with and without the
background detector (its dropout at rate 0 on both sides; its masks are
held in ``tests/test_torch_seed_keys.py``).  Also the weights' round trip,
``transformer_init`` in its three modes against JAX's and the TranSeg
distributions of ``init_weights`` (JAX's ``model.init`` draws for a seed).  The steps are in ``tests/test_torch_transeg_steps.py``,
the Trainer in ``tests/test_torch_transeg_loop.py``.

Tolerances.  The blocks and the head are smooth (LayerNorm, softmax, exact
GELU, the L2 normalisation), so outputs and gradients hold to f32
rounding: each tensor within 1e-4 of its largest value (measured below
3e-6).  The TranSeg networks use identity ABN activations, as
``tests/test_torch_bacs_step.py`` does, which makes the whole network
smooth; with them each ABN's scale and bias gradients are held joined
(a norm whose output reaches the loss only through a 1 x 1 convolution
into the next norm has an exact bias gradient of 0, and both packages
return rounding noise there).  The running statistics after a train
forward to 1e-5 of their largest value.
"""

import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bacs_tpu.models.transeg as jax_transeg
from bacs_tpu.models import create_network as jax_create_network
from bacs_tpu.models.layers import Attention as JaxAttention
from bacs_tpu.models.layers import Block as JaxBlock
from bacs_tpu.models.norm import ABN as JaxABN
from bacs_tpu.train.learner import transformer_init as jax_transformer_init
from bacs_tpu.train.state import TaskInfo as JaxTaskInfo
from bacs_tpu.train.state import TrainState as JaxTrainState
from bacs_tpu_torch.ops import rng
from bacs_tpu_torch.models import ABN, create_network
from bacs_tpu_torch.models.layers import Attention, Block, Linear, _drop_path
from bacs_tpu_torch.models.transeg import NEG_INF, TranSeg, TransformerHead
from bacs_tpu_torch.train.learner import get_learner, transformer_init
from bacs_tpu_torch.utils.flax_init import init_weights
from bacs_tpu_torch.train.state import TaskInfo, TrainState
from bacs_tpu_torch.utils.flax_weights import (
    flax_to_state_dict, load_flax_variables, state_dict_to_flax)
from torch_port_helpers import _one_thread, randomize_abn  # noqa: F401

CROP, NUM_CLASSES, N_TASKS, BATCH, D = 32, 8, 3, 2, 32
TR = dict(hidden_dim=D, nhead=4, num_decoder_layers=2, dim_feedforward=64)
# (active classes, detector): below and at the class count, with and without
NETS = [(5, True), (8, False)]
NET_IDS = ["5of8-det", "8of8"]
TRUNC = 0.87962566103423978  # the std of a standard normal truncated to [-2, 2]


def redraw(tree, rs):
    """``randomize_abn``, and ``mask_norm`` drawn away from 1 and 0."""
    out = randomize_abn(tree, rs)
    for k, v in out.items():
        if hasattr(v, "items"):
            out[k] = redraw(v, rs)
        elif k in ("mask_norm_scale", "mask_norm_bias"):
            base = 1.0 if k.endswith("scale") else 0.0
            out[k] = (base + rs.uniform(-0.3, 0.3, v.shape)).astype(np.float32)
    return out


def shapes(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from shapes(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def flat(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float32)


def close(got, ref, rel=1e-4, msg=""):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=rel * max(float(np.abs(ref).max()), 1e-30), err_msg=msg)


def joined(d):
    """Each norm's scale and bias joined into one tensor (see the docstring)."""
    out = {}
    for k, v in d.items():
        stem, _, leaf = k.rpartition("/")
        if leaf in ("scale", "bias") and f"{stem}/scale" in d:
            out[stem] = np.concatenate([d[f"{stem}/scale"], d[f"{stem}/bias"]])
        else:
            out[k] = v
    return out


def hold_grads(got, ref):
    got, ref = joined(got), joined(ref)
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        close(got[k], r, msg=k)


def port_grads(module):
    return dict(flat(state_dict_to_flax(
        {k: torch.zeros_like(p) if p.grad is None else p.grad
         for k, p in module.named_parameters()})[0]))


# ---------------------------------------------------------------- blocks


@pytest.mark.parametrize("heads", [2, 8])
@pytest.mark.parametrize("kind", ["attention", "block"])
def test_block_matches_flax(kind, heads):
    """``Attention`` and ``Block`` (pre-LN, exact GELU): outputs and the
    gradients of the parameters and the input, 11 tokens of width 32."""
    rs = np.random.RandomState(heads)
    x = rs.randn(2, 11, D).astype(np.float32)
    jm = JaxAttention(D, heads) if kind == "attention" else JaxBlock(D, heads, 64)
    params = redraw(jm.init(jax.random.PRNGKey(0), x, train=False)["params"], rs)
    w = rs.randn(*x.shape).astype(np.float32)

    def loss(p, x):
        y = jm.apply({"params": p}, x, train=False)
        return jnp.sum(y * w), y

    (_, out), (g_p, g_x) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                       has_aux=True))(params, x)
    model = Attention(D, heads) if kind == "attention" else Block(D, heads, 64)
    model.load_state_dict(flax_to_state_dict(params, {}))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = model(xt)
    (got * torch.from_numpy(w)).sum().backward()
    close(got.detach(), out)
    close(xt.grad, g_x)
    hold_grads(port_grads(model), dict(flat(g_p)))


def test_drop_path_drops_whole_samples():
    """Stochastic depth (rate 0 in the shipped head): in training each
    sample's branch is kept, scaled by 1 / (1 - rate), or zeroed whole,
    drawn from the caller's key; in eval mode and at rate 0 the
    branch passes unchanged."""
    x = torch.randn(64, 5, 3, generator=torch.Generator().manual_seed(0)) + 3.0
    y = _drop_path(x, 0.5, True, rng.key(1))
    kept = (y != 0).flatten(1).all(1)
    assert bool(((y == 0).flatten(1).all(1) | kept).all())
    torch.testing.assert_close(y[kept], x[kept] / 0.5, rtol=0, atol=0)
    assert 16 <= int(kept.sum()) <= 48
    assert torch.equal(y, _drop_path(x, 0.5, True, rng.key(1)))
    assert _drop_path(x, 0.5, False) is x and _drop_path(x, 0.0, True) is x


# ---------------------------------------------------------------- the head


@pytest.mark.parametrize("active", [5, 8])
def test_transformer_head_matches_flax(active):
    """The head alone on [2, 2, 3, 16] features (a 2 x 3 slice of the 4 x 4
    positional embedding of a 64^2 crop): masks, ``image_feats`` and the
    gradients of both through every parameter and the input."""
    rs = np.random.RandomState(active)
    x = rs.randn(2, 2, 3, 16).astype(np.float32)
    jm = jax_transeg.TransformerHead(16, 64, NUM_CLASSES, active, **TR)
    params = redraw(jm.init(jax.random.PRNGKey(1), x, train=False)["params"], rs)
    w_m = rs.randn(2, 2, 3, active).astype(np.float32)
    w_f = rs.randn(2, 2, 3, D).astype(np.float32)

    def loss(p, x):
        m, f = jm.apply({"params": p}, x, train=False)
        return jnp.sum(m * w_m) + jnp.sum(f * w_f), (m, f)

    (_, (masks, feats)), (g_p, g_x) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, x)
    head = TransformerHead(16, 64, NUM_CLASSES, active, **TR)
    head.load_state_dict(flax_to_state_dict(params, {}))
    xt = torch.from_numpy(x).requires_grad_(True)
    m, f = head(xt.permute(0, 3, 1, 2))
    ((m * torch.from_numpy(w_m)).sum() + (f * torch.from_numpy(w_f)).sum()).backward()
    assert m.shape == (2, 2, 3, active) and f.shape == (2, 2, 3, D)
    close(m.detach(), masks, msg="masks")
    close(f.detach(), feats, msg="image_feats")
    close(xt.grad, g_x, msg="input")
    grads = port_grads(head)
    hold_grads(grads, dict(flat(g_p)))
    # the inactive tokens and mask-norm entries take no gradient
    if active < NUM_CLASSES:
        assert not grads["class_tokens"][active:].any()
        assert not grads["mask_norm_scale"][active:].any()


# ---------------------------------------------------------------- TranSeg


def jax_model(active, det):
    return jax_transeg.TranSeg(
        num_classes=NUM_CLASSES, crop_size=CROP, active_classes=active,
        backbone_name="resnet18", norm=functools.partial(JaxABN, activation="identity"),
        n_tasks=N_TASKS, use_bg_detector=det, **TR)


@functools.lru_cache(maxsize=None)
def flax_variables(det):
    x = np.zeros((1, CROP, CROP, 3), np.float32)
    with no_jax_dropout():
        v = jax.jit(lambda k, x: jax_model(None, det).init(k, x, train=False))(
            jax.random.PRNGKey(0), x)
    rs = np.random.RandomState(7)
    return redraw(v["params"], rs), randomize_abn(v["batch_stats"], rs)


def no_jax_dropout():
    return mock.patch.object(jax_transeg, "BgDetector",
                             functools.partial(jax_transeg.BgDetector, dropout_rate=0.0))


def port_model(active, det):
    model = TranSeg(NUM_CLASSES, crop_size=CROP, active_classes=active,
                    backbone_name="resnet18",
                    norm=functools.partial(ABN, activation="identity"), n_tasks=N_TASKS,
                    use_bg_detector=det, **TR)
    if det:
        model.seen_fg_network.dropout_rate = 0.0
    load_flax_variables(model, *flax_variables(det))
    return model


def outputs(out, active):
    """What a scalar of the outputs reads: the active channels of
    ``sem_logits`` (the rest is the constant fill), the penultimate
    features and every attention map (``image_feats`` last)."""
    return (out.sem_logits[..., :active], out.penultimate, *out.attentions)


@pytest.mark.parametrize("net", NETS, ids=NET_IDS)
def test_transeg_matches_flax(net):
    """Eval and train outputs: ``sem_logits`` (the inactive channels exactly
    ``NEG_INF``), ``logits``, the penultimate features and the attentions
    with ``image_feats`` last, to 1e-4 of each one's largest value; the
    gradients of a scalar of all outputs through every parameter and the
    input; the running statistics after the train forward."""
    active, det = net
    params, stats = flax_variables(det)
    rs = np.random.RandomState(active)
    x = rs.randn(BATCH, CROP, CROP, 3).astype(np.float32)
    model = port_model(active, det)
    with torch.no_grad():
        got_eval = model.eval()(torch.from_numpy(x))
        # the Predictor's entry point: the same full-width logits
        assert torch.equal(model.sem_logits(torch.from_numpy(x)), got_eval.sem_logits)
    w = [rs.randn(*t.shape).astype(np.float32) for t in outputs(got_eval, active)]
    jm = jax_model(active, det)

    def loss(p, x):
        out, upd = jm.apply({"params": p, "batch_stats": stats}, x, train=True,
                            mutable=["batch_stats"])
        return (sum(jnp.sum(t * c) for t, c in zip(outputs(out, active), w)),
                (out, upd["batch_stats"]))

    @jax.jit
    def run(p, x):
        ev = jm.apply({"params": p, "batch_stats": stats}, x, train=False)
        return ev, jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(p, x)

    with no_jax_dropout():
        ref_eval, ((_, (ref_train, ref_stats)), (g_p, g_x)) = run(params, x)
    xt = torch.from_numpy(x).requires_grad_(True)
    got_train = model.train()(xt)
    sum(torch.sum(t * torch.from_numpy(c))
        for t, c in zip(outputs(got_train, active), w)).backward()

    for mode, g, r in (("eval", got_eval, ref_eval), ("train", got_train, ref_train)):
        assert len(g.attentions) == len(r.attentions) == 5
        assert g.attentions[-1].shape == (BATCH, CROP // 16, CROP // 16, D)
        sem = g.sem_logits.detach()
        assert sem.shape == (BATCH, CROP // 16, CROP // 16, NUM_CLASSES)
        assert sem.dtype == torch.float32
        assert bool((sem[..., active:] == NEG_INF).all())
        close(sem, r.sem_logits, msg=f"{mode} sem_logits")
        close(g.logits[..., :active].detach(), r.logits[..., :active], msg=f"{mode} logits")
        close(g.penultimate.detach(), r.penultimate, msg=f"{mode} penultimate")
        for i, (a, b) in enumerate(zip(g.attentions, r.attentions)):
            close(a.detach(), b, msg=f"{mode} attention {i}")
    close(xt.grad, g_x, msg="input")
    hold_grads(port_grads(model), dict(flat(g_p)))
    got_stats = dict(flat(state_dict_to_flax(dict(model.named_buffers()))[1]))
    for k, r in flat(ref_stats):
        close(got_stats[k], r, rel=1e-5, msg=k)
    # the property BACS's end_task reads
    assert model.penultimate_stats_keys == jm.penultimate_stats_keys


def test_flax_state_dict_round_trip():
    """Dense kernels [in, out] become ``Linear`` weights [out, in];
    LayerNorm's scale the weight; the head's raw parameters keep name and
    layout (``proj_*`` multiply as x @ P); and everything comes back
    unchanged."""
    params, stats = flax_variables(True)
    sd = flax_to_state_dict(params, stats)
    head = params["base_classifier"]
    qkv = np.asarray(head["block0"]["attn"]["qkv"]["kernel"])
    assert qkv.shape == (D, 3 * D)
    np.testing.assert_array_equal(sd["base_classifier.block0.attn.qkv.weight"].numpy(), qkv.T)
    np.testing.assert_array_equal(sd["base_classifier.decoder_norm.weight"].numpy(),
                                  head["decoder_norm"]["scale"])
    for name in ("pos_embed", "class_tokens", "proj_patch", "proj_classes",
                 "mask_norm_scale", "mask_norm_bias"):
        np.testing.assert_array_equal(sd[f"base_classifier.{name}"].numpy(), head[name])
    assert sd["base_classifier.feature_embedding.weight"].shape == (D, 512, 1, 1)
    p2, s2 = state_dict_to_flax(sd)
    for a, b in ((params, p2), (stats, s2)):
        fa, fb = dict(flat(a)), dict(flat(b))
        assert fa.keys() == fb.keys()
        for key in fa:
            np.testing.assert_array_equal(fb[key], fa[key], err_msg=key)


@pytest.mark.parametrize("mode", ["background", "mean", "random"])
def test_transformer_init_matches_jax(mode):
    """Task 1 of a 4 + 2 split: the new tokens (rows 4 and 5) the
    background's, the mean of the old ones or unchanged; their
    ``mask_norm`` entries 1 and 0; every other entry untouched; task 0 a
    no-op.  Against JAX's ``transformer_init`` bit for bit but the mean
    (to 1e-7: a sum in another order)."""
    params, stats = flax_variables(False)
    task = dict(task_id=1, initial_classes=4, increment=2, num_classes=NUM_CLASSES,
                n_tasks=N_TASKS)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32),
                           params=jax.tree.map(jnp.asarray, params),
                           batch_stats=jax.tree.map(jnp.asarray, stats), opt_state=None,
                           rng=jax.random.PRNGKey(0), prototypes=jnp.zeros((1, 1)),
                           proto_counts=jnp.zeros((1,)))
    ref = jax_transformer_init(jstate, JaxTaskInfo(**task), mode).params["base_classifier"]
    model = port_model(4, False)
    state = TrainState(model, None, None)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert transformer_init(state, TaskInfo(**{**task, "task_id": 0}), mode) is state
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    assert get_learner("learner.TransformerLearner") is transformer_init
    transformer_init(state, TaskInfo(**task), mode)
    head = model.base_classifier
    for name in ("class_tokens", "mask_norm_scale", "mask_norm_bias"):
        np.testing.assert_allclose(getattr(head, name).detach().numpy(),
                                   np.asarray(ref[name]), rtol=0, atol=1e-7, err_msg=name)
    tokens = head.class_tokens.detach()
    old = before["base_classifier.class_tokens"]
    want = {"background": old[0:1].expand(2, -1), "mean": old[:4].mean(0, keepdim=True)
            .expand(2, -1), "random": old[4:6]}[mode]
    torch.testing.assert_close(tokens[4:6], want, rtol=0, atol=1e-7)
    assert torch.equal(tokens[:4], old[:4]) and torch.equal(tokens[6:], old[6:])
    assert head.mask_norm_scale[4:6].tolist() == [1.0, 1.0]
    assert head.mask_norm_bias[4:6].tolist() == [0.0, 0.0]
    assert torch.equal(head.mask_norm_scale[6:], before["base_classifier.mask_norm_scale"][6:])
    changed = {k for k, v in model.state_dict().items() if not torch.equal(v, before[k])}
    assert changed <= {f"base_classifier.{n}" for n in
                       ("class_tokens", "mask_norm_scale", "mask_norm_bias")}


def test_transformer_init_needs_class_tokens():
    """On a network without a TranSeg head the learner raises."""
    state = TrainState(create_network("deeplab", 21, backbone="resnet18"), None, None)
    with pytest.raises(ValueError, match="TranSeg"):
        transformer_init(state, TaskInfo(task_id=1, initial_classes=16, increment=1,
                                         num_classes=21, n_tasks=6), "mean")


def test_init_weights_draws_flax_initialisers():
    """The shipped head's widths (hidden 256, 8 heads, feed-forward 2048) on
    a ResNet-18 with the detector: every ``Linear`` and the feature
    embedding LeCun normal truncated at two deviations over the fan-in;
    ``pos_embed`` normal(1); ``class_tokens`` 0.02 x a standard normal
    truncated to [-2, 2]; ``proj_*`` normal(D^-1/2); LayerNorms and
    ``mask_norm`` 1 and 0; biases 0; the backbone He normal over the
    fan-out.  Each sample's std within 10 % of its law's (5 % for the
    larger ones)."""
    model = create_network("networks.TranSeg", 21, n_tasks=3, use_bg_detector=True,
                           backbone="resnet18",
                           transformer=dict(hidden_dim=256, nhead=8, dim_feedforward=2048))
    init_weights(model, 4)
    head = model.base_classifier
    n_linear = 0
    for name, m in model.named_modules():
        if isinstance(m, Linear) or name == "base_classifier.feature_embedding":
            n_linear += isinstance(m, Linear)
            w = m.weight.detach().float()
            std = (w[0].numel()) ** -0.5
            assert float(w.abs().max()) <= 2 * std / TRUNC * (1 + 1e-6), name
            assert abs(float(w.std()) / std - 1) < 0.05, (name, float(w.std()), std)
            assert not m.bias.any(), name
        elif isinstance(m, torch.nn.LayerNorm):
            assert bool((m.weight == 1).all()) and not m.bias.any(), name
    assert n_linear == 2 * 4
    w = model.backbone.mod5_block2.conv2.weight.detach()
    assert abs(float(w.std()) / (2.0 / (w.shape[0] * 9)) ** 0.5 - 1) < 0.05
    pos = head.pos_embed.detach()
    assert pos.shape == (1, 32, 32, 256) and abs(float(pos.std()) - 1) < 0.05
    tok = head.class_tokens.detach()
    assert float(tok.abs().max()) <= 0.04
    assert abs(float(tok.std()) / (0.02 * TRUNC) - 1) < 0.1, float(tok.std())
    for p in (head.proj_patch, head.proj_classes):
        assert abs(float(p.detach().std()) * 16 - 1) < 0.05
    assert bool((head.mask_norm_scale == 1).all()) and not head.mask_norm_bias.any()


def test_create_network_builds_transeg():
    """Both names, the config's null keys absent, the ``transformer``
    defaults (hidden 256, 2 heads, 2 layers, feed-forward 2048), bf16
    compute on f32 master weights in every ``Linear``, and the atrous
    encoder raising."""
    for name in ("networks.TranSeg", "transeg", "deep_lab_transformer"):
        model = create_network(name, 21, backbone="resnet18", crop_size=64,
                               active_classes=16, dtype=torch.bfloat16,
                               param_dtype=torch.float32)
        assert isinstance(model, TranSeg) and model.active_classes == 16
    head = model.base_classifier
    assert head.pos_embed.shape == (1, 4, 4, 256) and head.class_tokens.shape == (21, 256)
    assert head.num_decoder_layers == 2 and head.block1.attn.heads == 2
    assert head.block0.mlp_fc1.weight.shape == (2048, 256)
    linears = [m for m in model.modules() if isinstance(m, Linear)]
    assert len(linears) == 8
    assert all(m.compute_dtype == torch.bfloat16 and m.weight.dtype == torch.float32
               for m in linears)
    model.active_classes = 17
    assert head.active_classes == 17
    # the atrous flag gives TranSeg the atrous encoder's synchronized bn (ReLU)
    # on its ResNet, as the JAX registry does (bacs_tpu/models/__init__.py:56-63)
    bn = [m for m in create_network("transeg", 21, backbone="resnet18", crop_size=64,
                                    atrous_encoder=True).modules() if isinstance(m, ABN)]
    assert bn and all(m.sync and m.momentum == 3e-4 for m in bn)
    assert all(m.activation in ("relu", "identity") for m in bn)
    # the JAX registry builds the same variable tree
    jm = jax_create_network("transeg", 21, backbone="resnet18", crop_size=64,
                            active_classes=16, axis_name=None)
    ref = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                         jnp.zeros((1, 64, 64, 3)), train=False))
    want = {k: tuple(v.shape) for k, v in shapes(ref["params"])}
    got = {k: v.shape for k, v in flat(state_dict_to_flax(model.state_dict())[0])}
    assert got == want
