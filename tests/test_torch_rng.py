"""The port's counter-based draws (``bacs_tpu_torch/ops/rng.py``) against
``jax.random``, and the draws of a training run, on the CPU.

- ``key``, ``bits``, ``split`` and ``fold_in`` equal JAX's threefry2x32
  (partitionable counters, JAX's default) bit for bit, for seeds up to
  2^31 - 1 and 1-D to 4-D shapes; ``uniform``, ``bernoulli``, ``normal``
  and ``truncated_normal`` too (XLA's CPU ``erf_inv``, ``ops/rng.py``).
- A train step splits the state's key as JAX's does, and a Trainer run
  twice on the CPU gives the same mIoUs and weights bit for bit, its key
  JAX's ``r_state`` split once per step.
- A checkpoint carries the key and the step, so a restored state draws what
  the saved one would have (``tests/test_torch_loop_resume.py`` holds the
  whole resumed run); a checkpoint that holds a ``torch.Generator``'s
  state in place of a key (the format before these draws) still restores,
  with the template's key.
"""

import os

import jax
import numpy as np
import pytest
import torch

from bacs_tpu_torch.config import load_config
from bacs_tpu_torch.models import create_network
from bacs_tpu_torch.ops import rng
from bacs_tpu_torch.train import loop, optim
from bacs_tpu_torch.train.state import TrainState
from bacs_tpu_torch.utils import checkpoint
from torch_port_helpers import _one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = (0, 1, 42, 2**31 - 1)
SHAPES = ((7,), (3, 5), (2, 3, 4), (2, 3, 4, 5))


def jax_key(seed):
    return jax.random.key(seed, impl="threefry2x32")


def key_words(k):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{len(s)}d")
def test_bits_equal_jax(seed, shape):
    assert rng.key(seed) == key_words(jax_key(seed))
    ref = np.asarray(jax.random.bits(jax_key(seed), shape)).astype(np.int64)
    got = rng.bits(rng.key(seed), shape)
    assert got.dtype == torch.int64 and got.shape == shape
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("seed", SEEDS)
def test_split_and_fold_in_equal_jax(seed):
    k = jax_key(seed)
    assert rng.split(rng.key(seed), 5) == [key_words(s) for s in jax.random.split(k, 5)]
    for data in (0, 1, 17, 2**32 - 1):
        assert rng.fold_in(rng.key(seed), data) == key_words(jax.random.fold_in(k, data))
    # a train step's split, then the rank folded in, as JAX's step
    nxt, step = jax.random.split(k)
    assert rng.train_step_keys(rng.key(seed), rank=1) == (
        key_words(nxt), key_words(jax.random.fold_in(step, 1)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{len(s)}d")
def test_uniform_normal_bernoulli_follow_jax(seed, shape):
    k, pk = jax_key(seed), rng.key(seed)
    for lo, hi in ((0.0, 1.0), (-0.3, 2.5), (float(np.finfo(np.float32).tiny), 1.0)):
        ref = np.asarray(jax.random.uniform(k, shape, minval=lo, maxval=hi))
        got = rng.uniform(pk, shape, lo, hi)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), ref)
    for p in (0.5, 0.9, 1.0):
        ref = np.asarray(jax.random.bernoulli(k, p, shape))
        np.testing.assert_array_equal(rng.bernoulli(pk, p, shape).numpy(), ref)
    ref = np.asarray(jax.random.normal(k, shape))
    np.testing.assert_array_equal(rng.normal(pk, shape).numpy(), ref)
    ref = np.asarray(jax.random.truncated_normal(k, -2, 2, shape))
    np.testing.assert_array_equal(rng.truncated_normal(pk, shape).numpy(), ref)


def test_the_card_path_raises_off_the_card():
    """``threefry_fill`` is the card's path: on the CPU it refuses, and a
    device other than the CPU or a card is refused by every draw."""
    with pytest.raises(ValueError, match="CUDA"):
        rng.threefry_fill(rng.key(0), (4,), 0, "cpu")
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        rng.uniform(rng.key(0), (4,), device="meta")
    # the plain version, as the card's wrapper holds its kernel to
    for mode, kw in ((0, {}), (1, dict(lo=-1.0, span=3.0)), (2, dict(p=0.25))):
        a = rng.fill_plain(rng.key(5), (6, 7), mode, **kw)
        b = rng._fill(rng.key(5), (6, 7), mode, "cpu", **kw)
        assert torch.equal(a, b)


def _bacs_config():
    return load_config(os.path.join(ROOT, "conf", "continual_debug"), "config", [
        "network=deep_lab", "dataset.dataset.crop_size=32", "training.batch_size=2",
        "loss=bacs", "training.debug=false", "dataset.dataset.n_train=24",
        "+training.steps_per_class=1"])


def test_trainer_runs_twice_bit_equal():
    """BACS (the detector's dropout, the crops, the replay picks and the
    autocontrast coin all drawn from keys) over the debug protocol, twice
    in one process: the same mIoUs and weights, bit for bit."""
    runs = []
    for _ in range(2):
        trainer = loop.Trainer(_bacs_config(), device="cpu")
        miou = trainer.fit()
        runs.append((miou, [list(r) for r in trainer.per_step_metric._per_step["mIoU"]],
                     [p.detach().clone() for p in trainer.state.model.parameters()],
                     trainer.state.key, trainer.state.step))
    (m0, r0, p0, k0, s0), (m1, r1, p1, k1, s1) = runs
    assert m0 == m1 and r0 == r1 and s0 == s1 > 0
    carried = jax.random.split(jax_key(trainer.seed), 3)[2]
    for _ in range(s0):
        carried = jax.random.split(carried)[0]
    assert k0 == k1 == key_words(carried)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def _small_state(key):
    model = create_network("deeplab", 6, n_tasks=2, use_bg_detector=True,
                           backbone="resnet18")
    opt, sched = optim.make_optimizer(
        {"_target_": "torch.optim.SGD", "lr": 0.01, "momentum": 0.9, "nesterov": True,
         "weight_decay": 1e-4}, model.parameters(), optim.poly_schedule(0.01, 10))
    return TrainState(model, opt, sched, key=key)


def _trunk_out(state):
    """The detector trunk's output under the dropout mask of the state's
    next train step."""
    feats = torch.linspace(-1, 1, 512 * 4).reshape(1, 512, 2, 2)
    _, step_key = rng.train_step_keys(state.key)
    with torch.no_grad():
        return state.model.train().seen_fg_network.trunk(feats, step_key)


def test_checkpoint_continues_the_draws(tmp_path):
    """A restored state has the saved key and step, so its next step draws
    the saved state's masks, whatever key the template was built with."""
    torch.manual_seed(0)
    state = _small_state(rng.key(7))
    state.step = 5
    path = checkpoint.save_task_checkpoint(str(tmp_path), 0, state, "last0")
    saved = torch.load(path, weights_only=False)
    assert saved["key"] == list(rng.key(7)) and "generator" not in saved
    torch.manual_seed(0)
    template = _small_state(rng.key(0))
    before = _trunk_out(template)
    restored = checkpoint.restore_checkpoint(path, template)
    assert restored.key == rng.key(7) and restored.step == 5
    assert torch.equal(_trunk_out(restored), _trunk_out(state))
    assert not torch.equal(before, _trunk_out(restored))  # the template's own draws


def test_a_generator_checkpoint_still_restores(tmp_path):
    """A checkpoint holding a ``torch.Generator``'s state and no key (the
    format before counter-based draws) restores: the weights, the counters,
    and the template's key in place of the generator."""
    torch.manual_seed(0)
    state = _small_state(rng.key(7))
    state.step = 5
    with torch.no_grad():
        next(state.model.parameters()).add_(1.0)
    saved = checkpoint.state_to_dict(state)
    saved.pop("key")
    saved["generator"] = torch.Generator().manual_seed(3).get_state()
    path = tmp_path / "old"
    torch.save(saved, path)
    torch.manual_seed(0)
    restored = checkpoint.restore_checkpoint(str(path), _small_state(rng.key(0)))
    assert restored.key == rng.key(0) and restored.step == 5
    for a, b in zip(restored.model.parameters(), state.model.parameters()):
        assert torch.equal(a, b)
