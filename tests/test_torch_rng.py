"""The port's counter-based draws (``bacs_tpu_torch/ops/rng.py``) against
``jax.random``, and the draws of a training run, on the CPU.

- ``key``, ``bits``, ``split`` and ``fold_in`` equal JAX's threefry2x32
  (partitionable counters, JAX's default) bit for bit, for seeds up to
  2^31 - 1 and 1-D to 4-D shapes; ``uniform`` and ``bernoulli`` too.
  ``normal`` is sqrt(2) erfinv of the same uniforms: torch's ``erfinv`` and
  XLA's polynomial ``erf_inv`` differ by up to 5.8e-6 relative in the
  tails (measured at these keys), so it is held at rtol 1e-5, its uniforms
  bit for bit.  ``gumbel`` differs by the two ``log``'s last bits (held at
  atol 1e-6), and ``categorical`` picks JAX's classes.
- A step's draws are a function of (key, step, rank) alone
  (``parallel.step_draws``), and a Trainer run twice on the CPU gives the
  same mIoUs and weights bit for bit.
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

from bacs_tpu_torch import parallel
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
    # folds compose as JAX's
    ref = key_words(jax.random.fold_in(jax.random.fold_in(k, 3), 1))
    assert rng.step_key(rng.key(seed), 3, rank=1) == ref


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
    np.testing.assert_allclose(rng.normal(pk, shape).numpy(), ref, rtol=1e-5, atol=1e-7)
    ref = np.asarray(jax.random.gumbel(k, shape))
    np.testing.assert_allclose(rng.gumbel(pk, shape).numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_equals_jax(seed):
    logits = np.random.RandomState(seed % 1000).randn(200, 6).astype(np.float32)
    logits[:, 2] = -np.inf  # a class of zero probability is never drawn
    ref = np.asarray(jax.random.categorical(jax_key(seed), logits))
    got = rng.categorical(rng.key(seed), torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert not bool((got == 2).any())


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


def test_step_draws_depend_on_key_step_and_rank_alone():
    """The key stream a train step hands the method: fold_in(key, step),
    then the rank under data parallelism; each draw the next fold."""
    k = rng.key(9)
    draws = parallel.step_draws(k, 4, None)
    assert draws.next() == rng.fold_in(rng.fold_in(k, 4), 0)
    assert draws.next() == rng.fold_in(rng.fold_in(k, 4), 1)
    again = parallel.step_draws(k, 4, None)
    assert [again.next(), again.next()] == [rng.fold_in(rng.fold_in(k, 4), i) for i in (0, 1)]
    assert parallel.step_draws(k, 5, None).next() != parallel.step_draws(k, 4, None).next()
    assert parallel.step_draws(None, 4, None) is None
    # a stream handed no key draws from torch's seeded CPU generator
    torch.manual_seed(3)
    a = rng.stream_of(None).next()
    torch.manual_seed(3)
    assert rng.stream_of(None).next() == a


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
    assert k0 == k1 == rng.key(trainer.seed)
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
    draws = parallel.step_draws(state.key, state.step, None)
    with torch.no_grad():
        return state.model.train().seen_fg_network.trunk(feats, draws)


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
