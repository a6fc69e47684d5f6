"""ER, iCaRL and BACS through the port's ``Trainer`` against the JAX
``Trainer``, over three tasks, on the CPU.

The protocol and the checks of ``tests/test_torch_loop_methods.py`` (its
``run_pair`` and ``assert_runs_match``): ``conf/continual_debug`` with
DeepLabV3-ResNet-18 at 32^2, batch 3, debug (2 train steps a task), 3
tasks, the eval transform for training, JAX's initial weights, the smooth
network; every train-step loss within 1e-4, every mIoU within 1e-3.  ER
and BACS replay batches of 4 (the configs' 2 put the ASPP's global-pool
ABN over two images, ill-conditioned; ``tests/test_torch_loop.py``).
The replay crops are 26-32 px a side: with crops from 16 px, task 2's
second ER step replays near-uniform patches of the class-coloured images,
the same ill-conditioning, and the port's own loss there moved by 5.9e-4
when its initial weights moved by 1e-6 (relative, seeded), as far as it
differed from JAX (5.4e-4; measured); at 26 px the port is within 1.4e-5
of JAX.

Every draw of ER and BACS is injected identically on both sides, at the
Trainer level:

- the buffer samples' Gumbel keys, the replay crop and flip, the
  autocontrast's coin and ER's replayed partition (task 2 replays task 1
  at its first step and task 0 at its second) come from tables indexed by
  ``state.step`` (it counts every train step across tasks in both
  packages) and by the draw's order within the step.  JAX's train step is
  ``jax.jit``-compiled once per task, so a draw monkeypatched inside it
  runs at trace time: the tables are indexed by the traced ``state.step``
  (each method's ``compute_loss`` is wrapped to hold it while it traces),
  never by a Python counter, which would replay the first step's draws;
- the reservoir's uniforms of each ``end_task``: the port takes the ones
  JAX draws from its keys (``PRNGKey(1234 + task)`` for ER,
  ``PRNGKey(4321 + task)`` for BACS).

iCaRL draws nothing.
"""

import contextlib
import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bacs_tpu.data.transforms as jax_transforms
import bacs_tpu.methods.bacs as jax_bacs
import bacs_tpu.methods.er as jax_er
import bacs_tpu_torch.methods.bacs as port_bacs
import bacs_tpu_torch.methods.er as port_er
import test_torch_bacs_step as bs
import test_torch_loop_methods as lm
import test_torch_more_methods_step as ms
from bacs_tpu.train import buffer as jax_buffer
from bacs_tpu_torch.ops import rng
from bacs_tpu_torch.data.transforms import apply_crop_params
from bacs_tpu_torch.train import buffer as port_buffer
from torch_port_helpers import _one_thread  # noqa: F401

CROP, REPLAY, N_STEPS = 32, 4, 6
# the replay crops' smallest side
MIN_CROP = 26
REPLAY_OVERRIDES = [f"loss.replay_minibatch_size={REPLAY}"]
RUNS = {"er": ["loss=er"] + REPLAY_OVERRIDES, "icarl": ["loss=icarl"],
        "bacs": ["loss=bacs"] + REPLAY_OVERRIDES}
# ER's replayed partition at each step (read from task 2 on: steps 4, 5)
PARTITION = np.int32([0, 0, 0, 0, 1, 0])
# the autocontrast's coin at each step (BACS, tasks 1 and 2)
COIN = np.array([False, False, True, False, False, True])


@functools.lru_cache(maxsize=None)
def tables():
    """The per-step draws: two PRNG keys (the step's first and second buffer
    sample) and a crop and flip per replayed image."""
    rs = np.random.RandomState(17)
    keys = np.stack([np.stack([np.asarray(jax.random.PRNGKey(100 + 2 * s + k))
                               for k in range(2)]) for s in range(N_STEPS)])
    ch = rs.uniform(MIN_CROP, CROP, (N_STEPS, REPLAY)).astype(np.float32)
    cw = rs.uniform(MIN_CROP, CROP, (N_STEPS, REPLAY)).astype(np.float32)
    crop = dict(i=(rs.rand(N_STEPS, REPLAY) * (CROP - ch)).astype(np.float32),
                j=(rs.rand(N_STEPS, REPLAY) * (CROP - cw)).astype(np.float32),
                ch=ch, cw=cw, flip=rs.rand(N_STEPS, REPLAY) < 0.5)
    return keys, crop


def holding_step(cls, cur, step_of):
    """``cls.compute_loss`` wrapped to hold the step it runs in (and reset
    the step's draw count) while it runs."""
    compute_loss = cls.compute_loss

    def wrapped(self, *a, **k):
        state = a[2] if cls.__module__.startswith("bacs_tpu.") else a[1]
        cur.update(step=step_of(state), k=0)
        try:
            return compute_loss(self, *a, **k)
        finally:
            cur["step"] = None

    return mock.patch.object(cls, "compute_loss", wrapped)


def next_draw(cur):
    k = cur["k"]
    cur["k"] += 1
    return cur["step"], k


@contextlib.contextmanager
def jax_injected():
    keys, crop = tables()
    cur = {"step": None}
    sample, choice = jax_buffer.sample, jax.random.choice
    autocontrast = jax_bacs.random_autocontrast

    def fake_sample(buf, rng, n, task_id=None):
        step, k = next_draw(cur)
        return sample(buf, jnp.asarray(keys)[step, k], n, task_id=task_id)

    def fake_choice(key, a, shape=(), replace=True, p=None, axis=0):
        if cur["step"] is None:
            return choice(key, a, shape, replace, p, axis)
        return jnp.asarray(PARTITION)[cur["step"]]

    def fake_augment(rng, images, labels):
        s = cur["step"]
        one = lambda im, lb, i, j, ch, cw, f: (  # noqa: E731
            jnp.where(f, jax_transforms._resize_region(im, i, j, ch, cw, CROP, "bilinear")[:, ::-1],
                      jax_transforms._resize_region(im, i, j, ch, cw, CROP, "bilinear")),
            jnp.where(f, jax_transforms._resize_region(lb, i, j, ch, cw, CROP, "nearest")[:, ::-1],
                      jax_transforms._resize_region(lb, i, j, ch, cw, CROP, "nearest")))
        return jax.vmap(one)(images, labels, *(jnp.asarray(crop[k])[s] for k in
                                               ("i", "j", "ch", "cw", "flip")))

    step_of = lambda state: state.step  # noqa: E731  (traced)
    with contextlib.ExitStack() as stack:
        for cls in (jax_er.ExperienceReplayMethod, jax_bacs.BACSMethod):
            stack.enter_context(holding_step(cls, cur, step_of))
        stack.enter_context(mock.patch.object(jax_buffer, "sample", fake_sample))
        stack.enter_context(mock.patch.object(jax.random, "choice", fake_choice))
        stack.enter_context(mock.patch.object(jax_transforms, "replay_augment", fake_augment))
        stack.enter_context(mock.patch.object(
            jax_bacs, "random_autocontrast",
            lambda rng, x, p=0.5: autocontrast(rng, x, jnp.asarray(COIN, jnp.float32)[
                cur["step"]])))
        yield


@contextlib.contextmanager
def port_injected():
    keys, crop = tables()
    cur = {"step": None, "uniforms": iter(())}
    sample, add_batch, choice = port_buffer.sample, port_buffer.add_batch, rng.choice
    autocontrast = port_bacs.random_autocontrast

    def fake_sample(buf, n, key=None, task_id=None):
        step, k = next_draw(cur)
        g = np.asarray(jax.random.gumbel(jnp.asarray(keys[step, k]), (buf.size,)))
        return sample(buf, n, keys=torch.from_numpy(g.copy()), task_id=task_id)

    def fake_choice(key, p):
        if cur["step"] is None:
            return choice(key, p)
        return torch.tensor(PARTITION[cur["step"]])

    def fake_augment(images, labels, key=None):
        params = {k: torch.from_numpy(np.ascontiguousarray(v[cur["step"]]))
                  for k, v in crop.items()}
        return apply_crop_params(images, labels, params)

    def uniforms_of(cls, jax_uniforms):
        """``cls.end_task`` reading JAX's reservoir uniforms of its task."""
        end_task = cls.end_task

        def wrapped(self, state, ctx, data, *a, **k):
            cur["uniforms"] = iter(jax_uniforms(ctx.task.task_id, 4, 3))
            return end_task(self, state, ctx, data, *a, **k)

        return mock.patch.object(cls, "end_task", wrapped)

    with contextlib.ExitStack() as stack:
        for cls in (port_er.ExperienceReplayMethod, port_bacs.BACSMethod):
            stack.enter_context(holding_step(cls, cur, lambda state: state.step))
        stack.enter_context(uniforms_of(port_er.ExperienceReplayMethod, ms.jax_uniforms))
        stack.enter_context(uniforms_of(port_bacs.BACSMethod, bs.jax_uniforms))
        stack.enter_context(mock.patch.object(port_buffer, "sample", fake_sample))
        stack.enter_context(mock.patch.object(
            port_buffer, "add_batch",
            lambda *a, **k: add_batch(*a, **{**k, "uniforms": next(cur["uniforms"])})))
        stack.enter_context(mock.patch.object(rng, "choice", fake_choice))
        for module in (port_er, port_bacs):
            stack.enter_context(mock.patch.object(module, "replay_augment", fake_augment))
        stack.enter_context(mock.patch.object(
            port_bacs, "random_autocontrast",
            lambda x, key=None, p=0.5: autocontrast(
                x, key, 1.0 if COIN[cur["step"]] else 0.0)))
        yield


@functools.lru_cache(maxsize=None)
def runs(name):
    return lm.run_pair(RUNS[name], jax_injected, port_injected)


@pytest.mark.parametrize("name", list(RUNS))
def test_trainer_matches_jax(name):
    ref, got = runs(name)
    lm.assert_runs_match(ref, got)
    state = got["trainer"].state
    if name != "icarl":  # the buffer holds every task's items
        assert set(state.buffer.task_ids[state.buffer.valid].tolist()) == {0, 1, 2}
