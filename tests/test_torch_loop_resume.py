"""The port's Trainer stopped after a mid-task checkpoint and resumed, on the
CPU (port only: the uninterrupted port run is the reference).

``conf/continual_debug`` with ``network=deep_lab`` (DeepLabV3-ResNet-18),
32^2 crops (``tests/test_torch_loop.py``'s set-up), BACS, ``debug: false``
(the loop disables resume in debug mode): the resumed run's parameters and
final metrics equal the uninterrupted run's.  Kept apart from
``tests/test_torch_loop.py``, which holds the Trainer against JAX's, so
that the two run on two workers of the tier-1 suite.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from bacs_tpu_torch.config import load_config
from bacs_tpu_torch.train import loop
from bacs_tpu_torch.utils import checkpoint
from torch_port_helpers import _one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(ROOT, "conf", "continual_debug")
BASE = ["network=deep_lab", "dataset.dataset.crop_size=32", "training.batch_size=3"]


def _resume_config(ckpt_dir, budget):
    """BACS on 24 images, batch 2: task 1 has 4 steps an epoch (task 0 9)
    and stops at its first checkpoint.  With ``budget`` (one step per new
    class) that is its step budget; without, it resumes with two steps of
    its schedule to go.  No ``ckpt_dir``: no checkpoints (saving changes
    nothing of the training)."""
    return load_config(CONF, "config", BASE + [
        "training.batch_size=2", "loss=bacs", "training.debug=false", "dataset.dataset.n_train=24"]
        + ([f"+training.ckpt_dir={ckpt_dir}"] if ckpt_dir else [])
        + (["+training.steps_per_class=1"] if budget else []))


@pytest.mark.parametrize("budget", [True, False], ids=["step_budget", "epoch"])
def test_resume_from_a_mid_task_checkpoint_matches_the_uninterrupted_run(tmp_path, budget):
    """The uninterrupted port run, not JAX, is the reference here on
    purpose: a task resumed already at its step budget trains no further
    step, where the JAX loop trains one step more
    (``bacs_tpu/train/loop.py:503-515``, ROADMAP.md queue 3).  A resume
    parity test against JAX differs there and must not undo this."""
    whole = loop.Trainer(_resume_config(None, budget), device="cpu")
    whole_miou = whole.fit()
    whole_final = whole.per_step_metric.compute()
    whole_params = [p.detach().clone() for p in whole.state.model.parameters()]

    ckpt_dir = str(tmp_path / "ckpt")
    saved = []
    try:
        with checkpoint.resume_check_saves(stop_task=1, record=saved), \
                pytest.raises(checkpoint.Interrupted):
            loop.Trainer(_resume_config(ckpt_dir, budget), device="cpu").fit()
        assert saved[-1][:2] == (1, "last0") and (0, "final") in [s[:2] for s in saved]
        with checkpoint.resume_check_saves():
            resumed = loop.Trainer(_resume_config(ckpt_dir, budget), device="cpu")
            assert resumed._try_resume() == 1 and resumed._skip_surgery
            assert resumed.state.step > 0 and resumed.state.prev_model is not None
            resumed = loop.Trainer(_resume_config(ckpt_dir, budget), device="cpu")
            miou = resumed.fit()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    for got, ref in zip(resumed.state.model.parameters(), whole_params):
        torch.testing.assert_close(got.detach(), ref, rtol=0, atol=0)
    assert miou == pytest.approx(whole_miou, abs=1e-6)
    final = resumed.per_step_metric.compute()
    for metric in ("mIoU", "IoU-Old", "IoU-New"):
        np.testing.assert_allclose(final[metric], whole_final[metric], atol=1e-6)
