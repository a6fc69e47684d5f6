"""The classifier head's life across tasks (port of ``bacs_tpu/train/learner.py``).

Heads are allocated at the final class count up front, so a task's "new
head" is the initialisation of its classes' rows of the padded head at the
task boundary, in place, under ``no_grad``; the optimizer's state is kept,
as the JAX learner keeps ``opt_state``.

- ``multihead_init`` (MiB's imprinting, reference learner/
  multiheadlearner.py:13-36): the new classes' weight rows copy the
  background's, and their biases and the background's own become
  bg_bias - log(new classes + 1).
- ``singlehead_init``: nothing to do.
- ``transformer_init`` (TranSeg's class-token growth, reference
  learner/transformerlearner.py:48-135): the new classes' tokens become
  the background's token (``background``), the mean of the old tokens
  (``mean``) or keep their allocation-time draws (``random``), and their
  ``mask_norm`` entries are reset to 1 and 0.

``train/loop.py`` calls the learner at each task boundary.
"""

from __future__ import annotations

import math

import torch

from bacs_tpu_torch.train.state import TaskInfo


@torch.no_grad()
def multihead_init(state, task: TaskInfo):
    """MiB imprinting of the classes that ``task`` introduces.  The port's
    head is a 1 x 1 ``Conv2d`` with weight [C, D, 1, 1] (Flax's kernel is
    [1, 1, D, C]), so class rows lie along dim 0."""
    if task.task_id == 0:
        return state
    head = state.model.classifier_head
    lo, hi = task.old_classes, task.nb_current_classes
    new_bias = head.bias[0] - math.log(hi - lo + 1)
    head.weight[lo:hi] = head.weight[0:1]
    head.bias[lo:hi] = new_bias
    head.bias[0] = new_bias  # the background's bias too (reference :35)
    return state


def singlehead_init(state, task: TaskInfo):
    return state


@torch.no_grad()
def transformer_init(state, task: TaskInfo, new_token_init: str = "random"):
    """TranSeg's class-token growth for the classes ``task`` introduces
    (``bacs_tpu/train/learner.py:59-85``), in place."""
    if task.task_id == 0:
        return state
    head = getattr(state.model, "base_classifier", None)
    if not hasattr(head, "class_tokens"):
        raise ValueError("transformer_init needs a TranSeg head (class tokens); "
                         f"the model is a {type(state.model).__name__}")
    tokens = head.class_tokens
    lo, hi = task.old_classes, task.nb_current_classes
    if new_token_init == "background":
        tokens[lo:hi] = tokens[0:1]
    elif new_token_init == "mean":
        tokens[lo:hi] = tokens[:lo].mean(dim=0, keepdim=True)
    # "random" (and any other value, as in JAX): the rows keep their
    # truncated-normal allocation-time values
    head.mask_norm_scale[lo:hi] = 1.0
    head.mask_norm_bias[lo:hi] = 0.0
    return state


LEARNERS = {
    "learner.multiheadlearner": multihead_init,
    "multiheadlearner": multihead_init,
    "multihead": multihead_init,
    "learner.singleheadlearner": singlehead_init,
    "singleheadlearner": singlehead_init,
    "singlehead": singlehead_init,
    "learner.baselearner": singlehead_init,
    "baselearner": singlehead_init,
    "learner.transformerlearner": transformer_init,
    "transformerlearner": transformer_init,
    "transformer": transformer_init,
}


def get_learner(target: str):
    """The learner of a config's ``learner._target_`` string."""
    key = target.lower().replace("_", "")
    key = key if key in LEARNERS else key.rsplit(".", 1)[-1]
    if key not in LEARNERS:
        raise ValueError(f"unknown learner {target!r}")
    return LEARNERS[key]
