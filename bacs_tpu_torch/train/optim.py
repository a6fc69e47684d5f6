"""Optimizers and LR schedules (port of ``bacs_tpu/train/optim.py``).

The JAX package builds one optax chain: clip every gradient element to
[-2, 2] (reference: trainer.py:347-348), add coupled weight decay on every
parameter (ABN scale and bias too, as ``optax.add_decayed_weights`` does
unmasked), then the SGD-nesterov or Adam update at the scheduled rate.  In
PyTorch that is ``clip_grad_value_`` followed by a torch optimizer with
``weight_decay``: :func:`make_optimizer` builds the optimizer and a
``LambdaLR`` whose lr is the schedule itself (base lr 1), and
:func:`apply_updates` clips, steps both.  optax counts updates from 0, so
update k uses ``schedule(k)``; so does ``LambdaLR``.

Schedules are functions of the update count returning a Python float.

Gradient accumulation over k mini-steps (``training.accumulate_gradients``)
is the JAX package's ``optax.MultiSteps(tx, every_k_schedule=k)``
(``bacs_tpu/train/optim.py:154-155``): each mini-step folds its gradients
into their running mean, acc += (g - acc) / (n + 1), and every k-th runs
the chain above once on the mean, so the schedule counts the k-th
mini-steps.  The mean lives in the optimizer's per-parameter state
(``"grad_acc"``) and the mini-step count in its first parameter group
(``"mini_step"``), as optax keeps both in ``opt_state``: the optimizer's
``state_dict`` carries them into a checkpoint.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Iterable, Mapping, Tuple

import torch

Schedule = Callable[[int], float]


def poly_schedule(
    base_lr: float,
    max_iters: int,
    power: float = 0.9,
    end_learning_rate: float = 0.0001,
) -> Schedule:
    """PolyLR: base * (1 - step / max_iters)^power, and
    ``end_learning_rate`` past max_iters (reference: schedulers.py:29-43)."""

    def schedule(step: int) -> float:
        if step > max_iters:
            return end_learning_rate
        frac = min(max(step / max(max_iters, 1), 0.0), 1.0)
        return base_lr * (1.0 - frac) ** power

    return schedule


def warmup_poly_schedule(
    base_lr: float,
    max_iters: int,
    power: float = 0.9,
    warmup_factor: float = 0.001,
    warmup_iters_percentage: float = 0.1,
    warmup_method: str = "linear",
    constant_ending: float = 0.0,
) -> Schedule:
    """Linear or constant warmup, then poly, with an optional constant
    ending (reference: schedulers.py:46-124)."""
    warmup_iters = max_iters * warmup_iters_percentage

    def schedule(step: int) -> float:
        if step >= warmup_iters:
            wf = 1.0
        elif warmup_method == "linear":
            alpha = min(step / max(warmup_iters, 1e-8), 1.0)
            wf = warmup_factor * (1 - alpha) + alpha
        else:  # constant
            wf = warmup_factor
        poly = (1.0 - min(max(step / max(max_iters, 1), 0.0), 1.0)) ** power
        if constant_ending > 0 and wf == 1.0 and poly < constant_ending:
            return base_lr * constant_ending
        return base_lr * wf * poly

    return schedule


def make_schedule(
    scheduler_cfg: Mapping[str, Any] | None,
    base_lr: float,
    max_iters: int,
) -> Schedule:
    """A schedule from a reference-style scheduler config."""
    if not scheduler_cfg:
        return lambda step: base_lr
    target = str(scheduler_cfg.get("_target_", "training.PolyLR"))
    short = target.rsplit(".", 1)[-1].lower()
    if short in ("polylr", "poly"):
        return poly_schedule(
            base_lr, max_iters, power=float(scheduler_cfg.get("power", 0.9))
        )
    if short in ("warmuppoly", "warmup_poly"):
        return warmup_poly_schedule(
            base_lr,
            max_iters,
            power=float(scheduler_cfg.get("power", 0.9)),
            warmup_factor=float(scheduler_cfg.get("warmup_factor", 0.001)),
            warmup_iters_percentage=float(
                scheduler_cfg.get("warmup_iters_percentage", 0.1)
            ),
            warmup_method=str(scheduler_cfg.get("warmup_method", "linear")),
            constant_ending=float(scheduler_cfg.get("constant_ending", 0.0)),
        )
    if short in ("exponentiallr", "exponential"):
        gamma = float(scheduler_cfg.get("gamma", 0.9))
        return lambda step: base_lr * gamma ** (step / max(max_iters, 1))
    if short in ("cycliclr", "cyclic"):
        # triangular cyclic LR (torch CyclicLR default mode)
        base = float(scheduler_cfg.get("base_lr", base_lr * 0.1))
        max_lr = float(scheduler_cfg.get("max_lr", base_lr))
        step_size = float(scheduler_cfg.get("step_size_up", max(max_iters // 4, 1)))

        def cyclic(step: int) -> float:
            cycle = math.floor(1 + step / (2 * step_size))
            frac = abs(step / step_size - 2 * cycle + 1)
            return base + (max_lr - base) * max(0.0, 1.0 - frac)

        return cyclic
    raise ValueError(f"unknown scheduler {target!r}")


def make_optimizer(
    optimizer_cfg: Mapping[str, Any],
    params: Iterable[torch.nn.Parameter],
    schedule: Schedule,
    grad_clip_value: float = 2.0,
    accumulate_steps: int = 1,
) -> Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]:
    """(optimizer, scheduler) for ``params`` from an optimizer config.

    SGD (momentum, nesterov), Adam and AdamW, each with the config's
    weight decay (coupled for SGD and Adam, decoupled for AdamW, as the
    JAX chain).  ``grad_clip_value`` is kept in every parameter group and
    applied by :func:`apply_updates`, which also accumulates over
    ``accumulate_steps`` mini-steps.
    """
    target = str(optimizer_cfg.get("_target_", "torch.optim.SGD"))
    short = target.rsplit(".", 1)[-1].lower()
    wd = float(optimizer_cfg.get("weight_decay", 0.0))
    params = list(params)
    if short == "sgd":
        momentum = float(optimizer_cfg.get("momentum", 0.0))
        opt = torch.optim.SGD(
            params, lr=1.0, momentum=momentum, weight_decay=wd,
            nesterov=bool(optimizer_cfg.get("nesterov", False)) and momentum > 0,
        )
    elif short == "adam":
        betas = optimizer_cfg.get("betas", (0.9, 0.999))
        opt = torch.optim.Adam(
            params, lr=1.0, betas=(float(betas[0]), float(betas[1])),
            eps=float(optimizer_cfg.get("eps", 1e-8)), weight_decay=wd,
        )
    elif short == "adamw":
        opt = torch.optim.AdamW(params, lr=1.0, weight_decay=wd)
    else:
        raise ValueError(f"unknown optimizer {target!r}")
    for group in opt.param_groups:
        group["grad_clip_value"] = float(grad_clip_value or 0.0)
    opt.param_groups[0].update(accumulate_steps=max(int(accumulate_steps), 1), mini_step=0)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule)


def zero_missing_grads(optimizer: torch.optim.Optimizer) -> list:
    """The optimizer's parameters, each whose ``.grad`` is None given a
    zero one (see :func:`apply_updates`)."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return params


def apply_updates(
    optimizer: torch.optim.Optimizer,
    scheduler: torch.optim.lr_scheduler.LRScheduler,
) -> bool:
    """One mini-step from the parameters' ``.grad``; returns whether it
    updated the parameters.

    A parameter that the loss did not reach (``.grad`` None, as the BACS
    detector trunk at task > 0) gets a zero gradient first: torch optimizers
    skip such a parameter, while the optax chain still decays it and moves
    it by its momentum.  With ``accumulate_steps`` k > 1 the gradients join
    their running mean and only every k-th call goes on, with the mean in
    ``.grad``.  Then: clip by value, step the optimizer, advance the
    schedule."""
    params = zero_missing_grads(optimizer)
    head = optimizer.param_groups[0]
    k = head.get("accumulate_steps", 1)
    if k > 1:
        n = head["mini_step"]
        with torch.no_grad():
            for p in params:
                state = optimizer.state[p]
                if n == 0:
                    state["grad_acc"] = p.grad.clone()
                else:
                    acc = state["grad_acc"]
                    acc.add_((p.grad - acc) / (n + 1))
        head["mini_step"] = (n + 1) % k
        if n + 1 < k:
            return False
        for p in params:
            p.grad = optimizer.state[p].pop("grad_acc")
    for group in optimizer.param_groups:
        if group["grad_clip_value"]:
            torch.nn.utils.clip_grad_value_(group["params"], group["grad_clip_value"])
    optimizer.step()
    scheduler.step()
    return True
