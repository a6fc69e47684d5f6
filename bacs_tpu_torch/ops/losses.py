"""Segmentation losses, NHWC (port of ``bacs_tpu/ops/losses.py``).

Ported so far: :func:`cross_entropy` (the composed fallback of the CE step
and half of the K1 and K4 plain versions, ``ops/upsample_ce.py``),
:func:`binary_focal_loss` (the seen detector's loss) and
:func:`weighted_cross_entropy` (the BACS main loss, half of K3's plain
version).  The MiB, PLOP and iCaRL losses come with their methods
(ROADMAP.md queue 1 item 11).
"""

from __future__ import annotations

from typing import Optional

import torch

_EPS = 1e-8


def jax_abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's derivative at 0 (+1; torch ``abs`` has 0)."""
    return torch.where(x >= 0, x, -x)


def cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    ignore_index: int = 255,
    class_weights: Optional[torch.Tensor] = None,
    reduction: str = "mean",
) -> torch.Tensor:
    """Softmax cross entropy over the last axis, with an ignore index and
    optional per-class weights, computed in float32.

    torch ``F.cross_entropy`` semantics: with ``class_weights`` the "mean"
    divides by the sum of the target pixels' weights, not by their count.
    """
    mask = (labels != ignore_index).float()
    safe = torch.where(labels != ignore_index, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    w = mask if class_weights is None else class_weights.float()[safe] * mask
    if reduction == "none":
        return nll * w
    if reduction == "sum":
        return (nll * w).sum()
    return (nll * w).sum() / torch.clamp(w.sum(), min=_EPS)


def binary_focal_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    gamma: float = 2.0,
    alpha: Optional[float] = None,
    ignore_index: int = 255,
) -> torch.Tensor:
    """Binary focal loss with logits, (1 - pt)^gamma * BCE, mean over the
    pixels whose target is not ``ignore_index`` (0 if there are none);
    ``targets`` are 0/1 or ``ignore_index`` (``bacs_tpu/ops/losses.py:75-101``).

    At a logit of exactly 0 the gradient is JAX's: ``jnp.maximum`` splits
    a tie (torch.maximum does too, ``clamp`` does not) and ``jnp.abs`` has
    slope +1 there (torch ``abs`` 0).  A detector logit is exactly 0 where a
    feature equals its task prototype, as a prototype of one pixel does,
    while the head bias is still 0."""
    mask = (targets != ignore_index).float()
    t = torch.where(mask > 0, targets.float(), 0.0)
    x = logits.float()
    # stable BCE with logits: max(x, 0) - x t + log(1 + exp(-|x|))
    bce = (torch.maximum(x, torch.zeros_like(x)) - x * t
           + torch.log1p(torch.exp(-jax_abs(x))))
    focal = (1.0 - torch.exp(-bce)) ** gamma * bce
    if alpha is not None:
        focal = focal * (alpha * t + (1.0 - alpha) * (1.0 - t))
    return (focal * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def weighted_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    seen_probs: torch.Tensor,
    old_classes: int,
    gamma: float = 2.0,
    threshold: float = 0.5,
    ukd: bool = True,
    ignore_index: int = 255,
) -> torch.Tensor:
    """BACS weighted CE (``bacs_tpu/ops/losses.py:164-224``): a focal
    background/foreground term plus a new-vs-rest unbiased term.

    The background weight of a pixel is its max seen-probability over the
    last axis of ``seen_probs`` [N, H, W, T] (taken as a constant, and 1
    above ``threshold``); a background pixel's term 1 is scaled by (1 -
    weight)^gamma.  Term 2 folds the old classes into channel 0 (log of
    their probability mass, or 0 with ``ukd=False``).  The mean runs over
    ALL pixels, ignored ones included (the reference's quirk).
    """
    x = logits.float()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    max_seen = seen_probs.detach().amax(dim=-1)
    max_seen = torch.where(max_seen > threshold, 1.0, max_seen)
    focal_mod = (1.0 - torch.where(safe == 0, max_seen, 0.0)) ** gamma

    den = torch.logsumexp(x, dim=-1)
    # term 1: bg vs fg
    log_p_bg = x[..., 0] - den
    log_p_fg = torch.logsumexp(x[..., 1:], dim=-1) - den
    loss_bg_fg = focal_mod * -torch.where(safe == 0, log_p_bg, log_p_fg)

    # term 2: new vs rest, channel 0 replaced by the old classes' mass
    new_vs_rest = torch.where(safe < old_classes, 0, safe)
    if ukd:
        log_p_old = torch.logsumexp(x[..., :old_classes], dim=-1) - den
    else:
        log_p_old = torch.zeros_like(den)
    outputs = torch.cat([log_p_old.unsqueeze(-1), x[..., 1:] - den.unsqueeze(-1)], -1)
    nll_new = -outputs.gather(-1, new_vs_rest.unsqueeze(-1)).squeeze(-1)
    return ((loss_bg_fg + nll_new) * valid).mean()
