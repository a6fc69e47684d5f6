"""Segmentation losses, NHWC (port of ``bacs_tpu/ops/losses.py``).

Ported so far: :func:`cross_entropy` (the composed fallback of the CE step
and half of the K1 and K4 plain versions, ``ops/upsample_ce.py``),
:func:`binary_focal_loss` (the seen detector's loss),
:func:`weighted_cross_entropy` (the BACS main loss, half of K3's plain
version), MiB's :func:`unbiased_cross_entropy` and
:func:`unbiased_knowledge_distillation` (half of the K6 and K7 plain
versions), PLOP's :func:`pixel_entropy` (half of K9's),
:func:`local_pod` and :func:`features_distillation`, and iCaRL's
:func:`icarl_criterion`.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

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


def unbiased_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    old_classes: int,
    ignore_index: int = 255,
    reduction: str = "mean",
) -> torch.Tensor:
    """MiB unbiased CE (``bacs_tpu/ops/losses.py:104-131``): the old classes
    and the background fold into channel 0, log p(any class < old_classes),
    and a label < old_classes scores it.  "mean" divides by the valid
    count (0 if none); "none" returns the per-pixel loss, 0 where ignored.
    """
    x = logits.float()
    mask = (labels != ignore_index).float()
    lse = torch.logsumexp(x, dim=-1)
    log_p_old = torch.logsumexp(x[..., :old_classes], dim=-1) - lse
    outputs = torch.cat([log_p_old.unsqueeze(-1), x[..., old_classes:] - lse.unsqueeze(-1)],
                        dim=-1)
    remapped = torch.where(labels < old_classes, 0, labels - (old_classes - 1))
    remapped = torch.where(mask > 0, remapped, 0).long()
    nll = -outputs.gather(-1, remapped.unsqueeze(-1)).squeeze(-1)
    if reduction == "none":
        return nll * mask
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def unbiased_knowledge_distillation(
    new_logits: torch.Tensor,
    old_logits: torch.Tensor,
    alpha: float = 1.0,
) -> torch.Tensor:
    """MiB unbiased KD (``bacs_tpu/ops/losses.py:134-161``): the teacher's
    background probability is matched by the student's background plus
    new-class mass.  ``new_logits`` [..., C], ``old_logits`` [..., C_old],
    C > C_old; the teacher's softmax of ``alpha`` times its logits.  Minus
    the mean over every pixel."""
    c_old = old_logits.shape[-1]
    x = new_logits.float()
    den = torch.logsumexp(x, dim=-1)
    outputs_no_bkg = x[..., 1:c_old] - den.unsqueeze(-1)
    bkg_and_new = torch.cat([x[..., :1], x[..., c_old:]], dim=-1)
    outputs_bkg = torch.logsumexp(bkg_and_new, dim=-1) - den
    q = torch.softmax(old_logits.float() * alpha, dim=-1)
    loss = (q[..., 0] * outputs_bkg + (q[..., 1:] * outputs_no_bkg).sum(-1)) / c_old
    return -loss.mean()


def icarl_criterion(
    logits: torch.Tensor,
    labels: torch.Tensor,
    old_outputs: torch.Tensor,
    bkg: bool = False,
    ignore_index: int = 255,
) -> torch.Tensor:
    """iCaRL's BCE with logits against one-hot targets whose old channels
    are the previous model's sigmoid ``old_outputs`` [..., C_old]
    (``bacs_tpu/ops/losses.py:227-260``): per pixel the sum over channels,
    then the mean over ALL pixels (an ignored pixel's one-hot row is zero
    and still counts).  ``bkg`` keeps channel 0's one-hot target.  The
    stable form max(x, 0) - x t + log(1 + exp(-|x|)), with JAX's
    derivatives at x = 0 (``jax_abs``; ``torch.maximum`` splits the tie as
    ``jnp.maximum`` does)."""
    c = logits.shape[-1]
    c_old = old_outputs.shape[-1]
    valid = labels != ignore_index
    one_hot = ((torch.arange(c, device=labels.device) == labels.unsqueeze(-1))
               & valid.unsqueeze(-1)).float()
    old = old_outputs.float()
    if bkg:
        targets = torch.cat([one_hot[..., :1], old[..., 1:c_old], one_hot[..., c_old:]], -1)
    else:
        targets = torch.cat([old, one_hot[..., c_old:]], -1)
    x = logits.float()
    bce = (torch.maximum(x, torch.zeros_like(x)) - x * targets
           + torch.log1p(torch.exp(-jax_abs(x))))
    return bce.sum(dim=-1).mean()


def pixel_entropy(probs: torch.Tensor) -> torch.Tensor:
    """Normalised per-pixel entropy of [..., C] probabilities: minus the
    MEAN over channels of p log(p + 1e-8), divided by log(C + 1e-8)
    (``bacs_tpu/ops/losses.py:263-270``)."""
    factor = 1.0 / math.log(probs.shape[-1] + _EPS)
    return -factor * (probs * torch.log(probs + _EPS)).mean(dim=-1)


def local_pod(x: torch.Tensor, spp_scales: Sequence[int] = (1, 2, 4)) -> torch.Tensor:
    """Local POD embedding of [N, H, W, C] (already squared): for every
    region of every scale, the width-mean and the height-mean pools,
    flattened and concatenated -> [N, D] (``bacs_tpu/ops/losses.py:273-296``,
    the same flatten order)."""
    n, h, w, _ = x.shape
    emb = []
    for scale in spp_scales:
        kh, kw = h // scale, w // scale
        for i in range(scale):
            for j in range(scale):
                region = x[:, i * kh:(i + 1) * kh, j * kw:(j + 1) * kw, :]
                emb.append(region.mean(dim=2).reshape(n, -1))
                emb.append(region.mean(dim=1).reshape(n, -1))
    return torch.cat(emb, dim=1)


def features_distillation(
    attentions_old: Sequence[torch.Tensor],
    attentions_new: Sequence[torch.Tensor],
    index_new_class: int,
    nb_current_classes: int,
    nb_new_classes: int,
    pod_factor: float = 0.01,
    last_layer_factor: float = 0.0005,
    spp_scales: Sequence[int] = (1, 2, 4),
) -> torch.Tensor:
    """PLOP's local POD distillation over the attention maps and the logits
    (``bacs_tpu/ops/losses.py:299-344``): per layer, both maps squared, their
    local POD embeddings, the per-image distance sqrt(Σ (ea - eb)^2 + 1e-12)
    (JAX's, finite gradient where the two agree), its batch mean times the
    layer's factor (``last_layer_factor`` for the last) and the schedule
    sqrt(C_cur / C_new); the mean over layers.  Where the
    student's map has more channels (the logits), its new-class channels
    are summed into the background first."""
    if len(attentions_new) != len(attentions_old):
        raise ValueError("attention lists of different lengths")
    n_layers = len(attentions_new)
    schedule = math.sqrt(nb_current_classes / max(nb_new_classes, 1))
    total = 0.0
    for i, (a, b) in enumerate(zip(attentions_old, attentions_new)):
        a, b = a.float(), b.float()
        if a.shape[-1] != b.shape[-1]:
            bg = b[..., :1] + b[..., index_new_class:].sum(dim=-1, keepdim=True)
            b = torch.cat([bg, b[..., 1:index_new_class]], dim=-1)
        ea, eb = local_pod(torch.square(a), spp_scales), local_pod(torch.square(b), spp_scales)
        layer = torch.sqrt(torch.square(ea - eb).sum(dim=-1) + 1e-12).mean()
        layer = layer * (last_layer_factor if i == n_layers - 1 else pod_factor) * schedule
        total = total + layer
    return total / n_layers
