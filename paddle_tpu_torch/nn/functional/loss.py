"""Loss functionals (counterpart of paddle_tpu/nn/functional/loss.py
l.34-244): `cross_entropy`, `softmax_with_cross_entropy`, `nll_loss`,
`mse_loss`, `l1_loss`, `smooth_l1_loss`, `binary_cross_entropy`,
`binary_cross_entropy_with_logits`, `kl_div` and `square_error_cost`,
with the reference's formulas and reductions ("mean" is the plain mean
unless stated).

`cross_entropy` takes three routes, as the reference (l.34-122):
- a hard-label softmax loss over the last axis with no class weights
  and no smoothing, under `FLAGS_use_fused_ce=1`, on a CUDA tensor with
  at least 4096 classes (`kernels.cross_entropy.supported`): the fused
  cross-entropy kernels (rows 6-7) on the [N, V] rows;
- the same loss otherwise: f32 log-softmax, gather, masked mean
  (`_plain_cross_entropy`);
- everything else (class `weight`, soft labels, `label_smoothing`,
  `use_softmax=False`, a non-last `axis`): the reference's general f32
  form. Soft labels are `soft_label=True` or a float label with the
  class axis's size; smoothing mixes ε / C into them, or for hard labels
  adds ε · mean(log p) to (1 − ε) · log p[label]; with `weight` the mean
  divides by the summed weights of the rows kept.
"""
from __future__ import annotations

import torch

from ...kernels import cross_entropy as kce

__all__ = ["cross_entropy", "softmax_with_cross_entropy",
           "binary_cross_entropy", "binary_cross_entropy_with_logits",
           "mse_loss", "l1_loss", "nll_loss", "smooth_l1_loss", "kl_div",
           "square_error_cost"]


def _reduce(val, reduction):
    if reduction == "mean":
        return val.mean()
    if reduction == "sum":
        return val.sum()
    return val


def _is_soft(input, label, ax, soft_label):
    return soft_label or (label.dim() == input.dim()
                          and label.shape[ax] == input.shape[ax]
                          and label.is_floating_point())


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """input: logits (probabilities with use_softmax=False) with the
    classes on `axis`; label: class ids ([...] or with a size-1 class
    axis) or soft labels. Returns the mean over labels != ignore_index
    (reduction="mean"), the sum ("sum"), or the per-row loss."""
    ax = axis % input.dim()
    last = ax == input.dim() - 1
    if (not _is_soft(input, label, ax, soft_label) and use_softmax
            and weight is None and not label_smoothing and last):
        lbl = label
        if lbl.dim() == input.dim() and lbl.shape[-1] == 1:
            lbl = lbl.squeeze(-1)
        n_class = input.shape[-1]
        if kce.supported(n_class, device=input.device):
            # big-vocab fast path: the fused kernels on [N, V] rows, no
            # f32 [N, V] log-softmax
            loss = kce.fused_cross_entropy(input.reshape(-1, n_class),
                                           lbl.reshape(-1),
                                           ignore_index).reshape(lbl.shape)
            if reduction == "mean":
                nvalid = (lbl != ignore_index).float().sum()
                return loss.sum() / torch.clamp(nvalid, min=1.0)
            if reduction == "sum":
                return loss.sum()
            return loss
        return _plain_cross_entropy(input, lbl, ignore_index, reduction)
    return _general_cross_entropy(input, label, weight, ignore_index,
                                  reduction, soft_label, ax, use_softmax,
                                  label_smoothing)


def _plain_cross_entropy(input, lbl, ignore_index, reduction):
    """The plain route: f32 log-softmax over the last axis, the label's
    entry gathered, ignore_index rows masked out."""
    logp = torch.log_softmax(input.float(), dim=-1)
    lbl = lbl.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl))
    picked = torch.gather(logp, -1, safe[..., None]).squeeze(-1)
    loss = torch.where(valid, -picked, torch.zeros_like(picked))
    if reduction == "mean":
        return loss.sum() / torch.clamp(valid.float().sum(), min=1.0)
    if reduction == "sum":
        return loss.sum()
    return loss


def _general_cross_entropy(input, label, weight, ignore_index, reduction,
                           soft_label, ax, use_softmax, ls):
    """The reference's general form (loss.py:73-121), in f32."""
    a = input.float()
    logp = (torch.log_softmax(a, dim=ax) if use_softmax
            else torch.log(torch.clamp_min(a, 1e-30)))
    n_class = input.shape[ax]
    if _is_soft(input, label, ax, soft_label):
        soft = label.float()
        if ls > 0:
            soft = soft * (1 - ls) + ls / n_class
        loss = -torch.sum(soft * logp, dim=ax)
        if weight is not None:
            wshape = [1] * input.dim()
            wshape[ax] = -1
            w = torch.sum(soft * weight.float().reshape(wshape), dim=ax)
            loss = loss * w
            if reduction == "mean":
                return loss.sum() / torch.clamp_min(w.sum(), 1e-12)
        return _reduce(loss, reduction)
    lbl = label
    if lbl.dim() == input.dim() and lbl.shape[ax] == 1:
        lbl = lbl.squeeze(ax)
    lbl = lbl.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl))
    picked = torch.gather(logp, ax, safe.unsqueeze(ax)).squeeze(ax)
    if ls > 0:
        picked = (1 - ls) * picked + ls * logp.mean(dim=ax)
    loss = torch.where(valid, -picked, 0.0)
    if weight is not None:
        w = weight.float()[safe] * valid.float()
        loss = loss * w
        if reduction == "mean":
            return loss.sum() / torch.clamp_min(w.sum(), 1e-12)
    if reduction == "mean":
        return loss.sum() / torch.clamp_min(valid.float().sum(), 1.0)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """The per-row loss with the class axis kept (size 1); with
    return_softmax, also softmax(logits) over `axis`."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(int(axis))
    if return_softmax:
        return loss, torch.softmax(logits, dim=int(axis))
    return loss


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    p = torch.clamp(input.float(), 1e-12, 1.0 - 1e-7)
    loss = -(label * torch.log(p) + (1 - label) * torch.log1p(-p))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    x, y = logit.float(), label.float()
    tail = torch.logaddexp(torch.zeros_like(x), -torch.abs(x))
    if pos_weight is not None:
        log_w = (pos_weight - 1) * y + 1
        loss = (1 - y) * x + log_w * (tail + torch.clamp_min(-x, 0.0))
    else:
        loss = torch.clamp_min(x, 0.0) - x * y + tail
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def mse_loss(input, label, reduction="mean", name=None):
    return _reduce((input - label) ** 2, reduction)


def square_error_cost(input, label):
    return (input - label) ** 2


def l1_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.abs(input - label), reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """input: log-probabilities [N, C, ...]; label: [N, ...] ids."""
    y = label.long()
    valid = y != ignore_index
    safe = torch.where(valid, y, torch.zeros_like(y))
    picked = torch.gather(input, 1, safe.unsqueeze(1)).squeeze(1)
    w = (weight.float()[safe] if weight is not None
         else torch.ones_like(picked))
    w = w * valid.float()
    loss = -picked * w
    if reduction == "mean":
        return loss.sum() / torch.clamp_min(w.sum(), 1e-12)
    return _reduce(loss, reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    """Huber's loss: the reference's smooth L1 times delta."""
    d = torch.abs(input - label)
    loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _reduce(loss * delta, reduction)


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    if log_target:
        loss = torch.exp(label) * (label - input)
    else:
        loss = torch.where(
            label > 0,
            label * (torch.log(torch.clamp_min(label, 1e-30)) - input), 0.0)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)
