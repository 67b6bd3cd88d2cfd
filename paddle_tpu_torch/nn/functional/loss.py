"""Loss functionals (counterpart of paddle_tpu/nn/functional/loss.py).

Only the path `LlamaForCausalLM.loss` reaches is ported: `cross_entropy`
with hard labels, `ignore_index` and a mean over the valid rows. Two
routes, as in the reference (loss.py:34-107): under
`FLAGS_use_fused_ce=1`, a hard-label softmax loss over the last axis
with no class weights and no smoothing, on a CUDA tensor with at least
4096 classes (`kernels.cross_entropy.supported`), runs the fused
cross-entropy kernels (kernel rows 6-7) on the [N, V] rows; everything
else runs the plain route, f32 log-softmax, gather, masked mean. Soft
labels, class weights, label smoothing and `use_softmax=False` raise.
"""
from __future__ import annotations

import torch

from ...kernels import cross_entropy as kce

__all__ = ["cross_entropy"]


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """input: [..., C] logits; label: [...] (or [..., 1]) class ids.
    Returns the mean over labels != ignore_index (reduction="mean"), the
    sum ("sum"), or the per-row loss."""
    if weight is not None or soft_label or label_smoothing or not use_softmax:
        raise NotImplementedError(
            "cross_entropy: class weights, soft labels, label smoothing "
            "and use_softmax=False are not ported yet")
    if axis % input.dim() != input.dim() - 1:
        raise NotImplementedError(
            "cross_entropy: only the last axis is ported")
    if label.is_floating_point():
        raise NotImplementedError(
            "cross_entropy: soft (float) labels are not ported yet")
    lbl = label
    if lbl.dim() == input.dim() and lbl.shape[-1] == 1:
        lbl = lbl.squeeze(-1)
    n_class = input.shape[-1]
    if kce.supported(n_class, device=input.device):
        # big-vocab fast path: the fused kernels on [N, V] rows, no f32
        # [N, V] log-softmax
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
