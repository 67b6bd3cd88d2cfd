"""Loss functionals (counterpart of paddle_tpu/nn/functional/loss.py).

Only the path `LlamaForCausalLM.loss` reaches is ported: `cross_entropy`
with hard labels, `ignore_index` and a mean over the valid rows, as the
reference's plain route computes it (loss.py:34-107: f32 log-softmax,
gather, masked mean). Soft labels, class weights, label smoothing and
`use_softmax=False` raise. The reference's blockwise fused kernel
(`FLAGS_use_fused_ce=1`, kernel rows 6-7) is not ported: a CUDA tensor
under that flag raises rather than quietly taking the plain route.
"""
from __future__ import annotations

import torch

from ...framework import core

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
    if (input.device.type != "cpu"
            and core.get_bool_flag("FLAGS_use_fused_ce", False)):
        raise NotImplementedError(
            "FLAGS_use_fused_ce=1: the fused cross-entropy kernels "
            "(PERF.md kernel rows 6-7) are not ported yet")
    logp = torch.log_softmax(input.float(), dim=-1)
    lbl = label
    if lbl.dim() == input.dim() and lbl.shape[-1] == 1:
        lbl = lbl.squeeze(-1)
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
