"""Gradient clipping (counterpart of paddle_tpu/nn/clip.py:20-84):
`ClipGradByValue`, `ClipGradByNorm` and `ClipGradByGlobalNorm`, called by
`Optimizer.step` on its parameter list before the update, as in the
reference.

Every decision is a `torch.where` on device tensors, as the reference's
is a `jnp.where`: nothing is read on the host, so a clip adds no
synchronizing call to a step. The norms are f32 sums of squares (the
global one the Python `sum` of the per-tensor sums, in parameter order),
and the factor, 1 where the norm is within the limit, multiplies every
gradient in f32 before it is rounded back to the gradient's dtype. A
parameter made with `ParamAttr(need_clip=False)` is left out of the
clip (its gradient neither counts in the norm nor is scaled), as
paddle's clips leave it; the reference's ignore the attribute (ROADMAP
Queue 3)."""
from __future__ import annotations

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]


def _grads(params):
    return [p for p in params if p.grad is not None and p.requires_grad
            and getattr(p, "need_clip", True)]


def _scaled(g, scale):
    return (g.float() * scale).to(g.dtype)


class ClipGradBase:
    def __call__(self, params):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Elementwise clamp of every gradient to [min, max] (min defaults
    to -max)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params):
        for p in _grads(params):
            p.grad = torch.clamp(p.grad, self.min, self.max)

    def __repr__(self):
        return f"ClipGradByValue(min={self.min}, max={self.max})"


class ClipGradByNorm(ClipGradBase):
    """Each gradient rescaled to an L2 norm of at most clip_norm."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params):
        for p in _grads(params):
            g = p.grad.float()
            n = torch.sqrt(torch.sum(g * g))
            scale = torch.where(n > self.clip_norm,
                                self.clip_norm / torch.clamp_min(n, 1e-12),
                                1.0)
            p.grad = _scaled(p.grad, scale)

    def __repr__(self):
        return f"ClipGradByNorm(clip_norm={self.clip_norm})"


class ClipGradByGlobalNorm(ClipGradBase):
    """One factor from the L2 norm of all gradients together."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def __call__(self, params):
        ps = _grads(params)
        if not ps:
            return
        total = torch.sqrt(sum(torch.sum(p.grad.float() ** 2) for p in ps))
        scale = torch.where(total > self.clip_norm,
                            self.clip_norm / torch.clamp_min(total, 1e-12),
                            1.0)
        for p in ps:
            p.grad = _scaled(p.grad, scale)

    def __repr__(self):
        return f"ClipGradByGlobalNorm(clip_norm={self.clip_norm})"
