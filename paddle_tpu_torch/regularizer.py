"""Regularizers (counterpart of paddle_tpu/regularizer.py): the term each
adds to a gradient. A parameter's own `regularizer` attribute is added
to its gradient by `Optimizer.step`; passed as an optimizer's
`weight_decay`, either one is read for its coefficient alone (`_coeff`),
so `weight_decay=L1Decay(c)` decays as an L2 coefficient c, as in the
reference."""
from __future__ import annotations

import torch

__all__ = ["L1Decay", "L2Decay"]


class L2Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    def __call__(self, w):
        return self._coeff * w


class L1Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    def __call__(self, w):
        return self._coeff * torch.sign(w)
