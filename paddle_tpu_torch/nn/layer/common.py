"""`Linear` and `LayerNorm` in the reference's layout (counterpart of
paddle_tpu/nn/layer/common.py::Linear and norm.py::LayerNorm), and the
dropout layers (common.py:66-110): `Dropout`, `Dropout2D`, `Dropout3D`
and `AlphaDropout`, which apply `nn.functional`'s forms in training mode
and pass the input through in eval (`Dropout`'s "downscale_in_infer"
scales it by 1 - p there). Each takes an optional `generator`; None
draws from the dropout stream (`framework.core.dropout_generator`).

`Linear` holds `weight` [in, out] and `bias` [out] (`x @ W + b`, paddle's
layout, so a reference state dict loads as is); its weight is drawn
Xavier-uniform from an explicit generator, its bias zeros, as paddle
initialises them. `LayerNorm` computes its statistics in f32
(`nn/functional/norm.py:27-51` of the reference) with `weight` ones and
`bias` zeros. Both are created on `device` (`cuda` unless the caller
names another; `framework.core.resolve_device`).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...framework.core import resolve_device
from ..functional import common as F

__all__ = ["Linear", "LayerNorm", "layer_norm", "Dropout", "Dropout2D",
           "Dropout3D", "AlphaDropout"]


class Linear(nn.Module):
    def __init__(self, in_features, out_features, bias=True, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.in_features, self.out_features = in_features, out_features
        bound = math.sqrt(6.0 / (in_features + out_features))
        w = torch.empty((in_features, out_features), device=dev, dtype=dtype)
        w.uniform_(-bound, bound, generator=generator)
        self.weight = nn.Parameter(w)
        self.bias = (nn.Parameter(torch.zeros(out_features, device=dev,
                                              dtype=dtype))
                     if bias else None)

    def forward(self, x):
        y = x @ self.weight
        return y if self.bias is None else y + self.bias


def layer_norm(x, weight, bias, eps):
    """The reference's layer_norm over the last axis: f32 mean and
    (biased) variance, (x - mu) * rsqrt(var + eps) * w + b, cast back to
    x's dtype."""
    a = x.float()
    mu = a.mean(-1, keepdim=True)
    var = a.var(-1, keepdim=True, unbiased=False)
    out = (a - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, hidden, epsilon=1e-5, device=None,
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden, device=dev, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(hidden, device=dev, dtype=dtype))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.epsilon)


class Dropout(nn.Module):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None,
                 generator=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode, generator=self.generator)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(nn.Module):
    def __init__(self, p=0.5, data_format="NCHW", name=None, generator=None):
        super().__init__()
        self.p, self.data_format = p, data_format
        self.generator = generator

    def forward(self, x):
        return F.dropout2d(x, p=self.p, training=self.training,
                           data_format=self.data_format,
                           generator=self.generator)


class Dropout3D(nn.Module):
    def __init__(self, p=0.5, data_format="NCDHW", name=None,
                 generator=None):
        super().__init__()
        self.p, self.data_format = p, data_format
        self.generator = generator

    def forward(self, x):
        return F.dropout3d(x, p=self.p, training=self.training,
                           data_format=self.data_format,
                           generator=self.generator)


class AlphaDropout(nn.Module):
    def __init__(self, p=0.5, name=None, generator=None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        return F.alpha_dropout(x, p=self.p, training=self.training,
                               generator=self.generator)
