"""Activation functionals (counterpart of
paddle_tpu/nn/functional/activation.py:27-300): every activation the
reference exports, as the same formulas in plain PyTorch, float for
float (`gelu(approximate=)` erf or tanh as the reference's).

An in-place form (`relu_`, ...) writes the activation of a copy of x
into x and returns x, so autograd sees x's new value as a function of
its old one, as the reference's `_inplace_from` rebinds it. `rrelu` in
training and `gumbel_softmax` draw from `generator` (None: the dropout
stream of x's device, `framework.core.dropout_generator`); they cannot
reproduce `jax.random`'s draws.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...framework import core

__all__ = [
    "relu", "relu_", "relu6", "elu", "elu_", "selu", "selu_", "celu",
    "celu_", "gelu", "silu", "silu_", "sigmoid_", "leaky_relu_",
    "hardswish_", "hardsigmoid_", "hardtanh_", "mish_", "softsign_",
    "thresholded_relu_", "swish", "sigmoid", "hardsigmoid", "hardswish",
    "hardtanh", "hardshrink", "softshrink", "tanhshrink", "leaky_relu",
    "prelu", "rrelu", "log_sigmoid", "maxout", "softmax", "softmax_",
    "log_softmax", "softplus", "softsign", "mish", "tanh", "tanh_",
    "thresholded_relu", "glu", "gumbel_softmax",
]


def _inplace(x, fn, *args):
    return x.copy_(fn(x.clone(), *args))


def _generator(generator, device):
    return core.dropout_generator(device) if generator is None else generator


def relu(x, name=None):
    return torch.relu(x)


def relu6(x, name=None):
    return torch.clamp(x, 0.0, 6.0)


def elu(x, alpha=1.0, name=None):
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    return torch.clamp_min(x, 0.0) + alpha * torch.expm1(
        torch.clamp_max(x, 0.0) / alpha)


def gelu(x, approximate=False, name=None):
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def silu(x, name=None):
    return x * torch.sigmoid(x)


def swish(x, name=None):
    return silu(x)


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hardswish(x, name=None):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return torch.clamp(x, min, max)


def hardshrink(x, threshold=0.5, name=None):
    return torch.where(torch.abs(x) > threshold, x, 0.0)


def softshrink(x, threshold=0.5, name=None):
    return torch.sign(x) * torch.clamp_min(torch.abs(x) - threshold, 0.0)


def tanhshrink(x, name=None):
    return x - torch.tanh(x)


def leaky_relu(x, negative_slope=0.01, name=None):
    return torch.where(x >= 0, x, negative_slope * x)


def prelu(x, weight, data_format="NCHW", name=None):
    if weight.numel() == 1:
        return torch.where(x >= 0, x, weight.reshape(()) * x)
    c_axis = 1 if data_format[1] == "C" else x.dim() - 1
    shape = [1] * x.dim()
    shape[c_axis] = -1
    return torch.where(x >= 0, x, weight.reshape(shape) * x)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=True, name=None,
          generator=None):
    """Training: each negative element scaled by its own slope, uniform
    in [lower, upper); eval: by their mean."""
    if training:
        g = _generator(generator, x.device)
        slope = torch.rand(tuple(x.shape), generator=g, device=x.device)
        slope = slope * (upper - lower) + lower
        return torch.where(x >= 0, x, slope * x)
    return torch.where(x >= 0, x, (lower + upper) / 2.0 * x)


def log_sigmoid(x, name=None):
    return TF.logsigmoid(x)


def maxout(x, groups, axis=1, name=None):
    ax = axis % x.dim()
    shape = list(x.shape)
    shape[ax:ax + 1] = [groups, shape[ax] // groups]
    return torch.amax(x.reshape(shape), dim=ax + 1)


def softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(core.convert_dtype(dtype))
    return torch.softmax(x, dim=int(axis))


def log_softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(core.convert_dtype(dtype))
    return torch.log_softmax(x, dim=int(axis))


def softplus(x, beta=1.0, threshold=20.0, name=None):
    bx = beta * x
    return torch.where(bx > threshold, x,
                       torch.logaddexp(bx, torch.zeros_like(bx)) / beta)


def softsign(x, name=None):
    return x / (1.0 + torch.abs(x))


def mish(x, name=None):
    return x * torch.tanh(torch.logaddexp(x, torch.zeros_like(x)))


def tanh(x, name=None):
    return torch.tanh(x)


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return torch.where(x > threshold, x, value)


def glu(x, axis=-1, name=None):
    a, b = torch.chunk(x, 2, dim=int(axis))
    return a * torch.sigmoid(b)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None,
                   generator=None):
    """softmax((x + g) / temperature) with g = -log(-log(u + 1e-10)), u
    uniform in [1e-10, 1); hard: the one-hot of its argmax forward, the
    soft gradient backward."""
    g = _generator(generator, x.device)
    u = torch.rand(tuple(x.shape), generator=g, device=x.device)
    u = u * (1.0 - 1e-10) + 1e-10
    noise = -torch.log(-torch.log(u + 1e-10))
    y = torch.softmax((x + noise) / temperature, dim=int(axis))
    if hard:
        idx = torch.argmax(y, dim=int(axis), keepdim=True)
        onehot = torch.zeros_like(y).scatter_(int(axis), idx, 1.0)
        return onehot + y - y.detach()
    return y


def relu_(x, name=None):
    return _inplace(x, relu)


def elu_(x, alpha=1.0, name=None):
    return _inplace(x, elu, alpha)


def selu_(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return _inplace(x, selu, scale, alpha)


def celu_(x, alpha=1.0, name=None):
    return _inplace(x, celu, alpha)


def silu_(x, name=None):
    return _inplace(x, silu)


def sigmoid_(x, name=None):
    return _inplace(x, sigmoid)


def leaky_relu_(x, negative_slope=0.01, name=None):
    return _inplace(x, leaky_relu, negative_slope)


def hardswish_(x, name=None):
    return _inplace(x, hardswish)


def hardsigmoid_(x, slope=0.1666667, offset=0.5, name=None):
    return _inplace(x, hardsigmoid, slope, offset)


def hardtanh_(x, min=-1.0, max=1.0, name=None):
    return _inplace(x, hardtanh, min, max)


def mish_(x, name=None):
    return _inplace(x, mish)


def softsign_(x, name=None):
    return _inplace(x, softsign)


def thresholded_relu_(x, threshold=1.0, name=None):
    return _inplace(x, thresholded_relu, threshold)


def softmax_(x, axis=-1, dtype=None, name=None):
    return _inplace(x, softmax, axis, dtype)


def tanh_(x, name=None):
    return _inplace(x, tanh)
