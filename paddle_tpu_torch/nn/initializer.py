"""Weight initializers (counterpart of paddle_tpu/nn/initializer.py:23-181).

Each initializer is a callable `(shape, dtype, device=None,
generator=None) -> torch.Tensor`, with the reference's fan rules
(`_fans`: [in, out] for a matrix, [out_c, in_c, *k] for a conv kernel)
and gains (`calculate_gain`). The random ones draw from `generator`
(None: torch's default generator of `device`, which
`framework.core.seed` seeds), so they cannot reproduce `jax.random`'s
draws; they follow the reference's distributions. `device` None is
`cuda` (`framework.core.resolve_device`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..framework.core import resolve_device

__all__ = [
    "Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
    "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
    "Assign", "Orthogonal", "Dirac", "calculate_gain",
]


def calculate_gain(nonlinearity, param=None):
    gains = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "conv_transpose1d": 1.0, "conv_transpose2d": 1.0,
        "conv_transpose3d": 1.0, "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(
            2.0 / (1 + (param if param is not None else 0.01) ** 2)),
        "selu": 3.0 / 4.0,
    }
    if nonlinearity not in gains:
        raise ValueError(f"unsupported nonlinearity {nonlinearity}")
    return gains[nonlinearity]


def _fans(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels: paddle layout [out_c, in_c, *k]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def _dtype(dtype):
    return torch.float32 if dtype is None else dtype


def _empty(shape, dtype, device):
    return torch.empty(tuple(shape), dtype=_dtype(dtype),
                       device=resolve_device(device))


class Initializer:
    def __call__(self, shape, dtype=None, device=None, generator=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype=None, device=None, generator=None):
        return _empty(shape, dtype, device).fill_(self.value)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=None, device=None, generator=None):
        return _empty(shape, dtype, device).normal_(self.mean, self.std,
                                                    generator=generator)


class TruncatedNormal(Initializer):
    """mean + std * a standard normal truncated to [(a - mean) / std,
    (b - mean) / std]: a and b are absolute cutoffs, as the reference's.
    Drawn by the inverse CDF from a uniform draw in f32."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype=None, device=None, generator=None):
        lo = (self.a - self.mean) / self.std
        hi = (self.b - self.mean) / self.std

        def cdf(x):
            return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))

        u = _empty(shape, torch.float32, device).uniform_(
            2 * cdf(lo) - 1, 2 * cdf(hi) - 1, generator=generator)
        z = torch.erfinv(u).mul_(math.sqrt(2.0)).clamp_(lo, hi)
        return (z * self.std + self.mean).to(_dtype(dtype))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype=None, device=None, generator=None):
        return _empty(shape, dtype, device).uniform_(self.low, self.high,
                                                     generator=generator)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=None, device=None, generator=None):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return _empty(shape, dtype, device).normal_(0.0, std,
                                                    generator=generator)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=None, device=None, generator=None):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _empty(shape, dtype, device).uniform_(-limit, limit,
                                                     generator=generator)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype=None, device=None, generator=None):
        fi, _ = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        return _empty(shape, dtype, device).normal_(
            0.0, gain / math.sqrt(fi), generator=generator)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype=None, device=None, generator=None):
        fi, _ = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fi)
        return _empty(shape, dtype, device).uniform_(-limit, limit,
                                                     generator=generator)


class Assign(Initializer):
    """The given value (a tensor, an array or a list), reshaped."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype=None, device=None, generator=None):
        v = self.value
        if not torch.is_tensor(v):
            v = torch.from_numpy(np.array(v, dtype=np.float64, order="C"))
        return v.detach().to(device=resolve_device(device),
                             dtype=_dtype(dtype)).reshape(tuple(shape))


class Orthogonal(Initializer):
    """jax.nn.initializers.orthogonal's construction: Q of the QR of a
    normal [rows, cols] draw (transposed when rows < cols), signed by
    diag(R), times gain; rows = prod(shape[:-1]), cols = shape[-1]."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype=None, device=None, generator=None):
        shape = tuple(shape)
        cols = shape[-1]
        rows = int(np.prod(shape)) // cols
        mshape = (cols, rows) if rows < cols else (rows, cols)
        a = _empty(mshape, torch.float32, device).normal_(
            generator=generator)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))[None, :]
        if rows < cols:
            q = q.T
        return (self.gain * q).reshape(shape).to(_dtype(dtype))


class Dirac(Initializer):
    """An identity-preserving conv kernel [out_c, in_c, *k]."""

    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype=None, device=None, generator=None):
        out = np.zeros(shape, dtype=np.float32)
        oc, ic = shape[0], shape[1]
        center = tuple(s // 2 for s in shape[2:])
        per = oc // self.groups
        for g in range(self.groups):
            for i in range(min(per, ic)):
                out[(g * per + i, i) + center] = 1.0
        return torch.from_numpy(out).to(device=resolve_device(device),
                                        dtype=_dtype(dtype))
