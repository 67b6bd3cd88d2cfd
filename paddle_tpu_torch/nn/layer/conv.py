"""Conv layers (counterpart of paddle_tpu/nn/layer/conv.py:18-136):
`Conv1D/2D/3D` and `Conv1DTranspose/2DTranspose/3DTranspose` over
`nn.functional.conv`.

The weight is [out, in / groups, *k] ([in, out / groups, *k] for a
transpose) and the bias [out]; both default to Uniform(±1 / sqrt(fan
in)), fan in = in / groups · prod(k), drawn from the layer's
`generator` on its `device` (`cuda` unless named). `padding_mode` is
stored and not applied (every forward pads with zeros), as in the
reference (l.62-66), and a transpose's forward takes `output_size` and
ignores it.
"""
from __future__ import annotations

import math

import torch

from .. import initializer as I
from ..functional import conv as F
from .layers import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]


def _tup(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, n, transpose,
                 stride=1, padding=0, output_padding=0, dilation=1, groups=1,
                 padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format="NCHW", *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        self._n = n
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _tup(kernel_size, n)
        self.stride = stride
        self.padding = padding
        self.output_padding = output_padding
        self.dilation = dilation
        self.groups = groups
        self.padding_mode = padding_mode
        self.data_format = data_format
        self._transpose = transpose
        if transpose:
            shape = (in_channels, out_channels // groups) + self.kernel_size
        else:
            shape = (out_channels, in_channels // groups) + self.kernel_size
        fan_in = (in_channels // groups) * int(math.prod(self.kernel_size))
        std = 1.0 / math.sqrt(fan_in)
        self.weight = self.create_parameter(
            shape, attr=weight_attr,
            default_initializer=I.Uniform(-std, std))
        self.bias = (self.create_parameter(
            (out_channels,), attr=bias_attr, is_bias=True,
            default_initializer=I.Uniform(-std, std))
            if bias_attr is not False else None)

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, stride={self.stride}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL", **kw):
        super().__init__(in_channels, out_channels, kernel_size, 1, False,
                         stride, padding, 0, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, **kw)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", **kw):
        super().__init__(in_channels, out_channels, kernel_size, 2, False,
                         stride, padding, 0, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, **kw)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW", **kw):
        super().__init__(in_channels, out_channels, kernel_size, 3, False,
                         stride, padding, 0, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, **kw)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL", **kw):
        super().__init__(in_channels, out_channels, kernel_size, 1, True,
                         stride, padding, output_padding, dilation, groups,
                         "zeros", weight_attr, bias_attr, data_format, **kw)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation, output_size,
                                  self.data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW", **kw):
        super().__init__(in_channels, out_channels, kernel_size, 2, True,
                         stride, padding, output_padding, dilation, groups,
                         "zeros", weight_attr, bias_attr, data_format, **kw)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation, output_size,
                                  self.data_format)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW", **kw):
        super().__init__(in_channels, out_channels, kernel_size, 3, True,
                         stride, padding, output_padding, dilation, groups,
                         "zeros", weight_attr, bias_attr, data_format, **kw)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation, output_size,
                                  self.data_format)
