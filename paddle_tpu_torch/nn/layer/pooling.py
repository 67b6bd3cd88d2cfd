"""Pooling layers (counterpart of paddle_tpu/nn/layer/pooling.py:14-138):
avg, max, adaptive avg and max in 1-3 d, `LPPool1D/2D` and
`MaxUnPool1D/2D/3D` over `nn.functional.pooling`, keyword options
passed through (a `name` dropped). No parameters, so no device."""
from __future__ import annotations

from ..functional import pooling as F
from .layers import Layer

__all__ = ["AvgPool1D", "AvgPool2D", "AvgPool3D", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
           "AdaptiveMaxPool3D", "LPPool1D", "LPPool2D", "MaxUnPool1D",
           "MaxUnPool2D", "MaxUnPool3D"]


class _Pool(Layer):
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0, **kwargs):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.kwargs = {k: v for k, v in kwargs.items() if k != "name"}

    def forward(self, x):
        return getattr(F, self._fn)(x, self.kernel_size, self.stride,
                                    self.padding, **self.kwargs)


class AvgPool1D(_Pool):
    _fn = "avg_pool1d"


class AvgPool2D(_Pool):
    _fn = "avg_pool2d"


class AvgPool3D(_Pool):
    _fn = "avg_pool3d"


class MaxPool1D(_Pool):
    _fn = "max_pool1d"


class MaxPool2D(_Pool):
    _fn = "max_pool2d"


class MaxPool3D(_Pool):
    _fn = "max_pool3d"


class _AdaptivePool(Layer):
    _fn = None

    def __init__(self, output_size, **kwargs):
        super().__init__()
        self.output_size = output_size
        self.kwargs = {k: v for k, v in kwargs.items() if k != "name"}

    def forward(self, x):
        return getattr(F, self._fn)(x, self.output_size, **self.kwargs)


class AdaptiveAvgPool1D(_AdaptivePool):
    _fn = "adaptive_avg_pool1d"


class AdaptiveAvgPool2D(_AdaptivePool):
    _fn = "adaptive_avg_pool2d"


class AdaptiveAvgPool3D(_AdaptivePool):
    _fn = "adaptive_avg_pool3d"


class AdaptiveMaxPool1D(_AdaptivePool):
    _fn = "adaptive_max_pool1d"


class AdaptiveMaxPool2D(_AdaptivePool):
    _fn = "adaptive_max_pool2d"


class AdaptiveMaxPool3D(_AdaptivePool):
    _fn = "adaptive_max_pool3d"


class LPPool1D(Layer):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCL", name=None):
        super().__init__()
        self.args = (norm_type, kernel_size, stride, padding, ceil_mode,
                     data_format)

    def forward(self, x):
        return F.lp_pool1d(x, *self.args)


class LPPool2D(Layer):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__()
        self.args = (norm_type, kernel_size, stride, padding, ceil_mode,
                     data_format)

    def forward(self, x):
        return F.lp_pool2d(x, *self.args)


class MaxUnPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, data_format="NCL",
                 output_size=None, name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, data_format, output_size)

    def forward(self, x, indices):
        return F.max_unpool1d(x, indices, *self.args)


class MaxUnPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, data_format, output_size)

    def forward(self, x, indices):
        return F.max_unpool2d(x, indices, *self.args)


class MaxUnPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, data_format, output_size)

    def forward(self, x, indices):
        return F.max_unpool3d(x, indices, *self.args)
