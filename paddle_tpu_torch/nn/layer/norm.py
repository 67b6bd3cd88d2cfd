"""Norm layers (counterpart of paddle_tpu/nn/layer/norm.py:18-247):
`BatchNorm` / `1D` / `2D` / `3D` (running statistics in the buffers
`_mean` and `_variance` under paddle's momentum: `nn.functional.norm`),
`LayerNorm` (f32 statistics; `weight` ones, `bias` zeros), `RMSNorm`,
`GroupNorm`, `InstanceNorm1D/2D/3D` (parameters `scale` and `bias`, as
the reference names them) and `LocalResponseNorm`. Parameters and
buffers are made on `device` (`cuda` unless the caller names another).

`SyncBatchNorm` (cross-replica statistics, ROADMAP Queue 1 item 12) and
`SpectralNorm` are not ported: building one raises NotImplementedError.
"""
from __future__ import annotations

import torch

from .. import initializer as I
from ..functional import norm as F
from .layers import Layer

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "LayerNorm", "RMSNorm", "GroupNorm",
           "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D",
           "LocalResponseNorm", "SpectralNorm"]


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__(dtype=dtype, device=device)
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = (self.create_parameter(
            (num_features,), attr=weight_attr,
            default_initializer=I.Constant(1.0))
            if weight_attr is not False else None)
        self.bias = (self.create_parameter((num_features,), attr=bias_attr,
                                           is_bias=True)
                     if bias_attr is not False else None)
        dev = self._param_device()
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance",
                             torch.ones(num_features, device=dev))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}")


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None, **kw):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, "NCHW" if data_format == "NCL" else "NHWC",
                         use_global_stats, **kw)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None, **kw):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr,
                         "NCHW" if data_format == "NCDHW" else "NHWC",
                         use_global_stats, **kw)


class SyncBatchNorm(_BatchNormBase):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "SyncBatchNorm is not ported yet (cross-replica statistics "
            "come with distributed training)")

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        raise NotImplementedError("SyncBatchNorm is not ported yet")


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__(dtype=dtype, device=device)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = (self.create_parameter(
            self._normalized_shape, attr=weight_attr,
            default_initializer=I.Constant(1.0))
            if weight_attr is not False else None)
        self.bias = (self.create_parameter(self._normalized_shape,
                                           attr=bias_attr, is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__(dtype=dtype, device=device)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            (hidden_size,), attr=weight_attr,
            default_initializer=I.Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__(dtype=dtype, device=device)
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = (self.create_parameter(
            (num_channels,), attr=weight_attr,
            default_initializer=I.Constant(1.0))
            if weight_attr is not False else None)
        self.bias = (self.create_parameter((num_channels,), attr=bias_attr,
                                           is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__(dtype=dtype, device=device)
        self._epsilon = epsilon
        self.scale = (self.create_parameter(
            (num_features,), attr=weight_attr,
            default_initializer=I.Constant(1.0))
            if weight_attr is not False else None)
        self.bias = (self.create_parameter((num_features,), attr=bias_attr,
                                           is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, x):
        return F.instance_norm(x, weight=self.scale, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=0.0001, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self.args)


class SpectralNorm(Layer):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError("SpectralNorm is not ported yet")
