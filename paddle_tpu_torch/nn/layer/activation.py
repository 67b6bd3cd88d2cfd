"""Activation layers (counterpart of paddle_tpu/nn/layer/activation.py:
16-72): each applies `nn.functional`'s form with the arguments it was
built with, as the reference's `_mk` layers do (so `RReLU` draws its
slopes in eval too, as the reference's does); `Softmax2D` over axis -3
and `PReLU` with its learned slopes."""
from __future__ import annotations

import torch

from .. import initializer as I
from ..functional import activation as F
from .layers import Layer

__all__ = ["ReLU", "ReLU6", "ELU", "SELU", "CELU", "GELU", "Silu", "Swish",
           "Sigmoid", "Hardsigmoid", "Hardswish", "Hardtanh", "Hardshrink",
           "Softshrink", "Tanhshrink", "LeakyReLU", "PReLU", "RReLU",
           "LogSigmoid", "Maxout", "Softmax", "LogSoftmax", "Softplus",
           "Softsign", "Mish", "Tanh", "ThresholdedReLU", "GLU",
           "Softmax2D"]


def _mk(name, fname):
    def __init__(self, *args, **kwargs):
        Layer.__init__(self)
        self._args = args
        self._kwargs = {k: v for k, v in kwargs.items() if k != "name"}

    def forward(self, x):
        return getattr(F, fname)(x, *self._args, **self._kwargs)

    return type(name, (Layer,), {"__init__": __init__, "forward": forward,
                                 "__module__": __name__})


ReLU = _mk("ReLU", "relu")
ReLU6 = _mk("ReLU6", "relu6")
ELU = _mk("ELU", "elu")
SELU = _mk("SELU", "selu")
CELU = _mk("CELU", "celu")
GELU = _mk("GELU", "gelu")
Silu = _mk("Silu", "silu")
Swish = _mk("Swish", "swish")
Sigmoid = _mk("Sigmoid", "sigmoid")
Hardsigmoid = _mk("Hardsigmoid", "hardsigmoid")
Hardswish = _mk("Hardswish", "hardswish")
Hardtanh = _mk("Hardtanh", "hardtanh")
Hardshrink = _mk("Hardshrink", "hardshrink")
Softshrink = _mk("Softshrink", "softshrink")
Tanhshrink = _mk("Tanhshrink", "tanhshrink")
LeakyReLU = _mk("LeakyReLU", "leaky_relu")
RReLU = _mk("RReLU", "rrelu")
LogSigmoid = _mk("LogSigmoid", "log_sigmoid")
Maxout = _mk("Maxout", "maxout")
Softmax = _mk("Softmax", "softmax")
LogSoftmax = _mk("LogSoftmax", "log_softmax")
Softplus = _mk("Softplus", "softplus")
Softsign = _mk("Softsign", "softsign")
Mish = _mk("Mish", "mish")
Tanh = _mk("Tanh", "tanh")
ThresholdedReLU = _mk("ThresholdedReLU", "thresholded_relu")
GLU = _mk("GLU", "glu")


class Softmax2D(Layer):
    def forward(self, x):
        return F.softmax(x, axis=-3)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__(dtype=dtype, device=device)
        self._data_format = data_format
        self.weight = self.create_parameter(
            (num_parameters,), attr=weight_attr,
            default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, data_format=self._data_format)
