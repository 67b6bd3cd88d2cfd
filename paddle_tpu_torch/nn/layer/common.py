"""Common layers (counterpart of paddle_tpu/nn/layer/common.py:20-220):
`Linear`, `Embedding`, the dropout layers, `Flatten`, `Identity`,
`Bilinear` and `CosineSimilarity`, on `Layer`. `LayerNorm` lives in
`norm.py` and is re-exported here, where the models import it from.

`Linear` holds `weight` [in, out] and `bias` [out] (`x @ W + b`,
paddle's layout, so a reference state dict loads as is), made through
`create_parameter` from `weight_attr` / `bias_attr` (`ParamAttr`, a
name, an initializer, or False for no bias): the weight Xavier-uniform,
the bias zeros by default, drawn from `generator` on `device` (`cuda`
unless the caller names another). `Embedding`'s weight is Xavier-normal
with its `padding_idx` row zeroed (a negative index counts from the
end). The dropout layers (`Dropout`, `Dropout2D`, `Dropout3D`,
`AlphaDropout`) apply `nn.functional`'s forms in training mode and pass
the input through in eval (`Dropout`'s "downscale_in_infer" scales it by
1 - p there); each takes an optional `generator`, None drawing from the
dropout stream (`framework.core.dropout_generator`). The vision layers
(l.131-269: `Upsample`, `UpsamplingBilinear2D`, `UpsamplingNearest2D`,
`Pad1D/2D/3D`, `ZeroPad2D`, `Unfold`, `Fold`, `PixelShuffle`,
`PixelUnshuffle`, `ChannelShuffle`) hold their arguments and call the
functionals; they have no parameters.
"""
from __future__ import annotations

import torch

from ...ops.manipulation import pad as _pad
from .. import initializer as I
from ..functional import common as F
from .layers import Layer
from .norm import LayerNorm

__all__ = ["Linear", "Embedding", "Dropout", "Dropout2D", "Dropout3D",
           "AlphaDropout", "Flatten", "Identity", "Bilinear",
           "CosineSimilarity", "LayerNorm", "Upsample",
           "UpsamplingBilinear2D", "UpsamplingNearest2D", "Pad1D", "Pad2D",
           "Pad3D", "ZeroPad2D", "Unfold", "Fold", "PixelShuffle",
           "PixelUnshuffle", "ChannelShuffle"]


class Linear(Layer):
    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        self.in_features, self.out_features = in_features, out_features
        self.weight = self.create_parameter((in_features, out_features),
                                            attr=weight_attr)
        self.bias = (self.create_parameter((out_features,), attr=bias_attr,
                                           is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = (padding_idx if padding_idx is None
                            or padding_idx >= 0
                            else num_embeddings + padding_idx)
        self.weight = self.create_parameter(
            (num_embeddings, embedding_dim), attr=weight_attr,
            default_initializer=I.XavierNormal())
        if self.padding_idx is not None:
            with torch.no_grad():
                self.weight[self.padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self.padding_idx)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Dropout(Layer):
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


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None, generator=None):
        super().__init__()
        self.p, self.data_format = p, data_format
        self.generator = generator

    def forward(self, x):
        return F.dropout2d(x, p=self.p, training=self.training,
                           data_format=self.data_format,
                           generator=self.generator)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None,
                 generator=None):
        super().__init__()
        self.p, self.data_format = p, data_format
        self.generator = generator

    def forward(self, x):
        return F.dropout3d(x, p=self.p, training=self.training,
                           data_format=self.data_format,
                           generator=self.generator)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None, generator=None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        return F.alpha_dropout(x, p=self.p, training=self.training,
                               generator=self.generator)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Bilinear(Layer):
    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        self.weight = self.create_parameter(
            (out_features, in1_features, in2_features), attr=weight_attr)
        self.bias = (self.create_parameter((1, out_features), attr=bias_attr,
                                           is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format=None,
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0, data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0, data_format)


class _PadN(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return _pad(x, self.padding, mode=self.mode, value=self.value,
                    data_format=self.data_format)


class Pad1D(_PadN):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCL",
                 name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadN):
    pass


class Pad3D(_PadN):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(_PadN):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes = output_sizes
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.fold(x, self.output_sizes, *self.args)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups = groups
        self.data_format = data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)
