"""Common functionals (counterpart of paddle_tpu/nn/functional/common.py
l.32-170 and 360-369): `linear` (x @ W + b, W [in, out]), `embedding`
(padding_idx rows zeroed, so their gradient is 0), `one_hot`,
`label_smooth`, `cosine_similarity`, `bilinear`, `unflatten`,
`pairwise_distance`, and the dropout functionals: `dropout` with `axis=`
and its two modes, `dropout2d`, `dropout3d`, `alpha_dropout` and
`feature_alpha_dropout`, float for float. The vision functionals
(`interpolate`, `pad`, `unfold` / `fold`, `pixel_shuffle`, ...) are not
ported yet.

Every mask comes from `_keep_mask(shape, p, generator, device)`: a bool
keep mask, `uniform < 1 - p` over `shape`, drawn from `generator`, or
from the dropout stream of `framework.core` (one generator per device,
seeded by `core.seed`) when it is None. The mask and the select are
plain PyTorch, as the reference's are plain jnp outside any kernel. The
draws cannot reproduce `jax.random`'s; the same generator state gives
the same masks.
"""
from __future__ import annotations

import torch

from ...framework import core

__all__ = ["unflatten", "pairwise_distance", "linear", "dropout",
           "dropout2d", "dropout3d", "alpha_dropout",
           "feature_alpha_dropout", "embedding", "one_hot", "label_smooth",
           "bilinear", "cosine_similarity"]


def linear(x, weight, bias=None, name=None):
    y = x @ weight
    return y if bias is None else y + bias


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    out = weight[x.long()]
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None], 0.0, out)
    return out


def one_hot(x, num_classes, name=None):
    return torch.nn.functional.one_hot(x.long(), num_classes).float()


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    num = torch.sum(x1 * x2, dim=axis)
    den = (torch.linalg.vector_norm(x1, dim=axis)
           * torch.linalg.vector_norm(x2, dim=axis))
    return num / torch.clamp_min(den, eps)


def bilinear(x1, x2, weight, bias=None, name=None):
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


def unflatten(x, axis, shape, name=None):
    ax = axis % x.dim()
    shape = list(shape)
    if -1 in shape:
        known = 1
        for d in shape:
            if d != -1:
                known *= d
        shape = [x.shape[ax] // known if d == -1 else d for d in shape]
    return x.reshape(list(x.shape[:ax]) + shape + list(x.shape[ax + 1:]))


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """The p-norm of x - y + epsilon over the last axis, in f32."""
    return torch.linalg.vector_norm((x - y + epsilon).float(), ord=p,
                                    dim=-1, keepdim=keepdim)


def _keep_mask(shape, p, generator, device):
    """A bool mask over `shape`, True with probability 1 - p: a uniform
    [0, 1) draw below 1 - p, from `generator` (None: the dropout stream
    on `device`)."""
    g = core.dropout_generator(device) if generator is None else generator
    return torch.rand(tuple(shape), generator=g, device=device) < 1.0 - p


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, generator=None):
    """Zero each element (or, with `axis`, each slice along the named
    axes: the mask is 1 on the other axes) with probability p.
    "upscale_in_train" scales the kept elements by 1 / (1 - p) in
    training and returns x at inference; "downscale_in_infer" keeps them
    as they are in training and returns x * (1 - p) at inference."""
    del name
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if p == 1.0:
        return x * 0.0
    shape = tuple(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        mask_shape = tuple(s if i in axes else 1 for i, s in enumerate(shape))
    else:
        mask_shape = shape
    keep = _keep_mask(mask_shape, p, generator, x.device)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
    return torch.where(keep, x, 0.0).to(x.dtype)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None,
              generator=None):
    """Whole channels of an [N, C, H, W] (or NHWC) input."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training, generator=generator)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None,
              generator=None):
    """Whole channels of an [N, C, D, H, W] (or NDHWC) input."""
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=axis, training=training, generator=generator)


_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805


def alpha_dropout(x, p=0.5, training=True, name=None, generator=None):
    """SELU's dropout: a dropped element takes -alpha * scale, then the
    affine a * x + b keeps the mean and variance."""
    del name
    if not training or p == 0.0:
        return x
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    keep = _keep_mask(x.shape, p, generator, x.device)
    a = (1.0 / ((1.0 - p) * (1.0 + p * alpha_p ** 2)) ** 0.5)
    b = -a * alpha_p * p
    return (a * torch.where(keep, x, alpha_p) + b).to(x.dtype)


feature_alpha_dropout = alpha_dropout
