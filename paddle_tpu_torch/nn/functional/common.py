"""Common functionals (counterpart of paddle_tpu/nn/functional/common.py
l.32-170 and 360-369): `linear` (x @ W + b, W [in, out]), `embedding`
(padding_idx rows zeroed, so their gradient is 0), `one_hot`,
`label_smooth`, `cosine_similarity`, `bilinear`, `unflatten`,
`pairwise_distance`, and the dropout functionals: `dropout` with `axis=`
and its two modes, `dropout2d`, `dropout3d`, `alpha_dropout` and
`feature_alpha_dropout`, float for float, and the image functionals
(l.164-352): `interpolate` / `upsample`, `pixel_shuffle`,
`pixel_unshuffle`, `channel_shuffle`, `unfold`, `fold` and `zeropad2d`
(over `ops.manipulation.pad`).

`interpolate` is the reference's, not `F.interpolate`'s: "nearest" is
`jax.image.resize`'s nearest (source index floor((i + 0.5) · in / out)
in f32, half-pixel centres: torch's "nearest-exact", not its
"nearest"); the linear family at align_corners=False, align_mode=0 and
"bicubic" there are `jax.image.resize`'s "linear" and "cubic" (Keys, a =
-0.5), both antialiased when they downscale, built as one [in, out]
resampling matrix per axis the way `jax.image.scale_and_translate`
builds it (`_resize_matrix`) and applied one axis at a time; "area" maps
to "linear" (l.164-167). align_corners=True (any mode but nearest) and
align_mode=1 (the linear family) are the reference's explicit two-tap
gathers (l.206-226).

Every mask comes from `_keep_mask(shape, p, generator, device)`: a bool
keep mask, `uniform < 1 - p` over `shape`, drawn from `generator`, or
from the dropout stream of `framework.core` (one generator per device,
seeded by `core.seed`) when it is None. The mask and the select are
plain PyTorch, as the reference's are plain jnp outside any kernel. The
draws cannot reproduce `jax.random`'s; the same generator state gives
the same masks.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...framework import core
from ...ops.manipulation import pad as _pad

__all__ = ["unflatten", "pairwise_distance", "linear", "dropout",
           "dropout2d", "dropout3d", "alpha_dropout",
           "feature_alpha_dropout", "embedding", "one_hot", "label_smooth",
           "interpolate", "upsample", "bilinear", "cosine_similarity",
           "pixel_shuffle", "pixel_unshuffle", "channel_shuffle", "unfold",
           "fold", "zeropad2d"]


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


# --------------------------------------------------------------------------
# interpolate (the reference's l.164-235 over jax.image.resize)
# --------------------------------------------------------------------------

_MODES = {
    "nearest": "nearest", "bilinear": "linear", "trilinear": "linear",
    "linear": "linear", "bicubic": "cubic", "area": "linear",
}


def _triangle(x):
    return np.maximum(np.float32(0), np.float32(1) - np.abs(x))


def _keys_cubic(x):
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1)
    out = np.where(x >= 1, ((np.float32(-0.5) * x + np.float32(2.5)) * x
                            - np.float32(4)) * x + np.float32(2), out)
    return np.where(x >= 2, np.float32(0), out).astype(np.float32)


def _resize_matrix(n_in, n_out, method):
    """The [n_in, n_out] f32 weights `jax.image.resize` contracts an
    axis with (`compute_weight_mat`, antialiased, translation 0)."""
    f32 = np.float32
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * f32(inv_scale) \
        - f32(0.0) - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    w = (_triangle if method == "linear" else _keys_cubic)(x.astype(f32))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def _nearest_index(n_in, n_out):
    f32 = np.float32
    off = (np.arange(n_out, dtype=f32) + f32(0.5)) * f32(n_in) / f32(n_out)
    return np.floor(off.astype(f32)).astype(np.int64)


def _linspace_f32(start, stop, num):
    """jnp.linspace(start, stop, num) in f32, term for term."""
    f32 = np.float32
    if num == 1:
        return np.array([start], f32)
    div = num - 1
    step = np.arange(div, dtype=f32) / f32(div)
    out = f32(start) * (f32(1) - step) + f32(stop) * step
    return np.concatenate([out, [f32(stop)]]).astype(f32)


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format=None,
                name=None):
    nd = x.dim()
    if data_format is None:
        data_format = {3: "NCW", 4: "NCHW", 5: "NCDHW"}[nd]
    channels_last = data_format[-1] == "C"
    spatial = (list(range(1, nd - 1)) if channels_last
               else list(range(2, nd)))
    in_sp = [x.shape[a] for a in spatial]
    if size is not None:
        if torch.is_tensor(size):
            size = [int(v) for v in size.reshape(-1).tolist()]
        out_sp = [int(s) for s in (size if isinstance(size, (list, tuple))
                                   else [size])]
    else:
        sf = (scale_factor if isinstance(scale_factor, (list, tuple))
              else [scale_factor] * len(in_sp))
        out_sp = [int(np.floor(d * float(f))) for d, f in zip(in_sp, sf)]
    method = _MODES[mode]
    asym = (align_mode == 1 and not align_corners
            and mode in ("linear", "bilinear", "trilinear"))
    out = x
    if mode == "nearest" or (not align_corners and not asym):
        for ax, n_in, n_out in zip(spatial, in_sp, out_sp):
            if n_in == n_out:
                continue
            if method == "nearest":
                idx = torch.from_numpy(_nearest_index(n_in, n_out))
                out = torch.index_select(out, ax, idx.to(x.device))
            else:
                w = torch.from_numpy(_resize_matrix(n_in, n_out, method))
                w = w.to(device=x.device, dtype=x.dtype)
                out = torch.movedim(torch.movedim(out, ax, -1) @ w, -1, ax)
        return out
    for ax, n_in, n_out in zip(spatial, in_sp, out_sp):
        if n_out == 1 or n_in == 1:
            idx = np.zeros((n_out,), np.float32)
        elif asym:
            idx = np.minimum(np.arange(n_out, dtype=np.float32)
                             * np.float32(n_in / float(n_out)),
                             np.float32(n_in - 1.0))
        else:
            idx = _linspace_f32(0.0, n_in - 1.0, n_out)
        lo = np.floor(idx).astype(np.int64)
        hi = np.minimum(lo + 1, n_in - 1)
        shape = [1] * out.dim()
        shape[ax] = -1
        w = torch.from_numpy((idx - lo).astype(np.float32)).to(
            device=x.device, dtype=x.dtype).reshape(shape)
        take_lo = torch.index_select(out, ax, torch.from_numpy(lo).to(
            x.device))
        take_hi = torch.index_select(out, ax, torch.from_numpy(hi).to(
            x.device))
        out = take_lo * (1 - w) + take_hi * w
    return out


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format=None, name=None):
    return interpolate(x, size, scale_factor, mode, align_corners, align_mode,
                       data_format)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        a = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return a.reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = x.shape
    a = x.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return a.reshape(n, h * r, w * r, c // (r * r))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = downscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        a = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
        return a.reshape(n, c * r * r, h // r, w // r)
    n, h, w, c = x.shape
    a = x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
    return a.reshape(n, h // r, w // r, c * r * r)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    if data_format == "NCHW":
        n, c, h, w = x.shape
        a = x.reshape(n, groups, c // groups, h, w).permute(0, 2, 1, 3, 4)
        return a.reshape(n, c, h, w)
    n, h, w, c = x.shape
    a = x.reshape(n, h, w, groups, c // groups).permute(0, 1, 2, 4, 3)
    return a.reshape(n, h, w, c)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _pads4(paddings):
    """(top, bottom, left, right) from an int, (h, w) or four values."""
    if isinstance(paddings, int):
        return (paddings,) * 4
    if len(paddings) == 2:
        return (paddings[0], paddings[0], paddings[1], paddings[1])
    return tuple(paddings)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col of [N, C, H, W] -> [N, C·kh·kw, L], C major."""
    t, b, l, r = _pads4(paddings)
    a = F.pad(x, [l, r, t, b])
    return F.unfold(a, _pair(kernel_sizes), dilation=_pair(dilations),
                    stride=_pair(strides))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im: the windows summed into the padded output, then cropped."""
    oh, ow = _pair(output_sizes)
    t, b, l, r = _pads4(paddings)
    out = F.fold(x, (oh + t + b, ow + l + r), _pair(kernel_sizes),
                 dilation=_pair(dilations), stride=_pair(strides))
    return out[:, :, t:oh + t, l:ow + l]


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return _pad(x, padding, mode="constant", value=0.0,
                data_format=data_format)
