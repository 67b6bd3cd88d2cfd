"""Normalization functionals (counterpart of
paddle_tpu/nn/functional/norm.py:17-205), in plain PyTorch with the
reference's float order: statistics in f32, the result cast back to the
input's dtype.

`batch_norm` in training normalises by the batch's biased variance and
updates the running statistics in place as the reference does
(l.70-100): running = momentum · running + (1 − momentum) · batch, with
paddle's momentum (0.9 keeps 90% of the old value; torch's `momentum`
is the other weight) and the unbiased batch variance. `rms_norm` is the
plain f32 form; the RMSNorm kernel (row 1) stays with the models that
call it (`kernels/rms_norm.py`).
"""
from __future__ import annotations

import torch

__all__ = ["normalize", "layer_norm", "rms_norm", "batch_norm",
           "group_norm", "instance_norm", "local_response_norm"]


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    if p == 2:
        n = torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True))
    else:
        n = torch.sum(torch.abs(x) ** p, dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp_min(n, epsilon)


def _affine(out, weight, bias, shape=None):
    if weight is not None:
        w = weight.float()
        out = out * (w if shape is None else w.reshape(shape))
    if bias is not None:
        b = bias.float()
        out = out + (b if shape is None else b.reshape(shape))
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    """Over the trailing len(normalized_shape) axes: f32 mean and biased
    variance, (x - mu) * rsqrt(var + eps) * w + b, cast back."""
    n_axes = 1 if isinstance(normalized_shape, int) else len(
        list(normalized_shape))
    dims = -1 if n_axes == 1 else tuple(range(-n_axes, 0))
    a = x.float()
    mu = a.mean(dims, keepdim=True)
    var = a.var(dims, keepdim=True, unbiased=False)
    out = (a - mu) * torch.rsqrt(var + epsilon)
    return _affine(out, weight, bias).to(x.dtype)


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    a = x.float()
    out = a * torch.rsqrt(torch.mean(a * a, dim=-1, keepdim=True) + epsilon)
    return _affine(out, weight, None).to(x.dtype)


def _channel_axis(x, data_format):
    return 1 if (data_format.startswith("NC") and x.dim() > 1) else x.dim() - 1


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    c_axis = _channel_axis(x, data_format)
    axes = tuple(i for i in range(x.dim()) if i != c_axis)
    shape = [1] * x.dim()
    shape[c_axis] = -1
    a = x.float()
    if training and use_global_stats is not True:
        mean = a.mean(axes)
        var = a.var(axes, unbiased=False)
        n = 1
        for i in axes:
            n *= x.shape[i]
        with torch.no_grad():
            if running_mean is not None:
                running_mean.copy_(
                    momentum * running_mean
                    + (1.0 - momentum) * mean.detach().to(running_mean.dtype))
            if running_var is not None:
                unbiased = var.detach() * (n / max(n - 1, 1))
                running_var.copy_(
                    momentum * running_var
                    + (1.0 - momentum) * unbiased.to(running_var.dtype))
    else:
        mean, var = running_mean.float(), running_var.float()
    out = (a - mean.reshape(shape)) * torch.rsqrt(var + epsilon).reshape(shape)
    return _affine(out, weight, bias, shape).to(x.dtype)


def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None,
               data_format="NCHW", name=None):
    cl = data_format[-1] == "C" and x.dim() > 2
    a = torch.movedim(x, -1, 1) if cl else x
    n, c = a.shape[:2]
    a32 = a.reshape(n, num_groups, c // num_groups, *a.shape[2:]).float()
    dims = tuple(range(2, a32.dim()))
    mu = a32.mean(dims, keepdim=True)
    var = a32.var(dims, keepdim=True, unbiased=False)
    out = ((a32 - mu) * torch.rsqrt(var + epsilon)).reshape(a.shape)
    shape = [1] * a.dim()
    shape[1] = -1
    out = _affine(out, weight, bias, shape).to(x.dtype)
    return torch.movedim(out, 1, -1) if cl else out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-05,
                  data_format="NCHW", name=None):
    """Per sample and channel over the spatial axes, always from the
    input's own statistics (the running ones are not read, as in the
    reference)."""
    dims = tuple(range(2, x.dim()))
    a = x.float()
    mu = a.mean(dims, keepdim=True)
    var = a.var(dims, keepdim=True, unbiased=False)
    out = (a - mu) * torch.rsqrt(var + eps)
    shape = [1, -1] + [1] * (x.dim() - 2)
    return _affine(out, weight, bias, shape).to(x.dtype)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    cl = data_format[-1] == "C"
    a = torch.movedim(x, -1, 1) if cl else x
    c = a.shape[1]
    half = size // 2
    pad = [0, 0] * (a.dim() - 2) + [half, size - half - 1]
    sqp = torch.nn.functional.pad(a * a, pad)
    acc = torch.zeros_like(a)
    for i in range(size):
        acc = acc + sqp.narrow(1, i, c)
    out = a / (k + alpha * acc) ** beta
    return torch.movedim(out, 1, -1) if cl else out
