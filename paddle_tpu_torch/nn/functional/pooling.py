"""Pooling (counterpart of paddle_tpu/nn/functional/pooling.py): avg and
max pooling in 1-3 d, adaptive avg and max, `lp_pool1d/2d`,
`max_unpool1d/2d/3d` and `fractional_max_pool2d/3d`, in plain PyTorch
with the reference's rules, which are not torch's pooling argument for
argument:

- padding (`_resolve_padding`, a copy of the reference's): "SAME",
  "VALID", an int, n values, 2n values or pairs; `ceil_mode` adds pad
  on the high side until the last window starts inside it (l.53-58),
  where torch drops a window that starts in the padding;
- max pooling pads with -inf; torch's own padding is used where it is
  the same (symmetric, at most half the window), else the input is
  padded explicitly and pooled with none;
- avg pooling sums in f32 over zero padding and divides by the count of
  real elements (`exclusive`) only when some pad is non-zero, else by
  the window size (l.82-89); the result is cast back;
- `return_mask` pads symmetrically by the int `padding` alone (a string
  counts as 0), ignores `ceil_mode` and gives the flat index of the
  first maximum over the unpadded spatial axes (l.147-173);
- the adaptive bins are floor(i·in/o) to ceil((i+1)·in/o) (l.197-198),
  torch's; the adaptive max's `return_mask` is zeros (l.208-211), as in
  the reference;
- `fractional_max_pool2d/3d` take `random_u`, or draw it from
  `generator` (None: torch's default generator of the CPU), since the
  bin edges are computed on the host from it.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "fractional_max_pool2d", "fractional_max_pool3d",
    "avg_pool1d", "avg_pool2d", "avg_pool3d", "max_pool1d", "max_pool2d",
    "max_pool3d", "adaptive_avg_pool1d", "adaptive_avg_pool2d",
    "adaptive_avg_pool3d", "adaptive_max_pool1d", "adaptive_max_pool2d",
    "adaptive_max_pool3d", "lp_pool1d", "lp_pool2d", "max_unpool1d",
    "max_unpool2d", "max_unpool3d",
]


def _tup(v, n):
    if v is None:
        return None
    if isinstance(v, int):
        return (v,) * n
    v = tuple(int(x) for x in v)
    return v * n if len(v) == 1 else v


def _resolve_padding(padding, n, ksize, strides, in_spatial, ceil_mode):
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return [(0, 0)] * n
        pads = []
        for i in range(n):
            out = -(-in_spatial[i] // strides[i])
            total = max(0, (out - 1) * strides[i] + ksize[i] - in_spatial[i])
            pads.append((total // 2, total - total // 2))
        return pads
    if isinstance(padding, int):
        pads = [(padding, padding)] * n
    else:
        padding = list(padding)
        if len(padding) == n:
            pads = [(int(p), int(p)) for p in padding]
        elif len(padding) == 2 * n:
            pads = [(int(padding[2 * i]), int(padding[2 * i + 1]))
                    for i in range(n)]
        else:
            pads = [tuple(p) for p in padding]
    if ceil_mode:
        pads = [
            (lo, hi + strides[i] - 1 -
             ((in_spatial[i] + lo + hi - ksize[i]) % strides[i]))
            if (in_spatial[i] + lo + hi - ksize[i]) % strides[i] else (lo, hi)
            for i, (lo, hi) in enumerate(pads)]
    return pads


def _pad_arg(pads):
    out = []
    for lo, hi in reversed(pads):
        out += [int(lo), int(hi)]
    return out


_MAX = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _window_sum(a, ksize, strides):
    """The sum of every window of a [N, C, *spatial] (no padding)."""
    if len(ksize) == 1:
        return F.avg_pool2d(a.unsqueeze(2), (1,) + ksize, (1,) + strides,
                            divisor_override=1).squeeze(2)
    pool = F.avg_pool2d if len(ksize) == 2 else F.avg_pool3d
    return pool(a, ksize, strides, divisor_override=1)


def _pool(x, kernel_size, stride, padding, n, data_format, is_avg,
          ceil_mode=False, exclusive=True):
    cl = data_format.upper().endswith("C")
    ksize = _tup(kernel_size, n)
    strides = _tup(stride, n) if stride is not None else ksize
    a = torch.movedim(x, -1, 1) if cl else x
    in_spatial = tuple(a.shape[2:])
    pads = _resolve_padding(padding, n, ksize, strides, in_spatial,
                            ceil_mode)
    padded = any(p != (0, 0) for p in pads)
    if is_avg:
        a32 = a.float()
        summed = _window_sum(F.pad(a32, _pad_arg(pads)) if padded else a32,
                             ksize, strides)
        if exclusive and padded:
            ones = torch.ones((1, 1) + in_spatial, dtype=torch.float32,
                              device=a.device)
            out = summed / _window_sum(F.pad(ones, _pad_arg(pads)), ksize,
                                       strides)
        else:
            out = summed / float(np.prod(ksize))
        out = out.to(a.dtype)
    elif all(lo == hi and 0 <= lo <= k // 2
             for (lo, hi), k in zip(pads, ksize)):
        out = _MAX[n](a, ksize, strides, tuple(lo for lo, _ in pads))
    else:
        out = _MAX[n](F.pad(a, _pad_arg(pads), value=-math.inf), ksize,
                      strides)
    return torch.movedim(out, 1, -1) if cl else out


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    return _pool(x, kernel_size, stride, padding, 1, "NCW", True, ceil_mode,
                 exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 2, data_format, True,
                 ceil_mode, exclusive)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 3, data_format, True,
                 ceil_mode, exclusive)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    out = _pool(x, kernel_size, stride, padding, 1, "NCW", False, ceil_mode)
    if return_mask:
        return out, _pool_argmax(x, kernel_size, stride, padding, 1)
    return out


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    out = _pool(x, kernel_size, stride, padding, 2, data_format, False,
                ceil_mode)
    if return_mask:
        return out, _pool_argmax(x, kernel_size, stride, padding, 2)
    return out


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    out = _pool(x, kernel_size, stride, padding, 3, data_format, False,
                ceil_mode)
    if return_mask:
        return out, _pool_argmax(x, kernel_size, stride, padding, 3)
    return out


def _pool_argmax(x, ksize, stride, padding, n):
    """Flat indices of the maxima over the unpadded spatial axes (module
    docstring): torch's indices into the -inf-padded input, read through
    a padded map of the input's own flat indices."""
    ksize = _tup(ksize, n)
    strides = _tup(stride, n) if stride is not None else ksize
    pad = _tup(padding if not isinstance(padding, str) else 0, n)
    in_sp = tuple(x.shape[2:])
    arg = _pad_arg([(p, p) for p in pad])
    padded = F.pad(x.detach(), arg, value=-math.inf)
    flat = torch.arange(int(np.prod(in_sp)), device=x.device).reshape(in_sp)
    flat = F.pad(flat[None, None].double(), arg, value=-1.0).long()
    _, where = _MAX[n](padded, ksize, strides, return_indices=True)
    return flat.reshape(-1)[where]


def _adaptive(x, output_size, n, is_avg, return_mask=False):
    out_sp = _tup(output_size, n)
    fn = {(1, True): F.adaptive_avg_pool1d, (2, True): F.adaptive_avg_pool2d,
          (3, True): F.adaptive_avg_pool3d, (1, False): F.adaptive_max_pool1d,
          (2, False): F.adaptive_max_pool2d,
          (3, False): F.adaptive_max_pool3d}[(n, is_avg)]
    res = fn(x, out_sp[0] if n == 1 else out_sp)
    if return_mask:
        return res, torch.zeros(res.shape, dtype=torch.int64,
                                device=res.device)
    return res


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, output_size, 1, True)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive(x, output_size, 2, True)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(x, output_size, 3, True)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 1, False, return_mask)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 2, False, return_mask)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 3, False, return_mask)


def lp_pool1d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCL", name=None):
    p = float(norm_type)
    s = _pool(torch.abs(x) ** p, kernel_size, stride, padding, 1, "NCW",
              True, ceil_mode, exclusive=False)
    return (s * _tup(kernel_size, 1)[0]) ** (1.0 / p)


def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCHW", name=None):
    p = float(norm_type)
    s = _pool(torch.abs(x) ** p, kernel_size, stride, padding, 2,
              data_format, True, ceil_mode, exclusive=False)
    ks = _tup(kernel_size, 2)
    return (s * (ks[0] * ks[1])) ** (1.0 / p)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    return _unpool(x, indices, kernel_size, stride, padding, 1, output_size)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    return _unpool(x, indices, kernel_size, stride, padding, 2, output_size)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    return _unpool(x, indices, kernel_size, stride, padding, 3, output_size)


def _unpool(x, indices, kernel_size, stride, padding, n, output_size):
    """Each value written at its flat spatial index of a zero output."""
    ksize = _tup(kernel_size, n)
    strides = _tup(stride, n) if stride is not None else ksize
    pad = _tup(padding if not isinstance(padding, str) else 0, n)
    in_sp = list(x.shape[2:])
    if output_size is None:
        out_sp = [(in_sp[i] - 1) * strides[i] - 2 * pad[i] + ksize[i]
                  for i in range(n)]
    else:
        out_sp = list(_tup(output_size, n))
    lead = tuple(x.shape[:2])
    size = int(np.prod(out_sp))
    # an index past the output is dropped, as the reference's scatter
    # drops it: it lands in one extra slot, cut off after; of values
    # that share an index the last one is written (and takes the grad),
    # as XLA's scatter applies them in order
    idx = indices.reshape(*lead, -1).long()
    idx = torch.where((idx >= 0) & (idx < size), idx, size)
    order = torch.arange(idx.shape[-1], device=x.device).expand(idx.shape)
    last = torch.full(lead + (size + 1,), -1, dtype=torch.long,
                      device=x.device).scatter_reduce(2, idx, order, "amax")
    idx = torch.where(torch.gather(last, 2, idx) == order, idx, size)
    out = torch.zeros(lead + (size + 1,), dtype=x.dtype, device=x.device)
    out = out.scatter(2, idx, x.reshape(*lead, -1))
    return out[..., :size].reshape(*lead, *out_sp)


def _edges(inp, out, u):
    alpha = inp / out
    idx = np.floor(alpha * (np.arange(out) + u)).astype(np.int64)
    idx = np.clip(idx, 0, inp - 1)
    end = np.concatenate([idx[1:], [inp]])
    return idx, np.maximum(end, idx + 1)


def _fractional(x, out_sp, random_u, generator):
    """Max and the flat index of the first maximum in each pseudo-random
    bin (the reference's edges from u): every bin's window gathered at
    the largest bin's extent, the positions past its own end at -inf."""
    n = len(out_sp)
    in_sp = tuple(x.shape[2:])
    u = (float(random_u) if random_u is not None
         else float(torch.rand((), generator=generator)))
    a = x
    cols, gidx = [], []
    for i, (size, o) in enumerate(zip(in_sp, out_sp)):
        start, end = _edges(size, o, u)
        k = int((end - start).max())
        pos = start[:, None] + np.arange(k)[None, :]           # [o, k]
        valid = pos < end[:, None]
        cols.append(torch.from_numpy(np.minimum(pos, size - 1)).to(x.device))
        gidx.append((torch.from_numpy(pos).to(x.device),
                     torch.from_numpy(valid).to(x.device)))
    # gather each axis: [N, C, o1, k1, o2, k2, ...]
    for i, idx in enumerate(cols):
        ax = 2 + 2 * i
        a = torch.index_select(a, ax, idx.reshape(-1))
        a = a.reshape(*a.shape[:ax], *idx.shape, *a.shape[ax + 1:])
    ok = None
    flat = None
    for i, (pos, valid) in enumerate(gidx):
        shape = [1] * (2 * n)
        shape[2 * i], shape[2 * i + 1] = pos.shape
        v = valid.reshape(shape)
        ok = v if ok is None else ok & v
        p = pos.reshape(shape)
        flat = p if flat is None else flat * in_sp[i] + p
    perm = ([0, 1] + [2 + 2 * i for i in range(n)]
            + [3 + 2 * i for i in range(n)])
    a = torch.where(ok, a, -math.inf).permute(perm)
    flat = flat.expand(ok.shape).permute([p - 2 for p in perm[2:]])
    a = a.reshape(*a.shape[:2 + n], -1)
    out, am = a.max(dim=-1)
    mask = torch.gather(flat.reshape(*flat.shape[:n], -1).expand(
        *a.shape[:2], *flat.shape[:n], -1), -1, am[..., None])[..., 0]
    return out, mask


def fractional_max_pool2d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None, generator=None):
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    out, mask = _fractional(x, tuple(output_size), random_u, generator)
    return (out, mask) if return_mask else out


def fractional_max_pool3d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None, generator=None):
    if isinstance(output_size, int):
        output_size = (output_size,) * 3
    out, mask = _fractional(x, tuple(output_size), random_u, generator)
    return (out, mask) if return_mask else out
