"""Vision functionals (counterpart of paddle_tpu/nn/functional/vision.py):
`affine_grid` and `grid_sample`, in plain PyTorch with the reference's
formulas.

`affine_grid` lays the base grid out with jnp.linspace's f32 terms
(corner-aligned, or pixel centres with align_corners=False) and maps it
through theta [N, 2, 3]. `grid_sample` over [N, C, H, W] with a grid
[N, Ho, Wo, 2] of (x, y) in [-1, 1]: "bilinear" weighs the four
neighbours, "nearest" rounds half to even (jnp.round); padding "zeros"
zeroes a neighbour outside the image, "border" clamps, "reflection"
reflects about the corners (align_corners) or the edges and clamps.
"""
from __future__ import annotations

import numpy as np
import torch

from .common import _linspace_f32

__all__ = ["affine_grid", "grid_sample"]


def affine_grid(theta, out_shape, align_corners=True, name=None):
    if torch.is_tensor(out_shape):
        out_shape = [int(v) for v in out_shape.reshape(-1).tolist()]
    n, c, h, w = out_shape
    if align_corners:
        xs = _linspace_f32(-1.0, 1.0, w)
        ys = _linspace_f32(-1.0, 1.0, h)
    else:
        xs = _linspace_f32(-1.0 + 1.0 / w, 1.0 - 1.0 / w, w)
        ys = _linspace_f32(-1.0 + 1.0 / h, 1.0 - 1.0 / h, h)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    base = np.stack([gx, gy, np.ones_like(gx)], axis=-1)       # [h, w, 3]
    base = torch.from_numpy(base).to(device=theta.device, dtype=theta.dtype)
    return torch.einsum("hwk,nik->nhwi", base, theta)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    n, c, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        fx = (gx + 1) * (w - 1) / 2
        fy = (gy + 1) * (h - 1) / 2
    else:
        fx = ((gx + 1) * w - 1) / 2
        fy = ((gy + 1) * h - 1) / 2
    flat = x.reshape(n, c, h * w)

    def refl(v, size):
        if align_corners:
            span = 2 * (size - 1)
            v = torch.remainder(v.abs(), span) if size > 1 else v * 0
            return torch.where(v > size - 1, span - v, v)
        span = 2 * size
        v = torch.remainder((v + 0.5).abs(), span)
        v = torch.where(v > size, span - v, v) - 0.5
        return v.clamp(0, size - 1)

    def sample(ix, iy):
        if padding_mode == "border":
            ix, iy = ix.clamp(0, w - 1), iy.clamp(0, h - 1)
            valid = None
        elif padding_mode == "reflection":
            ix, iy = refl(ix, w), refl(iy, h)
            valid = None
        else:
            valid = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
            ix, iy = ix.clamp(0, w - 1), iy.clamp(0, h - 1)
        idx = (iy.to(torch.int64) * w + ix.to(torch.int64)).reshape(n, 1, -1)
        out = torch.gather(flat, 2, idx.expand(n, c, idx.shape[-1]))
        out = out.reshape(n, c, *ix.shape[1:])
        if valid is None:
            return out
        return torch.where(valid[:, None], out, 0.0)

    if mode == "nearest":
        return sample(torch.round(fx), torch.round(fy)).to(x.dtype)
    x0, y0 = torch.floor(fx), torch.floor(fy)
    wx, wy = (fx - x0)[:, None], (fy - y0)[:, None]
    out = (sample(x0, y0) * (1 - wx) * (1 - wy)
           + sample(x0 + 1, y0) * wx * (1 - wy)
           + sample(x0, y0 + 1) * (1 - wx) * wy
           + sample(x0 + 1, y0 + 1) * wx * wy)
    return out.to(x.dtype)
