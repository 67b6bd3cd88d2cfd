"""RMSNorm (counterpart of paddle_tpu/kernels/rms_norm.py).

`rms_norm(x, weight, eps)` launches the hand-written CUDA kernel
(`csrc/rms_norm.cu`) for a CUDA tensor and runs `_plain` — exactly the
reference's jnp expression (rms_norm.py:36-39) — for a CPU tensor. A
CUDA tensor the kernel cannot take raises; nothing falls back.

Where a gradient is wanted (grad mode on and x or the weight requiring
grad) both routes sit inside one `torch.autograd.Function` whose
backward is the reference's analytic formula (`_rms_bwd`, rms_norm.py:
71-82) in plain PyTorch, as the reference's backward is plain jnp: dx in
x's dtype, dw in the weight's (f32 for the model's norms). Otherwise
(the serving and decode steps run under `torch.no_grad`) the call takes
the lean route: the launch alone, with the kernel's geometry from
`plan` (worked out once a shape), the model's own f32 contiguous weight used as
it is, no device switch when x lies on the current device, and the
library handle read without its lock once loaded.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build

__all__ = ["rms_norm", "supported", "plan", "Plan"]

SMS = 132                  # the H100's streaming multiprocessors
_MAX_VPT = 4               # 16-byte vectors a lane holds in registers
_MAX_WARPS = 24            # a block of at most 768 threads (the kernel's
#                            __launch_bounds__: 80 registers a thread)
# threads an SM keeps resident at that register cap, and blocks an SM
# takes at most
_SM_THREADS = 768
_SM_BLOCKS = 32
# a plan whose rows give fewer warps than this an SM spreads each row
# over more warps (down to one vector a lane)
_SPREAD_WARPS = 8
_SMEM_BYTES = 2 * _MAX_WARPS * 4      # the kernel's static partials
_MAX_ROW_BYTES = 32 * _MAX_WARPS * _MAX_VPT * 16    # 48 KB


class Plan(NamedTuple):
    """The kernel's geometry for one (rows, H, dtype): `wpr` warps a row,
    `rpb` rows a block, `vpt` 16-byte vectors a lane (1, 2 or 4), `grid`
    blocks (persistent: each walks the row groups g, g + grid, ...),
    `threads` a block, `per_sm` blocks an SM holds at once and `smem`
    bytes of shared memory a block."""
    wpr: int
    rpb: int
    vpt: int
    grid: int
    threads: int
    per_sm: int
    smem: int


def supported(x_shape, dtype) -> bool:
    """Shapes/dtypes the kernel takes: a bf16/f32 row of H % 8 == 0
    elements of at most 48 KB (24 warps of lanes holding 4 vectors)."""
    H = int(x_shape[-1])
    return (dtype in (torch.bfloat16, torch.float32) and H % 8 == 0
            and 0 < H * torch.finfo(dtype).bits // 8 <= _MAX_ROW_BYTES)


def plan(rows: int, H: int, dtype) -> Plan:
    """The kernel's geometry (pure Python; the CPU tests check it). A row
    of nvec vectors takes the fewest warps that keep a lane at most 4
    vectors; while the rows give fewer than 8 warps an SM, each row is
    spread over twice the warps (decode's 4 rows of 4096 bf16: 16 warps,
    one vector a lane). Blocks hold up to 8 warps of rows, and the grid
    is the card's SMs times the blocks an SM keeps resident, or fewer
    when the rows run out first."""
    nvec = H * (torch.finfo(dtype).bits // 8) // 16
    wpr = -(-nvec // (32 * _MAX_VPT))
    while (rows * wpr < SMS * _SPREAD_WARPS and 2 * wpr <= _MAX_WARPS
           and 64 * wpr <= nvec):
        wpr *= 2
    vpt = -(-nvec // (32 * wpr))
    vpt = 1 if vpt <= 1 else (2 if vpt == 2 else 4)
    rpb = max(1, min(8 // wpr, -(-rows // SMS)))
    threads = 32 * wpr * rpb
    per_sm = min(_SM_BLOCKS, _SM_THREADS // threads)
    grid = max(1, min(-(-rows // rpb), SMS * per_sm))
    return Plan(wpr, rpb, vpt, grid, threads, per_sm, _SMEM_BYTES)


def _plain(x, weight, eps):
    x32 = x.float()
    ms = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps) * weight.float()).to(x.dtype)


def _bwd(x, weight, g, eps):
    """The reference's `_rms_bwd`: dx = r*(g*w) - x*r^3/H*sum(g*w*x),
    dw = sum_rows(g*x*r), f32 math."""
    H = x.shape[-1]
    x32 = x.float()
    g32 = g.float()
    w32 = weight.float()
    r = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    gw = g32 * w32
    dx = r * gw - x32 * (r ** 3) * torch.sum(gw * x32, dim=-1,
                                            keepdim=True) / H
    dw = torch.sum((g32 * x32 * r).reshape(-1, H), dim=0)
    return dx.to(x.dtype), dw.to(weight.dtype)


def _aligned(t):
    """Contiguous with a 16-byte aligned base: the kernel moves rows and
    the weight in 16-byte vectors."""
    if not t.is_contiguous():
        t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


# (x shape, dtype, weight shape) -> (rows, H, the plan's geometry): what a
# CUDA call of that shape launches, checked once (`_launch`)
_SHAPES = {}


def _launch(x, weight, eps, geo=None):
    if geo is None:
        H = x.shape[-1]
        rows = x.numel() // H
        p = plan(rows, H, x.dtype)
        geo = _SHAPES[(x.shape, x.dtype, weight.shape)] = (
            rows, H, p.wpr, p.rpb, p.vpt, p.grid)
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = _aligned(x)
    w = weight
    if w.dtype != torch.float32 or w.device != x.device:
        w = w.to(device=x.device, dtype=torch.float32)
    if not w.is_contiguous() or w.data_ptr() % 16:
        w = _aligned(w)
    y = torch.empty_like(x)
    lib = _build._lib or _build.library()
    fn = (lib.ptt_rms_norm_bf16 if x.dtype == torch.bfloat16
          else lib.ptt_rms_norm_f32)
    index = x.get_device()
    # the raw current stream by PyTorch's own fast accessor
    if index == torch.cuda.current_device():
        err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), *geo[:2],
                 float(eps), *geo[2:],
                 torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), *geo[:2],
                     float(eps), *geo[2:],
                     torch._C._cuda_getCurrentRawStream(index))
    if err:
        _build.check(err, "rms_norm")
    rms_norm.launches += 1
    return y


class _RmsNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        if x.device.type == "cpu":
            return _plain(x, weight, eps)
        return _launch(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = _bwd(x, weight, g, ctx.eps)
        return dx, dw, None


def rms_norm(x, weight, eps=1e-6, use_kernel=None):
    """x: [..., H]; weight: [H] (f32). Returns x.dtype.

    use_kernel=None routes by device (kernel on CUDA, plain on CPU);
    True demands the kernel and raises ValueError for a CPU tensor or a
    shape/dtype the kernel does not take."""
    lean = not (torch.is_grad_enabled()
                and (x.requires_grad or weight.requires_grad))
    if lean and x.is_cuda:
        geo = _SHAPES.get((x.shape, x.dtype, weight.shape))
        if geo is not None:                # a shape already checked
            return _launch(x, weight, eps, geo)
    ok = supported(x.shape, x.dtype) and weight.shape == x.shape[-1:]
    if use_kernel and not ok:
        raise ValueError(
            f"rms_norm: use_kernel=True but the kernel does not take x "
            f"{tuple(x.shape)} {x.dtype}, weight {tuple(weight.shape)} "
            f"(need bf16/f32, H % 8 == 0, H * itemsize <= "
            f"{_MAX_ROW_BYTES})")
    cpu = x.device.type == "cpu"
    if cpu:
        if use_kernel:
            raise ValueError("rms_norm: use_kernel=True needs a CUDA tensor")
    elif not ok:
        raise ValueError(
            f"rms_norm: no kernel for x {tuple(x.shape)} {x.dtype}")
    if not lean:
        return _RmsNorm.apply(x, weight, eps)
    return _plain(x, weight, eps) if cpu else _launch(x, weight, eps)


rms_norm.launches = 0
