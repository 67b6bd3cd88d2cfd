"""Weight-only int8 linear, W8A16 (no Pallas counterpart: the reference
dequantizes in the serving step's trace and XLA fuses the convert and
the scale into the dot's operand read, paddle_tpu/inference/
serving.py:263-268; paddle_tpu/incubate/nn/functional/__init__.py:352).

`weight_only_linear(a, q, scale)` = a @ deq(q) with q int8 [K, N] in the
[in, out] layout and deq(q)[k, n] = f32(q[k, n]) * s[k // group, n]
rounded once to a's dtype. `scale` is per column ([N] or [1, N]), per
tensor (one value) or per group ([K / group, N]). `swiglu=True` reads q as
[Qg | Qu] [K, 2M] and returns silu(a @ deq(Qg)) * (a @ deq(Qu)) [.., M].

A CUDA tensor launches the hand-written kernel in
`csrc/weight_only_linear.cu` (bf16 or f16 activations, f32 scales; the
int8 bytes are read once and no dequantized weight is stored) with the
geometry of `plan`; a CPU tensor runs `_plain`: the dequantized weight
in the same float order, then the product (and for SwiGLU the unfused
expression of `kernels/swiglu.py::_ref`), which is what the reference
computes on the CPU. On the card a scale layout or dtype the kernel
does not take raises; nothing falls back to the plain route.

`plan(M, K, N, swiglu)` is the kernel's split-K schedule: S splits of
whole 64-row K steps, S and their boundaries a function of (K, N,
epilogue) alone, merged in split order in f32 (through scratch at up to
128 rows, in registers above), so a row's sum does not depend on M.
`split_plain` is that schedule in plain PyTorch, for the CPU tests.

`QuantWeight` is the (int8, scale) pair of the serving state
(`inference.serving.quantize_state_int8`); `matmul(a, w)` is a @ w for
a tensor and this kernel for a `QuantWeight`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build, _paged_split
from . import swiglu as ksw

__all__ = ["QuantWeight", "Plan", "plan", "route_switches", "dequantize",
           "matmul", "split_plain", "supported", "weight_only_linear"]

# the kernel's K step: a scale group must hold whole steps
_TK = 64
# int8 columns of the kernel's column tile (plain: 128 outputs; SwiGLU:
# 64 gate and the same 64 up columns)
_TQ = 128
# the H100's SMs: `plan` sizes the splits and the persistent grid to them
# (two blocks an SM at n = 8, one above: the kernel's Geo::BPS)
SMS = 132
# a split holds at least this many K steps, and there are at most
# _MAX_SPLITS (the kernel's merge loads every split's share at once)
_MIN_SPLIT_STEPS = 8
_MAX_SPLITS = 4
# a split merge's cost in K steps of a 128-row product: o at 128 rows
# (4 splits of 16 steps) read 0.0229 ms where the unsplit 128-row
# products run 0.75 us a step, so about 10 us a merge (H100,
# chip_smoke.py's row-14 phase)
_MERGE_STEPS = 13
# the products' N (the rows a block serves): the least that holds the
# rows, row groups of 128 above
_ROW_GROUPS = (8, 32, 64, 128)
# at most 128 rows (the ragged step's T_pack) merge split partials
# through f32 scratch, which stays under a bf16 o_proj's bytes there
# (chip_smoke.py phase 6d's gate on a step's memory growth)
_SCRATCH_ROWS = 128
_SCRATCH_BYTES = 4096 * 4096 * 2


class QuantWeight(NamedTuple):
    """An int8 weight [K, N] in the [in, out] layout and its f32 scale
    (per column [1, N] from the serving rule)."""
    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.q.shape

    def columns(self, start, stop):
        """Columns [start, stop) of the weight: codes and their scales
        (per-column scales follow their columns)."""
        s = self.scale
        if s.numel() > 1:
            s = s[..., start:stop]
        return QuantWeight(self.q[:, start:stop], s)

    @staticmethod
    def cat(parts):
        """Column concatenation of per-column quantized weights: equal to
        quantizing the concatenated weight, since each column's scale is
        its own."""
        return QuantWeight(torch.cat([p.q for p in parts], dim=-1),
                           torch.cat([p.scale.reshape(1, -1)
                                      for p in parts], dim=-1))


def _scale_layout(q_shape, s_shape):
    """(group, row stride, column stride) of the scale of a [K, N]
    weight, or None for a layout no route takes."""
    K, N = int(q_shape[0]), int(q_shape[1])
    numel = 1
    for d in s_shape:
        numel *= int(d)
    if numel == 1:
        return max(K, 1), 0, 0
    if tuple(s_shape) in ((N,), (1, N)):
        return max(K, 1), 0, 1
    if (len(s_shape) == 2 and int(s_shape[1]) == N and int(s_shape[0]) > 1
            and K % int(s_shape[0]) == 0):
        return K // int(s_shape[0]), N, 1
    return None


def supported(a_shape, q_shape, scale_shape, dtype=torch.bfloat16,
              swiglu=False, bias=None) -> bool:
    """Whether the kernel takes a [..., K] in `dtype` against an int8
    [K, N] weight with this scale: bf16 or f16, a per-column, per-tensor
    or per-group scale whose groups hold whole 64-row steps, an even N
    for SwiGLU, a bias [N] in a's dtype (plain epilogue only)."""
    if (len(q_shape) != 2 or int(a_shape[-1]) != int(q_shape[0])
            or int(q_shape[0]) == 0):
        return False
    lay = _scale_layout(q_shape, scale_shape)
    if lay is None or dtype not in (torch.bfloat16, torch.float16):
        return False
    if lay[1] != 0 and lay[0] % _TK:
        return False
    if swiglu and (int(q_shape[1]) % 2 or bias is not None):
        return False
    return bias is None or (bias.dtype == dtype
                            and tuple(bias.shape) == (int(q_shape[1]),))


class Plan(NamedTuple):
    """The kernel's geometry for one (M, K, N, epilogue): `splits` S,
    `bounds` the first K step of each split and then the step count
    (split z covers steps [bounds[z], bounds[z + 1])), `route` ("direct":
    one split, the epilogue from the accumulators; "scratch": a block a
    split, the f32 partials merged by the tile's last block; "owned": a
    block owns all S splits of its tile and merges them in registers),
    `n` the products' N (rows a block serves), `tiles` column tiles,
    `row_groups` of n rows, `units` of work, `grid` persistent blocks
    (two an SM at n = 8), `scratch` f32 elements and `tickets`."""
    splits: int
    bounds: tuple
    route: str
    n: int
    tiles: int
    row_groups: int
    units: int
    grid: int
    scratch: int
    tickets: int


def _splits(K, tiles):
    """S from K and the column tiles alone: the fewest splits that come
    within 5% of the least cost, a unit's K steps plus, with splits, the
    merge's (_MERGE_STEPS: the partials written, the ticket and the last
    block's read of every split, measured at 128 rows), times the rounds
    of SMS units the persistent grid runs; each split of at least
    _MIN_SPLIT_STEPS steps and the scratch at _SCRATCH_ROWS rows under
    _SCRATCH_BYTES."""
    steps = -(-K // _TK)
    best, best_t = 1, float(-(-tiles // SMS) * steps)
    for S in range(2, min(_MAX_SPLITS, steps // _MIN_SPLIT_STEPS) + 1):
        if 4 * S * _SCRATCH_ROWS * tiles * _TQ >= _SCRATCH_BYTES:
            break
        t = -(-tiles * S // SMS) * (steps / S + _MERGE_STEPS)
        if t < 0.95 * best_t:
            best, best_t = S, t
    return best


def plan(M, K, N, swiglu=False) -> Plan:
    """The kernel's split-K schedule and grid for a [M, K] @ [K, N]
    product (SwiGLU: N int8 columns, N / 2 outputs); pure Python, checked
    by the CPU tests. S and the split boundaries depend on (K, N, swiglu)
    only, never on M, so row i of an M-row product is bitwise the 1-row
    product of row i (llama_7b: o and down S = 4, qkv, the SwiGLU product
    and the lm head 1)."""
    tiles = -(-(N // 2) // 64) if swiglu else -(-N // _TQ)
    steps = -(-K // _TK)
    S = _splits(K, tiles)
    bounds = tuple(z * steps // S for z in range(S + 1))
    n = next((g for g in _ROW_GROUPS if M <= g), _ROW_GROUPS[-1])
    row_groups = -(-M // n)
    route = ("direct" if S == 1 else
             "scratch" if M <= _SCRATCH_ROWS else "owned")
    units = tiles * S if route == "scratch" else tiles * row_groups
    # each split's partial: the tile's n x 128 f32 accumulators
    scratch = S * tiles * n * _TQ if route == "scratch" else 0
    return Plan(S, bounds, route, n, tiles, row_groups, units,
                min(units, SMS * (2 if n == 8 else 1)), scratch,
                tiles if route == "scratch" else 0)


def route_switches(K, N, swiglu=False, rows=512):
    """The row counts M in [1, rows) at which `plan` changes route or the
    products' N, or goes from one row group to several, between M and
    M + 1: both sides of each are where the card checks that rows stay
    independent."""
    def key(M):
        p = plan(M, K, N, swiglu)
        return p.route, p.n, min(p.row_groups, 2)
    return [M for M in range(1, rows) if key(M) != key(M + 1)]


def dequantize(q, scale, dtype):
    """The dequantized weight [K, N] in `dtype`: f32 codes times the f32
    scale, rounded once (the serving engine's order,
    quantization.comm.dequantize_channelwise). A group scale [K / g, N]
    expands over its g rows."""
    if scale.dim() == 2 and scale.shape[0] > 1:
        K, N = q.shape
        G = scale.shape[0]
        qg = q.reshape(G, K // G, N)
        return (qg.float() * scale.float()[:, None, :]).reshape(K, N).to(dtype)
    return (q.float() * scale.float()).to(dtype)


def _plain(a, q, scale, bias, swiglu):
    w = dequantize(q, scale, a.dtype)
    if swiglu:
        return ksw._ref(a, w)
    out = a @ w
    return out if bias is None else out + bias


def split_plain(a, q, scale, bias=None, swiglu=False):
    """The kernel's arithmetic schedule in plain PyTorch: the dequantized
    weight in a's dtype, each split of `plan`'s boundaries summed from
    zero in f32, the partials added in split order in f32, then the
    epilogue (the product rounded to a's dtype, then the bias added and
    rounded; SwiGLU: silu(g) * u of the f32 sums, rounded once)."""
    K, N = int(q.shape[0]), int(q.shape[1])
    af = a.reshape(-1, K).float()
    w = dequantize(q, scale, a.dtype).float()
    p = plan(af.shape[0], K, N, swiglu)
    total = None
    for z in range(p.splits):
        k0, k1 = _TK * p.bounds[z], min(K, _TK * p.bounds[z + 1])
        part = af[:, k0:k1] @ w[k0:k1]
        total = part if total is None else total + part
    if swiglu:
        g, u = total[:, :N // 2], total[:, N // 2:]
        out = (g / (1.0 + torch.exp(-g)) * u).to(a.dtype)
    else:
        out = total.to(a.dtype)
        if bias is not None:
            out = (out.float() + bias.float()).to(a.dtype)
    return out.reshape(*a.shape[:-1], out.shape[-1])


# (a, q, scale, bias and epilogue signature) -> what a CUDA call of that
# signature launches, checked once (`_launch`): (M, output columns, the
# C entries' int64 geometry [M, K, Nv, group, s_rs, s_cs, S, n, grid] and
# its address, tickets, scratch floats)
_SHAPES = {}


def _key(a, q, scale, bias, swiglu):
    return (a.shape, a.dtype, a.get_device(), q.shape, q.dtype,
            q.get_device(), scale.shape, swiglu,
            None if bias is None else (bias.shape, bias.dtype,
                                       bias.get_device()))


def _geometry(a, q, scale, swiglu):
    K, N = int(q.shape[0]), int(q.shape[1])
    group, s_rs, s_cs = _scale_layout(q.shape, scale.shape)
    M = a.numel() // K
    Nv = N // 2 if swiglu else N
    p = plan(M, K, N, swiglu)
    arr = (ctypes.c_longlong * 9)(M, K, Nv, group, s_rs, s_cs, p.splits,
                                  p.n, p.grid)
    return M, Nv, arr, ctypes.addressof(arr), p.tickets, p.scratch


def _enqueue(a, q, s, bias, out, swiglu, geo, index):
    lib = _build._lib or _build.library()
    f16 = a.dtype == torch.float16
    stream = torch._C._cuda_getCurrentRawStream(index)
    tickets = part = None
    if geo[4]:
        _, tickets, part = _paged_split.buffers(a.device, geo[4], geo[5],
                                                stream)
    if swiglu:
        fn = (lib.ptt_weight_only_swiglu_f16 if f16
              else lib.ptt_weight_only_swiglu_bf16)
        return fn(a.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
                  geo[3], tickets, part, stream)
    fn = (lib.ptt_weight_only_linear_f16 if f16
          else lib.ptt_weight_only_linear_bf16)
    bp = None if bias is None else bias.contiguous().data_ptr()
    return fn(a.data_ptr(), q.data_ptr(), s.data_ptr(), bp, out.data_ptr(),
              geo[3], tickets, part, stream)


def _launch(a, q, scale, bias, swiglu, geo):
    out = a.new_empty((*a.shape[:-1], geo[1]))
    if geo[0] == 0 or geo[1] == 0:
        return out
    if not a.is_contiguous():
        a = a.contiguous()
    if not q.is_contiguous():
        q = q.contiguous()
    s = scale
    if s.dtype != torch.float32 or not s.is_contiguous():
        s = s.float().contiguous()
    index = a.get_device()
    if index == torch.cuda.current_device():
        err = _enqueue(a, q, s, bias, out, swiglu, geo, index)
    else:
        with torch.cuda.device(index):
            err = _enqueue(a, q, s, bias, out, swiglu, geo, index)
    if err:
        _build.check(err, "weight_only_linear")
    weight_only_linear.launches += 1
    return out


def weight_only_linear(a, q, scale, bias=None, swiglu=False,
                       use_kernel=None):
    """a: [..., K]; q: int8 [K, N]; scale: [N], [1, N], one value or
    [K / g, N]; bias: optional [N]. Returns [..., N] (SwiGLU: [..., N /
    2]) in a's dtype.

    use_kernel=None routes by device (kernel on CUDA, plain on CPU);
    True demands the kernel and raises ValueError for a CPU tensor or an
    input the kernel does not take."""
    if a.is_cuda:
        key = _key(a, q, scale, bias, swiglu)
        geo = _SHAPES.get(key)
        if geo is not None:                # a signature already checked
            return _launch(a, q, scale, bias, swiglu, geo)
    ok = (q.dtype == torch.int8 and q.device == a.device
          and supported(a.shape, q.shape, scale.shape, a.dtype, swiglu,
                        bias))
    if use_kernel and not ok:
        raise ValueError(
            f"weight_only_linear: use_kernel=True but the kernel does not "
            f"take a {tuple(a.shape)} {a.dtype}, q {tuple(q.shape)} "
            f"{q.dtype}, scale {tuple(scale.shape)} (need bf16/f16, an "
            f"int8 [K, N] weight, a per-column, per-tensor or 64-row "
            f"group scale, an even N for SwiGLU)")
    if _scale_layout(q.shape, scale.shape) is None:
        raise ValueError(f"weight_only_linear: no scale layout for q "
                         f"{tuple(q.shape)} and scale {tuple(scale.shape)}")
    if a.device.type == "cpu":
        if use_kernel:
            raise ValueError(
                "weight_only_linear: use_kernel=True needs a CUDA tensor")
        return _plain(a, q, scale, bias, swiglu)
    if not ok:
        raise ValueError(
            f"weight_only_linear: no kernel for a {tuple(a.shape)} "
            f"{a.dtype}, q {tuple(q.shape)} {q.dtype}, scale "
            f"{tuple(scale.shape)}")
    geo = _SHAPES[_key(a, q, scale, bias, swiglu)] = _geometry(a, q, scale,
                                                               swiglu)
    return _launch(a, q, scale, bias, swiglu, geo)


weight_only_linear.launches = 0


def matmul(a, w):
    """a @ w for a weight tensor; the W8A16 product (engine order) for a
    `QuantWeight`."""
    if isinstance(w, QuantWeight):
        return weight_only_linear(a, w.q, w.scale)
    return a @ w
