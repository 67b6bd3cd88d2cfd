"""Block attention with softmax statistics (counterpart of
paddle_tpu/kernels/block_attention.py): the per-chunk compute of
`flash_attention_biased` and the per-round compute of ring attention.

`block_attention_stats(q, k, v, mask, scale, bias)` returns the
UNNORMALISED (m [B, H, Sq], l [B, H, Sq], o [B, Sq, H, D]) of q against
one block of keys, all f32, so partials merge online. q [B, Sq, H, D] and
k/v [B, Sk, H, D] share one head count; `mask` is an optional [Sq, Sk]
bool; `bias` an optional additive f32 operand broadcastable to
[B, H, Sq, Sk], where an entry <= -5e29 counts as masked. Masked entries
get p = 0 exactly: a fully masked row gives (-1e30, 0, 0).

A CUDA tensor runs a hand-written kernel (`block_attention_fwd`): bf16
on the wgmma forward core in its block-stats mode (`csrc/flash_wgmma.cu`,
`block_stats_wgmma_kernel`: the bias tile and the mask's bits staged
beside each K tile; with a mask, one `stats_mask_bits_kernel` launch
before it packs the mask into bits and classes each tile, so that tiles
with no valid entry are skipped), f32 on the SIMT kernel of
`csrc/block_attention.cu`; either reads the bias in place through its
broadcast strides, never materialised; a CPU tensor runs
`_dense_stats`, the reference's jnp route in f32. The backward is the
reference's analytic VJP (`_stats_bwd`, l.232-275) in plain PyTorch on
either device — the reference has no backward kernel for this row — with
m treated as stop-gradient and dbias reduced over the bias's broadcast
dimensions. A CUDA tensor the kernel cannot take raises; nothing falls
back.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["block_attention_stats", "block_attention_fwd", "supported"]

_NEG = -1e30


def supported(q_shape, k_shape, dtype=torch.bfloat16) -> bool:
    """What the kernel takes: q [B, Sq, H, D], k [B, Sk, H, D] with one
    batch and head count, D in {64, 128}, bf16/f32. Any sequence lengths:
    the reference's Pallas kernel needs multiples of 128, this one masks
    its ragged edge."""
    B, Sq, H, D = (int(s) for s in q_shape)
    Bk, Sk, Hk, Dk = (int(s) for s in k_shape)
    return ((B, H, D) == (Bk, Hk, Dk) and D in (64, 128) and Sq > 0
            and Sk > 0 and dtype in (torch.bfloat16, torch.float32))


def _apply_bias_mask(s, mask, bias):
    """Shared score assembly: additive bias, then the boolean and
    threshold masks. Returns (s, valid), valid broadcast to s's shape."""
    valid = (torch.ones(s.shape, dtype=torch.bool, device=s.device)
             if mask is None else mask.bool().expand(s.shape))
    if bias is not None:
        b = bias.float()
        s = s + b
        valid = valid & (b > 0.5 * _NEG)
    return torch.where(valid, s, torch.full_like(s, _NEG)), valid


def _dense_stats(q, k, v, mask, scale, bias=None):
    """The plain version: the reference's jnp route, f32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s, valid = _apply_bias_mask(s, mask, bias)
    m = s.amax(dim=-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return m, l, o


def _fn(lib, dtype):
    return getattr(lib, "ptt_block_attention_fwd_"
                   + ("bf16" if dtype == torch.bfloat16 else "f32"))


def _rows(t):
    """Contiguous with a 16-byte aligned base: the kernel copies rows in
    16-byte vectors."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _mask_rows(mask, Sq, Sk):
    """The [Sq, Sk] mask as uint8 rows of a multiple of 16 bytes (the bf16
    kernel stages them in 16-byte copies), and that row length: the
    boolean mask itself where it already is such rows, else a zero-padded
    copy (nonzero is true, as the reference's mask.bool())."""
    mk = mask.expand(Sq, Sk)
    byte = mk.dtype in (torch.bool, torch.uint8)
    if (byte and Sk % 16 == 0 and mk.is_contiguous()
            and mk.data_ptr() % 16 == 0):
        return mk.view(torch.uint8), Sk
    ld = -(-Sk // 16) * 16
    out = torch.zeros((Sq, ld), dtype=torch.uint8, device=mask.device)
    out[:, :Sk] = mk if byte else mk != 0
    return out, ld


def block_attention_fwd(q, k, v, mask, scale, bias=None):
    """Kernel route: (m, l, o) as `block_attention_stats` returns them.
    The bias is read through the strides of its broadcast to
    [B, H, Sq, Sk] (an f32 bias expanded over heads or batch stays
    narrow)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    q, k, v = (_rows(t) for t in (q, k, v))
    m = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    o = torch.empty((B, Sq, H, D), dtype=torch.float32, device=q.device)
    mk, mld, bits, tiles = None, 0, None, None
    if mask is not None:
        mk, mld = _mask_rows(mask, Sq, Sk)
        if q.dtype == torch.bfloat16:
            # the kernel's scratch: the mask as 64-bit words per row and
            # 64-key tile, and each (128-row band, tile)'s class
            bands, n_tiles = -(-Sq // 128), -(-Sk // 64)
            bits = torch.empty((n_tiles, bands * 128), dtype=torch.int64,
                               device=q.device)
            tiles = torch.empty((bands, n_tiles), dtype=torch.uint8,
                                device=q.device)
    bs, strides = None, (0, 0, 0, 0)
    if bias is not None:
        bs = bias if bias.dtype == torch.float32 else bias.float()
        bs = bs.expand(B, H, Sq, Sk)
        strides = bs.stride()
    lib = _build.library()
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mk is None else mk.data_ptr(),
            None if bs is None else bs.data_ptr(), m.data_ptr(),
            l.data_ptr(), o.data_ptr()]
    if q.dtype == torch.bfloat16:
        ptrs += [None if bits is None else bits.data_ptr(),
                 None if tiles is None else tiles.data_ptr()]
    with torch.cuda.device(q.device):
        _build.check(_fn(lib, q.dtype)(
            *ptrs, B, Sq, Sk, H, D, mld, *strides, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream),
            "block_attention_fwd")
    block_attention_fwd.launches += 1
    return m, l, o


def stats(q, k, v, mask, scale, bias=None, use_kernel=None):
    """(m, l, o) by the route the device selects, no autograd: the
    kernel for a CUDA tensor, `_dense_stats` for a CPU tensor.
    use_kernel=True demands the kernel and raises ValueError for a CPU
    tensor or a shape/dtype it does not take."""
    ok = (supported(q.shape, k.shape, q.dtype) and k.shape == v.shape
          and k.dtype == v.dtype == q.dtype)
    if use_kernel and not ok:
        raise ValueError(
            f"block_attention_stats: use_kernel=True but the kernel does not "
            f"take q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)} "
            f"{k.dtype} (need one bf16/f32 dtype, one batch and head count, "
            f"D in (64, 128))")
    if q.device.type == "cpu":
        if use_kernel:
            raise ValueError(
                "block_attention_stats: use_kernel=True needs a CUDA tensor")
        return _dense_stats(q, k, v, mask, scale, bias)
    if not ok:
        raise ValueError(f"block_attention_stats: no kernel for q "
                         f"{tuple(q.shape)} {q.dtype}, k {tuple(k.shape)}")
    return block_attention_fwd(q, k, v, mask, scale, bias)


def _stats_bwd(q, k, v, mask, bias, m, scale, ct_l, ct_o):
    """The reference's analytic VJP with m as stop-gradient:
    dp = do v^T + dl; ds = p dp; dq = ds k scale; dk = ds^T q scale;
    dv = p^T do; dbias = ds reduced over the bias's broadcast dims."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    s, valid = _apply_bias_mask(s, mask, bias)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    do = ct_o.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vf) + ct_l.float()[..., None]
    ds = p * dp
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dbias = None
    if bias is not None:
        dbias = ds
        for ax in range(4):
            if bias.shape[ax] == 1 and ds.shape[ax] != 1:
                dbias = dbias.sum(dim=ax, keepdim=True)
        dbias = dbias.to(bias.dtype)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


class _BlockStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, mask, scale, use_kernel):
        m, l, o = stats(q, k, v, mask, scale, bias, use_kernel)
        ctx.save_for_backward(q, k, v, bias, m)
        ctx.mask = mask
        ctx.scale = scale
        ctx.mark_non_differentiable(m)
        return m, l, o

    @staticmethod
    def backward(ctx, ct_m, ct_l, ct_o):
        q, k, v, bias, m = ctx.saved_tensors
        if ct_l is None:
            ct_l = torch.zeros_like(m)
        if ct_o is None:
            ct_o = torch.zeros(q.shape, dtype=torch.float32,
                               device=q.device)
        dq, dk, dv, dbias = _stats_bwd(q, k, v, ctx.mask, bias, m,
                                       ctx.scale, ct_l, ct_o)
        return dq, dk, dv, dbias, None, None, None


def block_attention_stats(q, k, v, mask, scale, bias=None, use_kernel=None):
    """(m [B, H, Sq], l [B, H, Sq], o [B, Sq, H, D] f32, unnormalised) for
    one ring round or bias chunk; differentiable in q, k, v and bias (4-D,
    broadcastable to [B, H, Sq, Sk]); mask is not differentiable. The
    kernel runs for a CUDA tensor, `_dense_stats` for a CPU tensor;
    use_kernel=True demands the kernel (ValueError otherwise)."""
    if bias is not None and bias.dim() != 4:
        raise ValueError(f"block_attention_stats: bias must be 4-D "
                         f"(broadcastable to [B, H, Sq, Sk]), got "
                         f"{tuple(bias.shape)}")
    return _BlockStats.apply(q, k, v, bias, mask, float(scale), use_kernel)


# the kernel's calls: each launches the stats kernel once, a masked bf16
# call its mask pre-pass (`stats_mask_bits_kernel`) just before it
block_attention_fwd.launches = 0
