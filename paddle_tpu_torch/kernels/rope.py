"""Rotary position embedding and the fused QKV+RoPE prologue
(counterpart of paddle_tpu/kernels/rope.py). Plain PyTorch, as the
reference is plain jnp: the rotate-half formulation over a cos/sin
table built once per (seq, dim, base) on the host in numpy.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["apply_rope", "fused_qkv_rope"]


@functools.lru_cache(maxsize=32)
def _cos_sin_cache(seq_len: int, dim: int, base: float, dtype_str: str):
    inv_freq = 1.0 / (base ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    t = np.arange(seq_len, dtype=np.float32)
    freqs = np.outer(t, inv_freq)                  # [S, dim/2]
    emb = np.concatenate([freqs, freqs], axis=-1)  # [S, dim]
    return np.cos(emb), np.sin(emb)


@functools.lru_cache(maxsize=32)
def _cos_sin_tensors(seq_len: int, dim: int, base: float, device: str):
    """The numpy table moved to `device` once (a device tensor per
    (table, device) instead of a host copy per call)."""
    cos, sin = _cos_sin_cache(seq_len, dim, base, "f32")
    return (torch.from_numpy(cos).to(device),
            torch.from_numpy(sin).to(device))


def _rotate_half(x):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(q, k, position_ids=None, base=10000.0, seq_len=None):
    """q, k: [B, S, H, D] -> rotated (same shapes), f32 math, input dtype
    out. seq_len: table length when position_ids may exceed q's length."""
    S, D = q.shape[1], q.shape[-1]
    if position_ids is not None and seq_len is not None:
        S = int(seq_len)
    cos, sin = _cos_sin_tensors(S, D, float(base), str(q.device))
    if position_ids is not None:
        idx = position_ids.long()
        cos = cos[idx][:, :, None, :]              # [B, S, 1, D]
        sin = sin[idx][:, :, None, :]
    else:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    qf = q.float()
    kf = k.float()
    q_out = qf * cos + _rotate_half(qf) * sin
    k_out = kf * cos + _rotate_half(kf) * sin
    return q_out.to(q.dtype), k_out.to(k.dtype)


def fused_qkv_rope(a, w_qkv, num_heads, num_kv_heads, head_dim,
                   position_ids=None, base=10000.0, seq_len=None):
    """One wide projection, then rope on the q/k slices.

    a: [B, S, H] (or [S, H] packed rows); w_qkv:
    [H, (num_heads + 2*num_kv_heads) * head_dim], q|k|v column layout.
    Returns (q, k, v) shaped [..., heads, head_dim], rope applied to q
    and k."""
    nh, kvh, d = num_heads, num_kv_heads, head_dim
    qkv = a @ w_qkv
    lead = qkv.shape[:-1]
    q = qkv[..., :nh * d].reshape(*lead, nh, d)
    k = qkv[..., nh * d:(nh + kvh) * d].reshape(*lead, kvh, d)
    v = qkv[..., (nh + kvh) * d:].reshape(*lead, kvh, d)
    if a.dim() == 2:                     # packed rows: [S, H]
        pids = None if position_ids is None else position_ids[None]
        q4, k4 = apply_rope(q[None], k[None], position_ids=pids,
                            base=base, seq_len=seq_len)
        return q4[0], k4[0], v
    q, k = apply_rope(q, k, position_ids=position_ids, base=base,
                      seq_len=seq_len)
    return q, k, v
