"""`MultiHeadAttention` (counterpart of
paddle_tpu/nn/layer/transformer.py:33-104): q/k/v projections, the
port's `scaled_dot_product_attention` (its routes reach the flash,
segment-id and block-stats kernels), and the output projection, in
paddle's layout: parameters `q_proj`, `k_proj`, `v_proj`, `out_proj`,
each a `Linear` with weight [in, out].

`Cache` is a growing self-attention KV (the new keys are appended);
`StaticCache` the cross-attention KV projected once from the encoder
output, whose `key`/`value` arguments are then ignored (ref :247).
In training with `dropout > 0`, sdpa takes the reference's dense route
and drops elements of the attention output (`F.dropout`).
The rest of the reference's transformer layers are not ported yet.
"""
from __future__ import annotations

import collections

import torch
from torch import nn

from ..functional import attention as fattn
from .common import Linear

__all__ = ["MultiHeadAttention"]


class MultiHeadAttention(nn.Module):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        if weight_attr is not None:
            raise NotImplementedError(
                "MultiHeadAttention(weight_attr=) is not ported yet")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        kw = dict(bias=bias_attr is not False, device=device, dtype=dtype,
                  generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(kdim, embed_dim, **kw)
        self.v_proj = Linear(vdim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def _heads(self, x):
        return x.reshape(x.shape[0], -1, self.num_heads, self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = query if value is None else value
        q = self._heads(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            # cross-attention: the cached encoder K/V are the whole
            # key/value; `key`/`value` are ignored (ref :247)
            k, v = cache.k, cache.v
        else:
            k = self._heads(self.k_proj(key))
            v = self._heads(self.v_proj(value))
        if cache is not None and not isinstance(cache, self.StaticCache):
            k = torch.cat([cache.k, k], dim=1)
            v = torch.cat([cache.v, v], dim=1)
        out = fattn.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.dropout if self.training else 0.0,
            training=self.training)
        out = self.out_proj(out.reshape(out.shape[0], -1, self.embed_dim))
        if isinstance(cache, self.StaticCache):
            return out, cache           # static KV never grows
        if cache is not None:
            return out, self.Cache(k, v)
        return out

    def gen_cache(self, key, value=None, type=None):
        """ref transformer.py:342-353: StaticCache projects key/value once
        (cross-attention); Cache with value=None is an empty growing
        cache; Cache with value given wraps the already-projected pair."""
        if type is MultiHeadAttention.StaticCache:
            vsrc = value if value is not None else key
            return self.StaticCache(self._heads(self.k_proj(key)),
                                    self._heads(self.v_proj(vsrc)))
        if value is not None:
            return self.Cache(key, value)
        empty = torch.zeros((key.shape[0], 0, self.num_heads, self.head_dim),
                            dtype=key.dtype, device=key.device)
        return self.Cache(empty, empty.clone())
