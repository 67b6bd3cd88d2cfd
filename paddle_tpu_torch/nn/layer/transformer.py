"""Transformer layers (counterpart of
paddle_tpu/nn/layer/transformer.py:33-341): `MultiHeadAttention`,
`TransformerEncoderLayer`, `TransformerEncoder`,
`TransformerDecoderLayer`, `TransformerDecoder` and `Transformer` (with
`generate_square_subsequent_mask`), post-norm by default and pre-norm
with `normalize_before`, in paddle's layout and parameter names.

`MultiHeadAttention` holds `q_proj`, `k_proj`, `v_proj` and `out_proj`,
each a `Linear` with weight [in, out] built from `weight_attr` /
`bias_attr`, and attends through the port's
`scaled_dot_product_attention`: without dropout its routes reach the
flash kernels (no mask: the one-length kernels at equal lengths, the
segment kernels without ids otherwise; a boolean padding mask: segment
ids of the keys alone, every query row kept; a float mask: the biased
kernels); in training with `dropout > 0` the reference's dense route,
which drops elements of the attention output. `Cache` is a growing self-attention KV (the new keys are
appended: the first decode step reaches the one-length kernel at S = 1,
later ones the segment kernel at Sq = 1 < Sk); `StaticCache` the
cross-attention KV projected once from the encoder output, whose
`key`/`value` arguments are then ignored (ref :247). Every `gen_cache`
is the reference's: a layer's (incremental, static) pair, and
`TransformerDecoder.gen_cache(do_zip=True)` the lists ([incrementals],
[statics]).

`TransformerEncoder` / `TransformerDecoder` stack `num_layers` deep
copies of the layer they are given, so every layer starts from that
layer's values, as the reference's `_clone_layer` starts them (ROADMAP
Queue 3, kept for parity). Parameters are drawn from `generator` on
`device` (`cuda` unless the caller names another) in construction
order; the dropouts draw from the dropout stream.
"""
from __future__ import annotations

import collections
import copy

import torch

from ...framework.core import resolve_device
from .. import functional as F
from .common import Dropout, Linear
from .container import LayerList
from .layers import Layer
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


class MultiHeadAttention(Layer):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.k_proj = Linear(kdim, embed_dim, weight_attr, bias_attr, **kw)
        self.v_proj = Linear(vdim, embed_dim, weight_attr, bias_attr, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               **kw)

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
        out = F.scaled_dot_product_attention(
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


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps,
                               device=device, dtype=dtype)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps,
                               device=device, dtype=dtype)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.act_dropout = Dropout(act_dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.act_dropout(self.activation(
            self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        """ref transformer.py:623: an empty growing Cache."""
        return self.self_attn.gen_cache(src)


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [encoder_layer if i == 0 else copy.deepcopy(encoder_layer)
             for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask=src_mask)
            else:
                output, new_cache = mod(output, src_mask=src_mask,
                                        cache=cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr, **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps,
                               device=device, dtype=dtype)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps,
                               device=device, dtype=dtype)
        self.norm3 = LayerNorm(d_model, epsilon=layer_norm_eps,
                               device=device, dtype=dtype)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.act_dropout = Dropout(act_dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
            incr = static = None
        else:
            # a layer's cache is the (incremental, static) pair of its
            # gen_cache
            incr_in, static = cache
            tgt, incr = self.self_attn(tgt, tgt, tgt, tgt_mask, incr_in)
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if static is not None:
            tgt, static = self.cross_attn(tgt, memory, memory, memory_mask,
                                          static)
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.act_dropout(self.activation(
            self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        if cache is None:
            return tgt
        return tgt, (incr, static)

    def gen_cache(self, memory):
        """ref transformer.py:989: (an empty incremental Cache, the
        StaticCache projected from the encoder output)."""
        incremental = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return incremental, static


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [decoder_layer if i == 0 else copy.deepcopy(decoder_layer)
             for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, new_cache = mod(output, memory, tgt_mask,
                                        memory_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        """ref transformer.py:1148: per-layer (incremental, static) pairs;
        do_zip=True gives ([incrementals], [statics])."""
        caches = [layer.gen_cache(memory) for layer in self.layers]
        if do_zip:
            return list(map(list, zip(*caches)))
        return caches


class Transformer(Layer):
    """Transformer base by default (Vaswani et al. 2017, Table 3: 6 + 6
    layers, d_model 512, d_ff 2048, 8 heads, P_drop 0.1)."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        kw = dict(device=device, dtype=dtype, generator=generator)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, **kw)
            enc_norm = (LayerNorm(d_model, device=device, dtype=dtype)
                        if normalize_before else None)
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, **kw)
            dec_norm = (LayerNorm(d_model, device=device, dtype=dtype)
                        if normalize_before else None)
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """[length, length] f32: 0 on and below the diagonal, -inf above,
        on `device` (`cuda` unless the caller names another)."""
        keep = torch.ones((length, length), dtype=torch.bool,
                          device=resolve_device(device)).tril()
        return torch.where(keep, 0.0, float("-inf"))
