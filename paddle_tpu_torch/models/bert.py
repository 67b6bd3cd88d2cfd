"""BERT family (counterpart of paddle_tpu/models/bert.py): a post-LN
transformer encoder, `BertModel` with its tanh pooler, `BertForMaskedLM`
(decoder tied to the word embeddings) and
`BertForSequenceClassification`, with the reference's parameter names
and `[in, out]` layout, so its `state_dict()` loads as is
(`models.convert.state_from_jax`). Parameters are f32, as the reference
creates them; embeddings are drawn N(0, initializer_range) and the
linear layers Xavier-uniform from an explicit generator.

Attention: each layer's fused QKV projection, then
`flash_attention_bshd(q, k, v, causal=False, padding_mask=
attention_mask)` (the reference's l.135-137), or with no mask when none
is given: the segment-id flash kernels on the card (the one-length ones
without a mask), their plain versions on the CPU. So a padded query row
attends to the padded keys, as on the TPU; the reference's CPU route
(its dense branch, l.139-150) has it attend to the valid keys. Valid
rows, the pooled output (row 0) and a masked-LM loss whose padding
labels are -100 agree either way. LayerNorm (eps 1e-12, f32 statistics)
and exact-erf GELU are plain PyTorch, as they are plain jnp in the
reference.

The reference's dense branch (`_dense_attention`: f32 products, the
additive (1 - mask) * f32-min term, softmax) runs on both devices where
the reference takes it on every device: in training with
`attention_probs_dropout_prob > 0`, with the probabilities dropped and
upscaled (l.141-155), and under `FLAGS_use_flash_attention=0`.

Dropout, as in the reference: `hidden_dropout_prob` after the
embeddings' LayerNorm (l.97), on the attention output projection
(l.159), on the FFN output (l.178) and, in
`BertForSequenceClassification`, on the pooled output before the
classifier (l.239, 244). Masks are drawn in that forward order from the
dropout stream (`framework.core.dropout_generator`), the probabilities'
mask of a layer before its output projection's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..framework import core
from ..framework.core import resolve_device
from ..kernels import flash_attention as kfa
from ..nn.functional import loss as floss
from ..nn.functional import common as fcommon
from ..nn.layer.common import Dropout, LayerNorm, Linear

__all__ = ["BertConfig", "BertEmbeddings", "BertSelfAttention", "BertLayer",
           "BertModel", "BertForMaskedLM", "BertForSequenceClassification",
           "bert_tiny", "bert_base", "bert_large"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    pad_token_id: int = 0

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def bert_tiny(**kw):
    return BertConfig(vocab_size=1024, hidden_size=128, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=512,
                      max_position_embeddings=128, **kw)


def bert_base(**kw):
    return BertConfig(**kw)


def bert_large(**kw):
    return BertConfig(hidden_size=1024, num_hidden_layers=24,
                      num_attention_heads=16, intermediate_size=4096, **kw)


def _normal(shape, std, device, generator):
    t = torch.empty(shape, device=device, dtype=torch.float32)
    return nn.Parameter(t.normal_(0.0, std, generator=generator))


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, device, generator=None):
        super().__init__()
        std = cfg.initializer_range
        self.word_embeddings = _normal((cfg.vocab_size, cfg.hidden_size),
                                       std, device, generator)
        self.position_embeddings = _normal(
            (cfg.max_position_embeddings, cfg.hidden_size), std, device,
            generator)
        self.token_type_embeddings = _normal(
            (cfg.type_vocab_size, cfg.hidden_size), std, device, generator)
        self.layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                    device=device)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        """position_ids is accepted and, as in the reference, not read:
        positions are 0..S-1."""
        ids = input_ids.long()
        S = ids.shape[-1]
        x = self.word_embeddings[ids]
        x = x + self.position_embeddings[:S][None]
        tt = (torch.zeros_like(ids) if token_type_ids is None
              else token_type_ids.long())
        x = x + self.token_type_embeddings[tt]
        return self.dropout(self.layer_norm(x))


def _dense_attention(q, k, v, mask, probs_dropout=0.0):
    """The reference's dense branch (bert.py:139-155): f32 scores, an
    additive (1 - mask) * f32-min padding term, softmax, and with
    probs_dropout > 0 the probabilities kept where a keep mask of their
    shape is set (`_keep_mask`, the dropout stream) and upscaled by
    1 / (1 - probs_dropout)."""
    qt, kt, vt = (t.transpose(1, 2).float() for t in (q, k, v))
    s = qt @ kt.transpose(-1, -2) / math.sqrt(q.shape[-1])
    if mask is not None:
        s = s + ((1.0 - mask[:, None, None, :].float())
                 * torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1)
    if probs_dropout > 0.0:
        keep = fcommon._keep_mask(p.shape, probs_dropout, None, p.device)
        p = torch.where(keep, p / (1.0 - probs_dropout), 0.0)
    return (p @ vt).transpose(1, 2).to(q.dtype)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, device, generator=None):
        super().__init__()
        h = cfg.hidden_size
        self.cfg = cfg
        self.qkv = Linear(h, 3 * h, device=device, generator=generator)
        self.out = Linear(h, h, device=device, generator=generator)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, x, attn_mask=None):
        """attn_mask: [B, S] validity mask (1 = real token), or None.
        The flash route, or the reference's dense branch in training
        with probs dropout and under FLAGS_use_flash_attention=0."""
        cfg = self.cfg
        nh, d = cfg.num_attention_heads, cfg.head_dim
        B, S = x.shape[0], x.shape[1]
        q, k, v = (t.reshape(B, S, nh, d)
                   for t in self.qkv(x).split(cfg.hidden_size, dim=-1))
        attn_p = (cfg.attention_probs_dropout_prob if self.training
                  else 0.0)
        if attn_p > 0.0 or not core.get_bool_flag(
                "FLAGS_use_flash_attention", True):
            o = _dense_attention(q, k, v, attn_mask, attn_p)
        else:
            o = kfa.flash_attention_bshd(q, k, v, causal=False,
                                         padding_mask=attn_mask)
        return self.dropout(self.out(o.reshape(B, S, nh * d)))


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, device, generator=None):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attention = BertSelfAttention(cfg, device, generator)
        self.attn_norm = LayerNorm(h, eps, device=device)
        self.ffn_in = Linear(h, cfg.intermediate_size, device=device,
                             generator=generator)
        self.ffn_out = Linear(cfg.intermediate_size, h, device=device,
                              generator=generator)
        self.ffn_norm = LayerNorm(h, eps, device=device)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, x, attn_mask=None):
        x = self.attn_norm(x + self.attention(x, attn_mask))
        h = self.ffn_out(torch.nn.functional.gelu(self.ffn_in(x)))
        return self.ffn_norm(x + self.dropout(h))


class BertModel(nn.Module):
    """The encoder and its pooler. Built on `device` (`cuda` unless the
    caller names another) from `generator` (a torch.Generator on that
    device; None = torch's default)."""

    def __init__(self, cfg: BertConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg, dev, generator)
        self.layers = nn.ModuleList([BertLayer(cfg, dev, generator)
                                     for _ in range(cfg.num_hidden_layers)])
        self.pooler = Linear(cfg.hidden_size, cfg.hidden_size, device=dev,
                             generator=generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        """(sequence output [B, S, h], pooled output [B, h])."""
        x = self.embeddings(input_ids, token_type_ids)
        for lyr in self.layers:
            x = lyr(x, attention_mask)
        return x, torch.tanh(self.pooler(x[:, 0]))


class BertForMaskedLM(nn.Module):
    def __init__(self, cfg: BertConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.bert = BertModel(cfg, dev, generator)
        self.transform = Linear(cfg.hidden_size, cfg.hidden_size, device=dev,
                                generator=generator)
        self.transform_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                        device=dev)
        self.decoder_bias = nn.Parameter(torch.zeros(cfg.vocab_size,
                                                     device=dev))

    @property
    def device(self) -> torch.device:
        return self.decoder_bias.device

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        """Logits [B, S, vocab] f32; the decoder is the word embeddings
        transposed (tied), plus decoder_bias."""
        seq, _ = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.transform_norm(torch.nn.functional.gelu(self.transform(seq)))
        w = self.bert.embeddings.word_embeddings
        return h @ w.transpose(0, 1) + self.decoder_bias

    def loss(self, input_ids, labels, token_type_ids=None,
             attention_mask=None, ignore_index=-100):
        logits = self(input_ids, token_type_ids, attention_mask)
        V = logits.shape[-1]
        return floss.cross_entropy(logits.reshape(-1, V),
                                   labels.reshape(-1),
                                   ignore_index=ignore_index)


class BertForSequenceClassification(nn.Module):
    def __init__(self, cfg: BertConfig, num_classes: int = 2, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.bert = BertModel(cfg, dev, generator)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        self.classifier = Linear(cfg.hidden_size, num_classes, device=dev,
                                 generator=generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.classifier(self.dropout(pooled))
