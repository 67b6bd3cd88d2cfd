"""ERNIE-3.0-style encoder (counterpart of paddle_tpu/models/ernie.py):
`ErnieConfig`, `ErnieEmbedding`, `ErnieBlock`, `ErnieHead`,
`ErnieModel`, `ErnieForPretraining` and the presets, with the
reference's parameter names and `[in, out]` layout, so its
`state_dict()` loads as is (`models.convert.state_from_jax`).
Parameters are f32, as the reference creates them; embeddings are drawn
N(0, initializer_range) and the linear layers Xavier-uniform from an
explicit generator.

A pre-LN encoder: word + position embeddings, then dropout; each block
is `x + proj(attn(ln1(x)))`, with no dropout on the attention output,
then `x + dropout(fc2(gelu(fc1(ln2(x)))))`; a final LayerNorm (eps
1e-5 throughout) and an untied vocabulary head. Dropout masks are drawn
in that forward order from the dropout stream
(`framework.core.dropout_generator`).

Attention is full (non-causal) and unmasked:
`flash_attention_bshd(q, k, v, causal=False)` (the reference's
l.112-114), the one-length flash kernels on the card (f32: their 3xTF32
form) and their plain version on the CPU. Under
`FLAGS_use_flash_attention=0` the reference's dense branch (l.115-121:
f32 products and softmax) runs on both devices, as the reference runs
it on every device.

`build_ernie_pipeline` needs the fleet pipeline (`PipelineLayer`), which
is not ported: it raises NotImplementedError.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..framework import core
from ..framework.core import resolve_device
from ..kernels import flash_attention as kfa
from ..nn.functional import loss as floss
from ..nn.layer.common import Dropout, LayerNorm, Linear
from .bert import _dense_attention, _normal

__all__ = ["ErnieConfig", "ErnieEmbedding", "ErnieBlock", "ErnieHead",
           "ErnieModel", "ErnieForPretraining", "ernie_tiny", "ernie_base",
           "ernie_3_0_medium", "build_ernie_pipeline"]


@dataclass
class ErnieConfig:
    vocab_size: int = 40000
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 2048
    hidden_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


class ErnieEmbedding(nn.Module):
    def __init__(self, cfg: ErnieConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        std = cfg.initializer_range
        self.word_emb = _normal((cfg.vocab_size, cfg.hidden_size), std, dev,
                                generator)
        self.pos_emb = _normal((cfg.max_position_embeddings,
                                cfg.hidden_size), std, dev, generator)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids):
        S = input_ids.shape[-1]
        x = self.word_emb[input_ids.long()] + self.pos_emb[:S][None]
        return self.dropout(x)


class ErnieBlock(nn.Module):
    """Pre-LN block: ln -> attn -> +res; ln -> ffn -> dropout -> +res."""

    def __init__(self, cfg: ErnieConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.cfg = cfg
        self.ln1 = LayerNorm(h, eps, device=dev)
        self.qkv = Linear(h, 3 * h, device=dev, generator=generator)
        self.proj = Linear(h, h, device=dev, generator=generator)
        self.ln2 = LayerNorm(h, eps, device=dev)
        self.fc1 = Linear(h, cfg.intermediate_size, device=dev,
                          generator=generator)
        self.fc2 = Linear(cfg.intermediate_size, h, device=dev,
                          generator=generator)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, x):
        cfg = self.cfg
        nh, d = cfg.num_attention_heads, cfg.head_dim
        B, S = x.shape[0], x.shape[1]
        q, k, v = (t.reshape(B, S, nh, d) for t in
                   self.qkv(self.ln1(x)).split(cfg.hidden_size, dim=-1))
        if core.get_bool_flag("FLAGS_use_flash_attention", True):
            o = kfa.flash_attention_bshd(q, k, v, causal=False)
        else:
            o = _dense_attention(q, k, v, None)
        x = x + self.proj(o.reshape(B, S, nh * d))
        h = self.fc2(torch.nn.functional.gelu(self.fc1(self.ln2(x))))
        return x + self.dropout(h)


class ErnieHead(nn.Module):
    """The pipeline's suffix: final norm and vocabulary decoder."""

    def __init__(self, cfg: ErnieConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device=dev)
        self.decoder = Linear(cfg.hidden_size, cfg.vocab_size, device=dev,
                              generator=generator)

    def forward(self, x):
        return self.decoder(self.norm(x))


class ErnieModel(nn.Module):
    """Embeddings, the blocks and the final norm. Built on `device`
    (`cuda` unless the caller names another) from `generator` (a
    torch.Generator on that device; None = torch's default)."""

    def __init__(self, cfg: ErnieConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.embeddings = ErnieEmbedding(cfg, dev, generator)
        self.blocks = nn.ModuleList([ErnieBlock(cfg, dev, generator)
                                     for _ in range(cfg.num_hidden_layers)])
        self.norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device=dev)

    def forward(self, input_ids):
        x = self.embeddings(input_ids)
        for b in self.blocks:
            x = b(x)
        return self.norm(x)


class ErnieForPretraining(nn.Module):
    def __init__(self, cfg: ErnieConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.ernie = ErnieModel(cfg, dev, generator)
        self.head = Linear(cfg.hidden_size, cfg.vocab_size, device=dev,
                           generator=generator)

    def forward(self, input_ids):
        """Logits [B, S, vocab] f32."""
        return self.head(self.ernie(input_ids))

    def loss(self, input_ids, labels, ignore_index=-100):
        logits = self(input_ids)
        V = logits.shape[-1]
        return floss.cross_entropy(logits.reshape(-1, V), labels.reshape(-1),
                                   ignore_index=ignore_index)


def build_ernie_pipeline(cfg: ErnieConfig, num_stages: int, loss_fn=None):
    """The reference's PipelineLayer factoring (embeddings, the blocks,
    norm + head) needs the fleet pipeline, which is not ported."""
    raise NotImplementedError(
        "build_ernie_pipeline needs the fleet pipeline (PipelineLayer), "
        "which is not ported yet (ROADMAP Queue 1 item 12)")


def ernie_tiny(**kw):
    return ErnieConfig(vocab_size=1024, hidden_size=128, num_hidden_layers=4,
                       num_attention_heads=4, intermediate_size=512,
                       max_position_embeddings=128, **kw)


def ernie_base(**kw):
    return ErnieConfig(**kw)


def ernie_3_0_medium(**kw):
    return ErnieConfig(hidden_size=768, num_hidden_layers=6,
                       num_attention_heads=12, intermediate_size=3072, **kw)
