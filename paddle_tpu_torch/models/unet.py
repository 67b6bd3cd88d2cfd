"""The Stable-Diffusion-style conditional UNet (counterpart of
paddle_tpu/models/unet.py; BASELINE.md config 5): ResBlock (GroupNorm,
SiLU, 3x3 conv, the timestep embedding added) and SpatialTransformer
(self-attention, cross-attention on the text context, a GEGLU MLP) at
each resolution, the sinusoidal timestep embedding, and the
skip-connected down and up paths, sized by `block_out_channels`.

Kept as the reference has them:
- `CrossAttention` computes its scores, softmax and products in f32 and
  casts back (l.96-110): dense attention in plain PyTorch, as the
  reference runs plain jnp outside any Pallas kernel;
- `GEGLU` multiplies the first half of its projection by the gelu of
  the second (l.121-124), gelu being `jax.nn.gelu`'s default, the tanh
  approximation;
- a SpatialTransformer at width c has max(1, c // (attention_head_dim ·
  8)) heads (l.207, 217, 231): SD 1.5 runs 5 heads of 64;
- GroupNorm's groups are gcd(norm_num_groups, channels);
- `Upsample` is the reference's nearest interpolation (`nn.functional.
  interpolate`) then a 3x3 conv.

The f32 timestep embedding is cast to the model's dtype before
`time_fc1` (the reference's jnp promotes the product instead).

Every layer is made on `device` (`cuda` unless named) and draws from
`generator`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch

from ..nn import functional as F
from ..nn.layer.common import Linear
from ..nn.layer.container import LayerList
from ..nn.layer.conv import Conv2D
from ..nn.layer.layers import Layer
from ..nn.layer.norm import GroupNorm, LayerNorm

__all__ = ["UNetConfig", "UNet2DConditionModel", "unet_tiny", "unet_sd15",
           "timestep_embedding", "ResBlock", "CrossAttention", "GEGLU",
           "TransformerBlock", "SpatialTransformer", "Downsample",
           "Upsample"]


@dataclass
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Sequence[int] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_head_dim: int = 8
    norm_num_groups: int = 32
    sample_size: int = 64


def timestep_embedding(t, dim, max_period=10000.0):
    """Sinusoidal embedding [B] -> [B, dim] (f32)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class ResBlock(Layer):
    def __init__(self, in_c, out_c, temb_c, groups, *, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.norm1 = GroupNorm(math.gcd(groups, in_c), in_c, device=device)
        self.conv1 = Conv2D(in_c, out_c, 3, padding=1, **kw)
        self.temb_proj = Linear(temb_c, out_c, **kw)
        self.norm2 = GroupNorm(math.gcd(groups, out_c), out_c, device=device)
        self.conv2 = Conv2D(out_c, out_c, 3, padding=1, **kw)
        self.skip = Conv2D(in_c, out_c, 1, **kw) if in_c != out_c else None

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.temb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        return h + (self.skip(x) if self.skip is not None else x)


class CrossAttention(Layer):
    def __init__(self, q_dim, ctx_dim, heads, head_dim, *, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        inner = heads * head_dim
        self.heads = heads
        self.head_dim = head_dim
        self.to_q = Linear(q_dim, inner, bias_attr=False, **kw)
        self.to_k = Linear(ctx_dim, inner, bias_attr=False, **kw)
        self.to_v = Linear(ctx_dim, inner, bias_attr=False, **kw)
        self.to_out = Linear(inner, q_dim, **kw)

    def forward(self, x, context=None):
        ctx = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        H, D = self.heads, self.head_dim
        B, Sq, Sk = q.shape[0], q.shape[1], k.shape[1]
        qt = q.reshape(B, Sq, H, D).transpose(1, 2).float()
        kt = k.reshape(B, Sk, H, D).transpose(1, 2).float()
        vt = v.reshape(B, Sk, H, D).transpose(1, 2).float()
        s = qt @ kt.transpose(-1, -2) / math.sqrt(D)
        p = torch.softmax(s, dim=-1)
        o = (p @ vt).transpose(1, 2).to(q.dtype)
        return self.to_out(o.reshape(B, Sq, H * D))


class GEGLU(Layer):
    def __init__(self, dim, mult=4, *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.proj = Linear(dim, dim * mult * 2, **kw)
        self.out = Linear(dim * mult, dim, **kw)

    def forward(self, x):
        a, b = self.proj(x).chunk(2, dim=-1)
        return self.out(
            torch.nn.functional.gelu(b, approximate="tanh") * a)


class TransformerBlock(Layer):
    def __init__(self, dim, ctx_dim, heads, head_dim, *, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.norm1 = LayerNorm(dim, device=device)
        self.attn1 = CrossAttention(dim, dim, heads, head_dim, **kw)
        self.norm2 = LayerNorm(dim, device=device)
        self.attn2 = CrossAttention(dim, ctx_dim, heads, head_dim, **kw)
        self.norm3 = LayerNorm(dim, device=device)
        self.ff = GEGLU(dim, **kw)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(Layer):
    """NCHW <-> tokens around one TransformerBlock."""

    def __init__(self, channels, ctx_dim, heads, groups, *, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.norm = GroupNorm(math.gcd(groups, channels), channels,
                              device=device)
        self.proj_in = Conv2D(channels, channels, 1, **kw)
        self.block = TransformerBlock(channels, ctx_dim, heads,
                                      channels // heads, **kw)
        self.proj_out = Conv2D(channels, channels, 1, **kw)

    def forward(self, x, context):
        B, C, Hh, W = x.shape
        h = self.proj_in(self.norm(x))
        tokens = h.permute(0, 2, 3, 1).reshape(B, Hh * W, C)
        tokens = self.block(tokens, context)
        h = tokens.reshape(B, Hh, W, C).permute(0, 3, 1, 2)
        return x + self.proj_out(h)


class Downsample(Layer):
    def __init__(self, c, *, device=None, generator=None):
        super().__init__()
        self.conv = Conv2D(c, c, 3, stride=2, padding=1, device=device,
                           generator=generator)

    def forward(self, x):
        return self.conv(x)


class Upsample(Layer):
    def __init__(self, c, *, device=None, generator=None):
        super().__init__()
        self.conv = Conv2D(c, c, 3, padding=1, device=device,
                           generator=generator)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class _Identity(Layer):
    def forward(self, x, *a, **k):
        return x


class UNet2DConditionModel(Layer):
    def __init__(self, cfg: UNetConfig = None, *, device=None,
                 generator=None, **kw):
        super().__init__()
        cfg = cfg or UNetConfig(**kw)
        self.cfg = cfg
        mk = dict(device=device, generator=generator)
        chs = list(cfg.block_out_channels)
        temb_c = chs[0] * 4
        g = cfg.norm_num_groups
        self.time_fc1 = Linear(chs[0], temb_c, **mk)
        self.time_fc2 = Linear(temb_c, temb_c, **mk)
        self.conv_in = Conv2D(cfg.in_channels, chs[0], 3, padding=1, **mk)

        heads = cfg.attention_head_dim
        self.down_res = LayerList()
        self.down_attn = LayerList()
        self.downsamplers = LayerList()
        c = chs[0]
        self.down_plan = []
        for i, out_c in enumerate(chs):
            use_attn = i < len(chs) - 1   # SD: no attn at the deepest level
            for _ in range(cfg.layers_per_block):
                self.down_res.append(ResBlock(c, out_c, temb_c, g, **mk))
                self.down_attn.append(
                    SpatialTransformer(out_c, cfg.cross_attention_dim,
                                       max(1, out_c // (heads * 8)), g, **mk)
                    if use_attn else _Identity())
                c = out_c
                self.down_plan.append(("block", use_attn))
            if i < len(chs) - 1:
                self.downsamplers.append(Downsample(c, **mk))
                self.down_plan.append(("down", False))

        self.mid_res1 = ResBlock(c, c, temb_c, g, **mk)
        self.mid_attn = SpatialTransformer(c, cfg.cross_attention_dim,
                                           max(1, c // (heads * 8)), g, **mk)
        self.mid_res2 = ResBlock(c, c, temb_c, g, **mk)

        self.up_res = LayerList()
        self.up_attn = LayerList()
        self.upsamplers = LayerList()
        skip_chs = self._skip_channels(chs, cfg.layers_per_block)
        for i, out_c in enumerate(reversed(chs)):
            use_attn = i > 0
            for _ in range(cfg.layers_per_block + 1):
                skip = skip_chs.pop()
                self.up_res.append(ResBlock(c + skip, out_c, temb_c, g, **mk))
                self.up_attn.append(
                    SpatialTransformer(out_c, cfg.cross_attention_dim,
                                       max(1, out_c // (heads * 8)), g, **mk)
                    if use_attn else _Identity())
                c = out_c
            if i < len(chs) - 1:
                self.upsamplers.append(Upsample(c, **mk))

        self.norm_out = GroupNorm(math.gcd(g, c), c, device=device)
        self.conv_out = Conv2D(c, cfg.out_channels, 3, padding=1, **mk)

    @staticmethod
    def _skip_channels(chs, lpb):
        skips = [chs[0]]
        c = chs[0]
        for i, out_c in enumerate(chs):
            for _ in range(lpb):
                c = out_c
                skips.append(c)
            if i < len(chs) - 1:
                skips.append(c)
        return skips

    def forward(self, sample, timestep, encoder_hidden_states):
        temb = timestep_embedding(timestep, self.cfg.block_out_channels[0])
        temb = temb.to(self.time_fc1.weight.dtype)
        temb = self.time_fc2(F.silu(self.time_fc1(temb)))

        x = self.conv_in(sample)
        skips = [x]
        ri = di = 0
        for kind, _ in self.down_plan:
            if kind == "block":
                x = self.down_res[ri](x, temb)
                x = self.down_attn[ri](x, encoder_hidden_states)
                ri += 1
            else:
                x = self.downsamplers[di](x)
                di += 1
            skips.append(x)

        x = self.mid_res1(x, temb)
        x = self.mid_attn(x, encoder_hidden_states)
        x = self.mid_res2(x, temb)

        ui = 0
        n_levels = len(self.cfg.block_out_channels)
        for i in range(n_levels):
            for _ in range(self.cfg.layers_per_block + 1):
                x = torch.cat([x, skips.pop()], dim=1)
                x = self.up_res[ui](x, temb)
                x = self.up_attn[ui](x, encoder_hidden_states)
                ui += 1
            if i < n_levels - 1:
                x = self.upsamplers[i](x)

        return self.conv_out(F.silu(self.norm_out(x)))


def unet_tiny(**kw):
    return UNetConfig(in_channels=4, out_channels=4,
                      block_out_channels=(32, 64),
                      layers_per_block=1, cross_attention_dim=64,
                      attention_head_dim=4, norm_num_groups=8,
                      sample_size=16, **kw)


def unet_sd15(**kw):
    return UNetConfig(**kw)
