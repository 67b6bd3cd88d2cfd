"""incubate.nn's fused layers (counterpart of paddle_tpu/incubate/nn/
layer.py): `nn.Module`s with the reference's parameter names and
shapes, each forward the reference's op body over the functionals of
`incubate.nn.functional` (row 10's flash kernels for attention without
a mask or probability dropout). Weights: [in, out] matrices drawn
uniform(-b, b) with b = sqrt(6 / (fan_in + fan_out)), biases zero,
layer-norm scales one; `models.convert.incubate_state_from_jax` carries
a reference layer's parameters over. Layers are built on `cuda` unless
`device="cpu"` is passed."""
from __future__ import annotations

import math

import torch
from torch import nn

from ...framework.core import resolve_device
from . import functional as IF

__all__ = ["FusedLinear", "FusedDropoutAdd",
           "FusedBiasDropoutResidualLayerNorm", "FusedMultiHeadAttention",
           "FusedFeedForward", "FusedTransformerEncoderLayer", "FusedEcMoe"]


def _uniform(shape, dev, dtype, fan_in, fan_out):
    b = math.sqrt(6.0 / (fan_in + fan_out))
    return nn.Parameter(torch.empty(shape, device=dev,
                                    dtype=dtype).uniform_(-b, b))


def _const(shape, dev, dtype, value):
    return nn.Parameter(torch.full(shape, float(value), device=dev,
                                   dtype=dtype))


class FusedLinear(nn.Module):
    """x @ weight + bias (weight [in, out], or [out, in] with
    transpose_weight; no bias with bias_attr=False)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, transpose_weight=False, name=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        shape = ((out_features, in_features) if transpose_weight
                 else (in_features, out_features))
        self.weight = _uniform(shape, dev, dtype, in_features, out_features)
        self.bias = (_const((out_features,), dev, dtype, 0.0)
                     if bias_attr is not False else None)
        self.transpose_weight = transpose_weight

    def forward(self, x):
        return IF.fused_linear(x, self.weight, self.bias,
                               transpose_weight=self.transpose_weight)


class FusedDropoutAdd(nn.Module):
    """dropout(x) + y in either dropout mode."""

    def __init__(self, p=0.5, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.mode = mode

    def forward(self, x, y):
        return IF.fused_dropout_add(x, y, p=self.p, training=self.training,
                                    mode=self.mode)


class FusedBiasDropoutResidualLayerNorm(nn.Module):
    """LN(residual + dropout(x + linear_bias))."""

    def __init__(self, embed_dim, dropout_rate=0.5, weight_attr=None,
                 bias_attr=None, epsilon=1e-5, name=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.ln_scale = _const((embed_dim,), dev, dtype, 1.0)
        self.ln_bias = _const((embed_dim,), dev, dtype, 0.0)
        self.linear_bias = _const((embed_dim,), dev, dtype, 0.0)
        self.dropout_rate = dropout_rate
        self.epsilon = epsilon

    def forward(self, x, residual):
        return IF.fused_bias_dropout_residual_layer_norm(
            x, residual, self.linear_bias, self.ln_scale, self.ln_bias,
            dropout_rate=self.dropout_rate, ln_epsilon=self.epsilon,
            training=self.training)


class FusedMultiHeadAttention(nn.Module):
    """Pre- or post-LN self-attention with a packed [3, nh, d, H] qkv
    weight, the out projection and the residual, dropout and LN
    epilogue (`functional.fused_multi_head_attention`)."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5,
                 nranks=1, ring_id=-1, name=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be a multiple of num_heads")
        dev = resolve_device(device)
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.embed_dim = embed_dim
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self.epsilon = epsilon
        h, nh, d = embed_dim, num_heads, self.head_dim
        self.qkv_weight = _uniform((3, nh, d, h), dev, dtype, h, 3 * h)
        self.qkv_bias = _const((3, nh, d), dev, dtype, 0.0)
        self.linear_weight = _uniform((h, h), dev, dtype, h, h)
        self.linear_bias = _const((h,), dev, dtype, 0.0)
        self.pre_ln_scale = _const((h,), dev, dtype, 1.0)
        self.pre_ln_bias = _const((h,), dev, dtype, 0.0)
        self.ln_scale = _const((h,), dev, dtype, 1.0)
        self.ln_bias = _const((h,), dev, dtype, 0.0)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        return IF.fused_multi_head_attention(
            query, self.qkv_weight, self.linear_weight,
            pre_layer_norm=self.normalize_before,
            pre_ln_scale=self.pre_ln_scale, pre_ln_bias=self.pre_ln_bias,
            ln_scale=self.ln_scale, ln_bias=self.ln_bias,
            pre_ln_epsilon=self.epsilon, qkv_bias=self.qkv_bias,
            linear_bias=self.linear_bias, cache_kv=cache,
            attn_mask=attn_mask, dropout_rate=self.dropout_rate,
            attn_dropout_rate=self.attn_dropout_rate,
            ln_epsilon=self.epsilon, training=self.training)


class FusedFeedForward(nn.Module):
    """LN + linear1 + act + dropout + linear2 + residual dropout (the
    first dropout at act_dropout_rate, upscale_in_train)."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None,
                 ln2_bias_attr=None, nranks=1, ring_id=-1, name=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        if activation not in ("relu", "gelu"):
            raise ValueError(f"unsupported activation {activation!r}")
        dev = resolve_device(device)
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = (dropout_rate if act_dropout_rate is None
                                 else act_dropout_rate)
        self.activation = activation
        self.epsilon = epsilon
        d, f = d_model, dim_feedforward
        self.linear1_weight = _uniform((d, f), dev, dtype, d, f)
        self.linear1_bias = _const((f,), dev, dtype, 0.0)
        self.linear2_weight = _uniform((f, d), dev, dtype, f, d)
        self.linear2_bias = _const((d,), dev, dtype, 0.0)
        self.ln1_scale = _const((d,), dev, dtype, 1.0)
        self.ln1_bias = _const((d,), dev, dtype, 0.0)
        self.ln2_scale = _const((d,), dev, dtype, 1.0)
        self.ln2_bias = _const((d,), dev, dtype, 0.0)

    def forward(self, src, cache=None):
        act = IF._act(self.activation)
        train = self.training
        residual = src
        a = (IF._ln(src, self.ln1_scale, self.ln1_bias, self.epsilon)
             if self.normalize_before else src)
        hmid = IF._dropout_mode(act(a @ self.linear1_weight
                                    + self.linear1_bias),
                                self.act_dropout_rate, train,
                                "upscale_in_train")
        out = residual + IF._dropout_mode(
            hmid @ self.linear2_weight + self.linear2_bias,
            self.dropout_rate, train, "upscale_in_train")
        if not self.normalize_before:
            out = IF._ln(out, self.ln2_scale, self.ln2_bias, self.epsilon)
        return out


class FusedTransformerEncoderLayer(nn.Module):
    """FusedMultiHeadAttention, then FusedFeedForward."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=(dropout_rate if attn_dropout_rate is None
                               else attn_dropout_rate),
            normalize_before=normalize_before, device=device, dtype=dtype)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before, device=device, dtype=dtype)

    def forward(self, src, src_mask=None, cache=None):
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))


class FusedEcMoe(nn.Module):
    """Expert-choice MoE (`functional.fused_ec_moe`); without caller
    gate logits the layer's own gate_weight makes them in f32."""

    def __init__(self, hidden_size, inter_size, num_experts, act_type="gelu",
                 weight_attr=None, bias_attr=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        if act_type not in ("gelu", "relu"):
            raise ValueError(f"unsupported act_type {act_type!r}")
        dev = resolve_device(device)
        self.num_experts = num_experts
        self.act_type = act_type
        h, m, e = hidden_size, inter_size, num_experts
        self.gate_weight = _uniform((h, e), dev, dtype, h, e)
        self.ffn1_weight = _uniform((e, h, m), dev, dtype, h, m)
        self.ffn1_bias = _const((e, m), dev, dtype, 0.0)
        self.ffn2_weight = _uniform((e, m, h), dev, dtype, m, h)
        self.ffn2_bias = _const((e, h), dev, dtype, 0.0)

    def forward(self, x, gate=None):
        if gate is None:
            gate = x.float() @ self.gate_weight.float()
        return IF.fused_ec_moe(x, gate, self.ffn1_weight, self.ffn1_bias,
                               self.ffn2_weight, self.ffn2_bias,
                               self.act_type)
