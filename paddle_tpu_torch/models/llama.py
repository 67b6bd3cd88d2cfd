"""LLaMA family — the serving half (counterpart of
paddle_tpu/models/llama.py).

`LlamaForCausalLM` is an `nn.Module` holding parameters whose
`state_dict()` keys and shapes match the JAX model's one to one, in the
same `[in, out]` layout (`a @ W`): `model.embed_tokens`,
`model.layers.{i}.self_attn.qkv_proj` (or q/k/v_proj unfused),
`…self_attn.o_proj`, `…mlp.gate_up_proj` (or gate/up_proj),
`…mlp.down_proj`, `…input_layernorm.weight`,
`…post_attention_layernorm.weight`, `model.norm.weight`, `lm_head`.
Norm weights stay f32 in a bf16 model, as in the reference.

The serving step `_ragged_step_paged` runs the chunked-prefill /
decode mix over the paged KV pool with the reference's float order.
Its per-layer KV page writes are in-place index writes into the pool
tensors (the reference donates its pools to XLA instead). The layer
stack is a Python loop over per-layer weight dicts (the reference
stacks weights for `lax.scan`). The training forward, `generate` and
the bucketed/decode-only blocks belong to later slices.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..framework import core
from ..framework.core import resolve_device
from ..kernels import ragged_paged_attention as krpa
from ..kernels import rms_norm as krn
from ..kernels import rope as krope
from ..kernels import swiglu as ksw

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM", "llama_tiny",
           "llama_350m", "llama_1b", "llama_7b"]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    # training-side knobs kept so a reference config.json loads as is;
    # the serving half reads none of them
    use_recompute: bool = True
    scan_layers: bool = True
    sequence_parallel: bool = False
    fuse_attention_qkv: bool = True
    fuse_mlp: bool = True
    dtype: str = "bfloat16"

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_heads(self):
        return self.num_key_value_heads or self.num_attention_heads


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def _param(shape, device, dtype, generator, std=0.02, const=None):
    t = torch.empty(shape, device=device, dtype=dtype)
    if const is not None:
        t.fill_(const)
    else:
        t.normal_(0.0, std, generator=generator)
    return nn.Parameter(t, requires_grad=False)


class LlamaRMSNorm(nn.Module):
    def __init__(self, hidden, eps, device):
        super().__init__()
        self.eps = eps
        self.weight = _param((hidden,), device, torch.float32, None,
                             const=1.0)


class LlamaAttention(nn.Module):
    def __init__(self, cfg, device, dtype, g):
        super().__init__()
        h, d = cfg.hidden_size, cfg.head_dim
        nh, kvh = cfg.num_attention_heads, cfg.kv_heads
        if cfg.fuse_attention_qkv:
            self.qkv_proj = _param((h, (nh + 2 * kvh) * d), device, dtype, g)
        else:
            self.q_proj = _param((h, nh * d), device, dtype, g)
            self.k_proj = _param((h, kvh * d), device, dtype, g)
            self.v_proj = _param((h, kvh * d), device, dtype, g)
        self.o_proj = _param((nh * d, h), device, dtype, g)


class LlamaMLP(nn.Module):
    def __init__(self, cfg, device, dtype, g):
        super().__init__()
        h, m = cfg.hidden_size, cfg.intermediate_size
        if cfg.fuse_mlp:
            self.gate_up_proj = _param((h, 2 * m), device, dtype, g)
        else:
            self.gate_proj = _param((h, m), device, dtype, g)
            self.up_proj = _param((h, m), device, dtype, g)
        self.down_proj = _param((m, h), device, dtype, g)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg, device, dtype, g):
        super().__init__()
        self.input_layernorm = LlamaRMSNorm(cfg.hidden_size,
                                            cfg.rms_norm_eps, device)
        self.self_attn = LlamaAttention(cfg, device, dtype, g)
        self.post_attention_layernorm = LlamaRMSNorm(
            cfg.hidden_size, cfg.rms_norm_eps, device)
        self.mlp = LlamaMLP(cfg, device, dtype, g)


class LlamaModel(nn.Module):
    def __init__(self, cfg, device, dtype, g):
        super().__init__()
        self.embed_tokens = _param((cfg.vocab_size, cfg.hidden_size),
                                   device, dtype, g)
        self.layers = nn.ModuleList([LlamaDecoderLayer(cfg, device, dtype, g)
                                     for _ in range(cfg.num_hidden_layers)])
        self.norm = LlamaRMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device)


def _translate_fusion_keys(sd, cfg):
    """Convert between fused (qkv_proj / gate_up_proj) and unfused
    (q/k/v_proj, gate/up_proj) checkpoint layouts to match `cfg`."""
    nh, kvh, d = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
    m = cfg.intermediate_size
    out = dict(sd)
    for key in list(sd.keys()):
        base, _, leaf = key.rpartition(".")
        if cfg.fuse_attention_qkv and leaf == "q_proj":
            k_key, v_key = f"{base}.k_proj", f"{base}.v_proj"
            if k_key in sd and v_key in sd:
                out[f"{base}.qkv_proj"] = torch.cat(
                    [sd[key], sd[k_key], sd[v_key]], dim=-1)
                for k2 in (key, k_key, v_key):
                    out.pop(k2, None)
        elif not cfg.fuse_attention_qkv and leaf == "qkv_proj":
            qkv = sd[key]
            out[f"{base}.q_proj"] = qkv[..., : nh * d]
            out[f"{base}.k_proj"] = qkv[..., nh * d: (nh + kvh) * d]
            out[f"{base}.v_proj"] = qkv[..., (nh + kvh) * d:]
            out.pop(key, None)
        elif cfg.fuse_mlp and leaf == "gate_proj":
            up_key = f"{base}.up_proj"
            if up_key in sd:
                out[f"{base}.gate_up_proj"] = torch.cat(
                    [sd[key], sd[up_key]], dim=-1)
                out.pop(key, None)
                out.pop(up_key, None)
        elif not cfg.fuse_mlp and leaf == "gate_up_proj":
            gu = sd[key]
            out[f"{base}.gate_proj"] = gu[..., :m]
            out[f"{base}.up_proj"] = gu[..., m:]
            out.pop(key, None)
    return out


class LlamaForCausalLM(nn.Module):
    """Parameters only (the serving step is a set of functions over the
    state dict, as in the reference). Weights are drawn N(0, 0.02) from
    `generator` (a torch.Generator on `device`; None = torch's default
    generator for that device), norms are ones in f32."""

    def __init__(self, cfg: LlamaConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        dtype = torch_dtype(cfg.dtype)
        self.model = LlamaModel(cfg, dev, dtype, generator)
        if not cfg.tie_word_embeddings:
            self.lm_head = _param((cfg.hidden_size, cfg.vocab_size), dev,
                                  dtype, generator)
        else:
            self.lm_head = None

    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.device

    def load_state_dict(self, state_dict, strict=True, assign=False):
        """Loads fused and unfused checkpoints interchangeably (q/k/v and
        gate/up keys concatenated, or a fused key split, to match this
        model's layout)."""
        state_dict = _translate_fusion_keys(dict(state_dict), self.cfg)
        return super().load_state_dict(state_dict, strict=strict,
                                       assign=assign)

    set_state_dict = load_state_dict


# ---------------------------------------------------------------------------
# serving blocks over a state dict
# ---------------------------------------------------------------------------


def _gather_layer_weights(state, cfg):
    """Per-layer weight dicts (the reference stacks them [L, ...] for
    lax.scan). Under FLAGS_fused_transformer the wide qkv / gate_up
    projections are kept (or built); else the unfused views. The SwiGLU
    kernel takes only the wide [Wg | Wu] layout and always runs on the
    card, so off the CPU the MLP gets gate_up whatever the flag says:
    there the flag picks the QKV layout alone."""
    L = cfg.num_hidden_layers
    nh, kvh, d = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
    m = cfg.intermediate_size
    fused = core.get_bool_flag("FLAGS_fused_transformer", True)
    fused_mlp = fused or state["model.embed_tokens"].device.type != "cpu"
    out = []
    for i in range(L):
        def get(n, i=i):
            return state[f"model.layers.{i}.{n}"]

        wl = {n: get(n) for n in
              ["input_layernorm.weight", "post_attention_layernorm.weight",
               "self_attn.o_proj", "mlp.down_proj"]}
        if fused:
            wl["self_attn.qkv_proj"] = (
                get("self_attn.qkv_proj") if cfg.fuse_attention_qkv
                else torch.cat([get("self_attn.q_proj"),
                                get("self_attn.k_proj"),
                                get("self_attn.v_proj")], dim=-1))
        elif cfg.fuse_attention_qkv:
            qkv = get("self_attn.qkv_proj")
            wl["self_attn.q_proj"] = qkv[..., : nh * d]
            wl["self_attn.k_proj"] = qkv[..., nh * d: (nh + kvh) * d]
            wl["self_attn.v_proj"] = qkv[..., (nh + kvh) * d:]
        else:
            for n in ("self_attn.q_proj", "self_attn.k_proj",
                      "self_attn.v_proj"):
                wl[n] = get(n)
        if fused_mlp:
            wl["mlp.gate_up_proj"] = (
                get("mlp.gate_up_proj") if cfg.fuse_mlp
                else torch.cat([get("mlp.gate_proj"), get("mlp.up_proj")],
                               dim=-1))
        elif cfg.fuse_mlp:
            gu = get("mlp.gate_up_proj")
            wl["mlp.gate_proj"] = gu[..., :m]
            wl["mlp.up_proj"] = gu[..., m:]
        else:
            wl["mlp.gate_proj"] = get("mlp.gate_proj")
            wl["mlp.up_proj"] = get("mlp.up_proj")
        out.append(wl)
    return out


def _rms(x, w, eps):
    """RMSNorm for the serving paths: always the kernel wrapper. Its CPU
    route `_plain` is the same float expression the reference inlines
    under FLAGS_fused_transformer=0, so the flag has nothing to pick."""
    return krn.rms_norm(x, w, eps)


def _serving_mlp(a2, wl):
    """SwiGLU for the serving blocks: the kernel over the wide gate_up
    layout, else (FLAGS_fused_transformer=0 on the CPU only, see
    `_gather_layer_weights`) the reference's unfused expression."""
    if "mlp.gate_up_proj" in wl:
        return ksw.swiglu(a2, wl["mlp.gate_up_proj"])
    return (torch.nn.functional.silu(a2 @ wl["mlp.gate_proj"])
            * (a2 @ wl["mlp.up_proj"]))


def _block_ragged(cfg, h, wl, kp, vp, pos, page_ids, offs, page_table,
                  q_start, q_len, kv_len):
    """One decoder layer over packed ragged rows against the page pool.

    h: [T, H] packed rows; kp/vp: [kvh, P, page, d] (this layer's pool,
    written IN PLACE); pos: i32[T] absolute positions; page_ids/offs:
    i32[T] page id + in-page offset for each row's KV write (padding
    rows carry page 0 = scratch); page_table: i32[B, ppmax];
    q_start/q_len/kv_len: i32[B] (kv_len includes this step's rows).
    Returns h."""
    T = h.shape[0]
    nh, kvh, d = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
    a = _rms(h, wl["input_layernorm.weight"], cfg.rms_norm_eps)
    max_pos = max(cfg.max_position_embeddings,
                  page_table.shape[1] * kp.shape[2])
    if "self_attn.qkv_proj" in wl:
        q, k, v = krope.fused_qkv_rope(a, wl["self_attn.qkv_proj"], nh, kvh,
                                       d, position_ids=pos,
                                       base=cfg.rope_theta, seq_len=max_pos)
    else:
        q = (a @ wl["self_attn.q_proj"]).reshape(T, nh, d)
        k = (a @ wl["self_attn.k_proj"]).reshape(T, kvh, d)
        v = (a @ wl["self_attn.v_proj"]).reshape(T, kvh, d)
        q4, k4 = krope.apply_rope(q[None], k[None], position_ids=pos[None],
                                  base=cfg.rope_theta, seq_len=max_pos)
        q, k = q4[0], k4[0]
    # ONE T-row page write per layer (prefill chunks and decode tokens
    # alike); duplicate scratch-page writes from padding rows are benign
    pid, off = page_ids.long(), offs.long()
    kp[:, pid, off] = k.transpose(0, 1).to(kp.dtype)
    vp[:, pid, off] = v.transpose(0, 1).to(vp.dtype)
    o = krpa.ragged_paged_attention(q, kp, vp, q_start, q_len, kv_len,
                                    page_table, scale=1.0 / math.sqrt(d))
    h = h + o.to(h.dtype).reshape(T, nh * d) @ wl["self_attn.o_proj"]
    a2 = _rms(h, wl["post_attention_layernorm.weight"], cfg.rms_norm_eps)
    up = _serving_mlp(a2, wl)
    return h + up @ wl["mlp.down_proj"]


@torch.no_grad()
def _ragged_step_paged(state, cfg, toks, pos, k_pool, v_pool, page_ids,
                       offs, page_table, q_start, q_len, kv_len,
                       verify_rows=None, wls=None):
    """Mixed prefill-chunk + decode rows in ONE step over the page pool.

    toks/pos/page_ids/offs: i32[T] packed rows (padding rows: token 0,
    page 0); k/v_pool: [L, kvh, P, page, d], written in place;
    page_table: i32[B, ppmax]; q_start/q_len/kv_len: i32[B]. Returns
    (last_logits[B, V] f32, k_pool, v_pool); last_logits[b] is the
    logits at sequence b's LAST packed row (garbage for q_len == 0
    slots — callers mask). `wls` passes pre-gathered per-layer weights
    (`_gather_layer_weights`) so a caller stepping repeatedly gathers
    once. The speculative `verify_rows` branch is not ported yet."""
    if verify_rows:
        raise NotImplementedError(
            "verify_rows (speculative verification) is not ported yet")
    T = toks.shape[0]
    emb = state["model.embed_tokens"]
    h = emb[toks.long()]                                     # [T, H]
    if wls is None:
        wls = _gather_layer_weights(state, cfg)
    for li, wl in enumerate(wls):
        h = _block_ragged(cfg, h, wl, k_pool[li], v_pool[li], pos, page_ids,
                          offs, page_table, q_start, q_len, kv_len)
    h = _rms(h, state["model.norm.weight"], cfg.rms_norm_eps)
    # rank-3 matmul, as in the reference (its parity note: the batched
    # form is what every other decode path uses)
    last = torch.clamp(q_start.long() + q_len.long() - 1, 0, T - 1)
    h_last = h[last][:, None]                                # [B, 1, H]
    if "lm_head" in state:
        logits = h_last @ state["lm_head"]
    else:
        logits = h_last @ emb.transpose(0, 1)
    return logits.float()[:, 0], k_pool, v_pool


def llama_tiny(**kw):
    return LlamaConfig(vocab_size=1024, hidden_size=256, intermediate_size=688,
                       num_hidden_layers=2, num_attention_heads=4,
                       max_position_embeddings=512, **kw)


def llama_350m(**kw):
    return LlamaConfig(vocab_size=32000, hidden_size=1024,
                       intermediate_size=2816, num_hidden_layers=24,
                       num_attention_heads=16, **kw)


def llama_1b(**kw):
    return LlamaConfig(vocab_size=32000, hidden_size=2048,
                       intermediate_size=5504, num_hidden_layers=22,
                       num_attention_heads=16, **kw)


def llama_7b(**kw):
    return LlamaConfig(vocab_size=32000, hidden_size=4096,
                       intermediate_size=11008, num_hidden_layers=32,
                       num_attention_heads=32, **kw)
