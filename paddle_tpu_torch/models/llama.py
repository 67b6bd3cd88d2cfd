"""LLaMA family (counterpart of paddle_tpu/models/llama.py): the
training forward and the serving step.

`LlamaForCausalLM` is an `nn.Module` holding parameters whose
`state_dict()` keys and shapes match the JAX model's one to one, in the
same `[in, out]` layout (`a @ W`): `model.embed_tokens`,
`model.layers.{i}.self_attn.qkv_proj` (or q/k/v_proj unfused),
`…self_attn.o_proj`, `…mlp.gate_up_proj` (or gate/up_proj),
`…mlp.down_proj`, `…input_layernorm.weight`,
`…post_attention_layernorm.weight`, `model.norm.weight`, `lm_head`.
Norm weights stay f32 in a bf16 model, as in the reference.

Training: `forward(ids)` -> logits and `loss(ids, labels)` (shifted
next-token CE in f32) mirror the reference's l.97-313 and l.423-457
module for module. Each decoder layer runs `rms_norm`, the fused
QKV+RoPE prologue, `flash_attention_bshd` (causal), the o projection,
`fused_add_rms_norm` and `swiglu`; the layer stack is a Python loop
(the reference's `lax.scan` over stacked weights computes the same
values). With `use_recompute=True` under autograd each decoder layer
is rematerialised (`framework.remat.checkpoint`, the counterpart of
the reference's `jax.checkpoint` per layer) under the policy
`jit.TrainStep` arms, save-nothing when none is armed; the layer's
matmuls and its SwiGLU kernel are the remat sites the policy names
(`MATMUL_CHECKPOINT_NAMES`, `DOT_CHECKPOINT_NAMES`). Sequence
parallelism and explicit position ids are not ported and raise.

Serving: `_ragged_step_paged` runs the chunked-prefill / decode mix
over the paged KV pool with the reference's float order;
`_forward_with_cache` (prefill, or one decode token through
`paged_decode_attention` over page views of the cache) runs over a
contiguous [L, B, S_max, kvh, d] cache, and `_decode_step_paged` runs
one decode token per slot over the page pool through
`paged_decode_attention`.
Every KV write is an in-place index write into the cache or pool
tensors (the reference rebuilds or donates them under XLA instead).
`LlamaForCausalLM.generate` is the model's own generation API over
`_forward_with_cache`, as an eager Python loop.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..framework import core
from ..framework import remat
from ..framework.core import resolve_device
from ..kernels import flash_attention as kfa
from ..kernels import fused_norm_residual as kfnr
from ..kernels import paged_attention as kpa
from ..kernels import ragged_paged_attention as krpa
from ..kernels import rms_norm as krn
from ..kernels import rope as krope
from ..kernels import swiglu as ksw
from ..kernels import weight_only_linear as kwol
from ..nn.functional import loss as floss

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM", "llama_tiny",
           "llama_350m", "llama_1b", "llama_7b", "MATMUL_CHECKPOINT_NAMES",
           "DOT_CHECKPOINT_NAMES"]

# the remat sites of the FLAGS_fused_transformer hot path, stamped with
# these names in the reference too (its l.41-43): what jit.TrainStep's
# default remat_policy="save_matmul_outputs" keeps across the backward,
# so norms, rope and the attention forward recompute instead
MATMUL_CHECKPOINT_NAMES = ("llama_qkv", "llama_attn_o", "llama_swiglu",
                           "llama_mlp_down")
# every plain matmul of a decoder layer, which remat_policy="dots" keeps
# (the reference's checkpoint_dots): the stamped three, and the unfused
# routes' projections, which the reference leaves unstamped. The SwiGLU
# kernel is not among them
DOT_CHECKPOINT_NAMES = ("llama_qkv", "llama_attn_o", "llama_mlp_down",
                        "llama_qkv_proj", "llama_q_proj", "llama_k_proj",
                        "llama_v_proj", "llama_o_proj", "llama_gate_up_proj",
                        "llama_gate_proj", "llama_up_proj",
                        "llama_down_proj")


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
    # the training forward refuses sequence_parallel (not ported), the
    # serving half reads none of them
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


torch_dtype = core.convert_dtype


def _param(shape, device, dtype, generator, std=0.02, const=None):
    t = torch.empty(shape, device=device, dtype=dtype)
    if const is not None:
        t.fill_(const)
    else:
        t.normal_(0.0, std, generator=generator)
    return nn.Parameter(t)


def _fused_flag():
    return core.get_bool_flag("FLAGS_fused_transformer", True)


class LlamaRMSNorm(nn.Module):
    def __init__(self, hidden, eps, device):
        super().__init__()
        self.eps = eps
        self.weight = _param((hidden,), device, torch.float32, None,
                             const=1.0)

    def forward(self, x):
        return krn.rms_norm(x, self.weight, self.eps)


def _attention_core(q, k, v):
    """The reference's `_core`: flash attention, causal. On the CPU the
    wrapper runs the dense `_sdpa` the reference runs there; the card
    runs the kernels and refuses the dense ablation
    (FLAGS_use_flash_attention=0)."""
    if (q.device.type != "cpu"
            and not core.get_bool_flag("FLAGS_use_flash_attention", True)):
        raise NotImplementedError(
            "FLAGS_use_flash_attention=0 selects the reference's dense "
            "attention, which the port does not run on the card")
    return kfa.flash_attention_bshd(q, k, v, causal=True)


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
        self.cfg = cfg

    def forward(self, x):
        cfg = self.cfg
        B = x.shape[0]
        nh, kvh, d = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
        mm = remat.matmul
        if cfg.fuse_attention_qkv and _fused_flag():
            # fused QKV+RoPE prologue: one wide projection (the remat
            # site llama_qkv), rope on the q/k slices
            q, k, v = krope.fused_qkv_rope(x, self.qkv_proj, nh, kvh, d,
                                           base=cfg.rope_theta)
            o = _attention_core(q, k, v)
            return mm(o.reshape(B, -1, nh * d), self.o_proj, "llama_attn_o")
        if cfg.fuse_attention_qkv:
            qkv = mm(x, self.qkv_proj, "llama_qkv_proj")
            q = qkv[..., : nh * d]
            k = qkv[..., nh * d: (nh + kvh) * d]
            v = qkv[..., (nh + kvh) * d:]
        else:
            q, k, v = (mm(x, self.q_proj, "llama_q_proj"),
                       mm(x, self.k_proj, "llama_k_proj"),
                       mm(x, self.v_proj, "llama_v_proj"))
        q = q.reshape(B, -1, nh, d)
        k = k.reshape(B, -1, kvh, d)
        v = v.reshape(B, -1, kvh, d)
        q, k = krope.apply_rope(q, k, base=cfg.rope_theta)
        o = _attention_core(q, k, v)
        return mm(o.reshape(B, -1, nh * d), self.o_proj, "llama_o_proj")


class LlamaMLP(nn.Module):
    def __init__(self, cfg, device, dtype, g):
        super().__init__()
        h, m = cfg.hidden_size, cfg.intermediate_size
        self._m = m
        self._fused = cfg.fuse_mlp
        if cfg.fuse_mlp:
            self.gate_up_proj = _param((h, 2 * m), device, dtype, g)
        else:
            self.gate_proj = _param((h, m), device, dtype, g)
            self.up_proj = _param((h, m), device, dtype, g)
        self.down_proj = _param((m, h), device, dtype, g)

    def forward(self, x):
        """SwiGLU then the down projection. The card always runs the
        SwiGLU kernel (over the wide [Wg | Wu] layout, concatenated for
        an unfused config); the reference's unfused expressions run on
        the CPU only, under FLAGS_fused_transformer=0 or an unfused
        config, as in the serving blocks. The fused route's SwiGLU and
        down projection are the remat sites llama_swiglu and
        llama_mlp_down, as the reference stamps them (its l.225-231)."""
        on_cpu = x.device.type == "cpu"
        mm = remat.matmul
        if self._fused and (_fused_flag() or not on_cpu):
            act = remat.site("llama_swiglu", ksw.swiglu, x,
                             self.gate_up_proj)
            return mm(act, self.down_proj, "llama_mlp_down")
        if self._fused:
            gu = mm(x, self.gate_up_proj, "llama_gate_up_proj")
            act = (torch.nn.functional.silu(gu[..., :self._m])
                   * gu[..., self._m:])
        elif on_cpu:
            act = (torch.nn.functional.silu(mm(x, self.gate_proj,
                                               "llama_gate_proj"))
                   * mm(x, self.up_proj, "llama_up_proj"))
        else:
            act = ksw.swiglu(x, torch.cat([self.gate_proj, self.up_proj],
                                          dim=-1))
        return mm(act, self.down_proj, "llama_down_proj")


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg, device, dtype, g):
        super().__init__()
        self.input_layernorm = LlamaRMSNorm(cfg.hidden_size,
                                            cfg.rms_norm_eps, device)
        self.self_attn = LlamaAttention(cfg, device, dtype, g)
        self.post_attention_layernorm = LlamaRMSNorm(
            cfg.hidden_size, cfg.rms_norm_eps, device)
        self.mlp = LlamaMLP(cfg, device, dtype, g)

    def forward(self, x):
        attn_out = self.self_attn(self.input_layernorm(x))
        if _fused_flag() or x.device.type != "cpu":
            # the residual add and the post-attention norm in one pass
            # that emits both the normed a2 and the summed stream h (the
            # card always runs the kernel; the unfused expression is the
            # CPU's kill-switch parity route)
            norm = self.post_attention_layernorm
            a2, h = kfnr.fused_add_rms_norm(x, attn_out, norm.weight,
                                            norm.eps)
            return h + self.mlp(a2)
        h = x + attn_out
        return h + self.mlp(self.post_attention_layernorm(h))


class LlamaModel(nn.Module):
    def __init__(self, cfg, device, dtype, g):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = _param((cfg.vocab_size, cfg.hidden_size),
                                   device, dtype, g)
        self.layers = nn.ModuleList([LlamaDecoderLayer(cfg, device, dtype, g)
                                     for _ in range(cfg.num_hidden_layers)])
        self.norm = LlamaRMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device)

    def forward(self, input_ids, position_ids=None):
        cfg = self.cfg
        if position_ids is not None:
            raise NotImplementedError(
                "LlamaModel.forward(position_ids=...) is not ported yet")
        if cfg.sequence_parallel:
            raise NotImplementedError(
                "sequence_parallel is not ported yet")
        x = torch.nn.functional.embedding(input_ids.long(),
                                          self.embed_tokens)
        if cfg.use_recompute and torch.is_grad_enabled():
            # per-layer remat (the reference's _scan_stack/_recompute_stack
            # with jax.checkpoint on each layer) under the armed policy
            policy = core.current_remat_policy()
            for lyr in self.layers:
                x = remat.checkpoint(lyr, x, policy)
        else:
            for lyr in self.layers:
                x = lyr(x)
        return self.norm(x)


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
    """The causal LM: `forward`/`loss` for training; the serving step is a
    set of functions over the state dict, as in the reference. Weights
    are drawn N(0, 0.02) from `generator` (a torch.Generator on
    `device`; None = torch's default generator for that device), norms
    are ones in f32."""

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

    def forward(self, input_ids, position_ids=None):
        h = self.model(input_ids, position_ids)
        if self.lm_head is not None:
            return h @ self.lm_head
        return h @ self.model.embed_tokens.transpose(0, 1)

    def loss(self, input_ids, labels):
        """Shifted next-token CE in f32, mean over the non-ignored
        labels."""
        logits = self(input_ids)
        V = logits.shape[-1]
        lg = logits[:, :-1, :].reshape(-1, V)
        lb = labels[:, 1:].reshape(-1)
        return floss.cross_entropy(lg, lb, ignore_index=-100)

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32, max_length=None,
                 eos_token_id=None, do_sample=False, temperature=1.0,
                 top_k=0, seed=0, use_cache=True):
        """KV-cache generation: one prefill over the prompt, then one
        decode step per new token (`_forward_with_cache`; each decode
        step's attention is the paged decode kernel over views of the
        cache). Greedy when do_sample=False; max_length caps prompt +
        new tokens; after eos_token_id a row keeps emitting it. Returns
        the generated ids [B, max_new_tokens] int32 on the model's
        device.

        Eager, like the rest of the port: a Python loop over the steps
        (the reference compiles a prefill and a `lax.scan` decode).
        Sampling draws from a `torch.Generator` on the model's device
        seeded with `seed`: reproducible per seed, but not the
        `jax.random` draws the reference makes from the same seed.
        `use_cache` is accepted and, as in the reference, not read."""
        cfg = self.cfg
        dev = self.device
        ids = torch.as_tensor(input_ids).to(device=dev, dtype=torch.int32)
        B, T0 = ids.shape
        if max_length is not None:
            # total-length cap (paddle/HF semantics)
            max_new_tokens = min(max_new_tokens, max(int(max_length) - T0, 1))
        # page-rounded, so the decode steps read the cache in place; the
        # slots past T0 + max_new_tokens are masked like any unwritten one
        page = kpa._PAGE
        S_max = -(-(T0 + max_new_tokens) // page) * page
        state = dict(self.state_dict())
        wls = _gather_layer_weights(state, cfg)
        L, kvh, d = cfg.num_hidden_layers, cfg.kv_heads, cfg.head_dim
        dtype = state["model.embed_tokens"].dtype
        cache_k = torch.zeros((L, B, S_max, kvh, d), dtype=dtype, device=dev)
        cache_v = torch.zeros_like(cache_k)
        eos = -1 if eos_token_id is None else int(eos_token_id)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))

        def pick(logits):
            if do_sample:
                lg = logits / max(temperature, 1e-6)
                if top_k:
                    kth = torch.topk(lg, int(top_k), dim=-1).values[..., -1:]
                    lg = lg.masked_fill(lg < kth, float("-inf"))
                return torch.multinomial(torch.softmax(lg, dim=-1), 1,
                                         generator=gen)[:, 0].to(torch.int32)
            return torch.argmax(logits, dim=-1).to(torch.int32)

        zeros = torch.zeros((B,), dtype=torch.int32, device=dev)
        logits, _, _ = _forward_with_cache(state, cfg, ids, cache_k, cache_v,
                                           zeros, wls=wls)
        tok = pick(logits[:, -1])
        out = [tok]
        # the FIRST token may already be EOS
        done = tok == eos
        cur = torch.full((B,), T0, dtype=torch.int32, device=dev)
        for _ in range(max_new_tokens - 1):
            logits, _, _ = _forward_with_cache(state, cfg, tok[:, None],
                                               cache_k, cache_v, cur, wls=wls)
            nxt = pick(logits[:, -1])
            tok = torch.where(done, max(eos, 0), nxt).to(torch.int32)
            done = done | (tok == eos)
            out.append(tok)
            cur = cur + 1
        return torch.stack(out, dim=1)


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
                else _cat([get("self_attn.q_proj"), get("self_attn.k_proj"),
                           get("self_attn.v_proj")]))
        elif cfg.fuse_attention_qkv:
            qkv = get("self_attn.qkv_proj")
            wl["self_attn.q_proj"] = _cols(qkv, 0, nh * d)
            wl["self_attn.k_proj"] = _cols(qkv, nh * d, (nh + kvh) * d)
            wl["self_attn.v_proj"] = _cols(qkv, (nh + kvh) * d,
                                           (nh + 2 * kvh) * d)
        else:
            for n in ("self_attn.q_proj", "self_attn.k_proj",
                      "self_attn.v_proj"):
                wl[n] = get(n)
        if fused_mlp:
            wl["mlp.gate_up_proj"] = (
                get("mlp.gate_up_proj") if cfg.fuse_mlp
                else _cat([get("mlp.gate_proj"), get("mlp.up_proj")]))
        elif cfg.fuse_mlp:
            gu = get("mlp.gate_up_proj")
            wl["mlp.gate_proj"] = _cols(gu, 0, m)
            wl["mlp.up_proj"] = _cols(gu, m, 2 * m)
        else:
            wl["mlp.gate_proj"] = get("mlp.gate_proj")
            wl["mlp.up_proj"] = get("mlp.up_proj")
        out.append(wl)
    return out


def _cat(parts):
    """Column concatenation of weights, or of int8 weights with their
    per-column scales (`QuantWeight.cat`)."""
    if isinstance(parts[0], kwol.QuantWeight):
        return kwol.QuantWeight.cat(parts)
    return torch.cat(parts, dim=-1)


def _cols(w, start, stop):
    """Columns [start, stop) of a weight or an int8 weight."""
    if isinstance(w, kwol.QuantWeight):
        return w.columns(start, stop)
    return w[..., start:stop]


def _rms(x, w, eps):
    """RMSNorm for the serving paths: always the kernel wrapper. Its CPU
    route `_plain` is the same float expression the reference inlines
    under FLAGS_fused_transformer=0, so the flag has nothing to pick."""
    return krn.rms_norm(x, w, eps)


def _serving_mlp(a2, wl):
    """SwiGLU for the serving blocks: the kernel over the wide gate_up
    layout (an int8 gate_up: the W8A16 kernel's SwiGLU epilogue), else
    (FLAGS_fused_transformer=0 on the CPU only, see
    `_gather_layer_weights`) the reference's unfused expression."""
    if "mlp.gate_up_proj" in wl:
        w = wl["mlp.gate_up_proj"]
        if isinstance(w, kwol.QuantWeight):
            return kwol.weight_only_linear(a2, w.q, w.scale, swiglu=True)
        return ksw.swiglu(a2, w)
    return (torch.nn.functional.silu(kwol.matmul(a2, wl["mlp.gate_proj"]))
            * kwol.matmul(a2, wl["mlp.up_proj"]))


def _qkv(cfg, a, wl, pos_ids, max_pos):
    """The serving blocks' projection + rope: a [B, T, H] ->
    q [B, T, nh, d], k and v [B, T, kvh, d]."""
    B, T = a.shape[0], a.shape[1]
    nh, kvh, d = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
    if "self_attn.qkv_proj" in wl:     # FLAGS_fused_transformer layout
        return krope.fused_qkv_rope(a, wl["self_attn.qkv_proj"], nh, kvh, d,
                                    position_ids=pos_ids,
                                    base=cfg.rope_theta, seq_len=max_pos)
    q = kwol.matmul(a, wl["self_attn.q_proj"]).reshape(B, T, nh, d)
    k = kwol.matmul(a, wl["self_attn.k_proj"]).reshape(B, T, kvh, d)
    v = kwol.matmul(a, wl["self_attn.v_proj"]).reshape(B, T, kvh, d)
    q, k = krope.apply_rope(q, k, position_ids=pos_ids, base=cfg.rope_theta,
                            seq_len=max_pos)
    return q, k, v


def _block_with_cache(cfg, h, wl, ck, cv, pos_ids, cache_mask, paged=None):
    """One decoder layer over tokens at pos_ids with a KV cache.

    h: [B, T, H]; ck/cv: [B, S_max, kvh, d] (this layer's cache, written
    IN PLACE); pos_ids: [B, T] absolute positions; cache_mask: [B, S_max]
    bool — which cache slots are valid AFTER this step's keys are
    written. Returns h. Decode (T == 1) runs the paged decode kernel over
    views of the cache: `paged` = (k_pages, v_pages, lengths,
    page_indices) of this layer, built once per step by the caller, or
    None when S_max is no page multiple (`decode_attention` pads a copy,
    as the reference does). Prefill is the reference's dense f32 masked
    softmax (it has no Pallas kernel there)."""
    B, T = h.shape[0], h.shape[1]
    nh, kvh, d = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
    a = _rms(h, wl["input_layernorm.weight"], cfg.rms_norm_eps)
    max_pos = max(cfg.max_position_embeddings, ck.shape[1])
    q, k, v = _qkv(cfg, a, wl, pos_ids, max_pos)
    # the new keys/values at their absolute positions: an index write
    # (the reference's one-hot einsum gives the same values bit for bit)
    bi = torch.arange(B, device=h.device)[:, None].expand(B, T)
    pi = pos_ids.long()
    ck[bi, pi] = k.to(ck.dtype)
    cv[bi, pi] = v.to(cv.dtype)
    if T == 1:
        if paged is None:
            lengths = (pos_ids[:, 0] + 1).to(torch.int32)  # incl. this token
            o = kpa.decode_attention(q, ck, cv, lengths,
                                     scale=1.0 / math.sqrt(d))[:, 0]
        else:
            o = kpa.paged_decode_attention(q[:, 0], *paged,
                                           scale=1.0 / math.sqrt(d))
        o = o.to(h.dtype).reshape(B, T, nh * d)
    else:
        if kvh != nh:
            rep = nh // kvh
            kk = torch.repeat_interleave(ck, rep, dim=2)
            vv = torch.repeat_interleave(cv, rep, dim=2)
        else:
            kk, vv = ck, cv
        s = torch.einsum("bthd,bshd->bhts", q.float(),
                         kk.float()) / math.sqrt(d)
        causal = (pos_ids[:, :, None]
                  >= torch.arange(ck.shape[1], device=h.device)[None, None])
        valid = causal & cache_mask[:, None, :]          # [B, T, S_max]
        s = s.masked_fill(~valid[:, None], float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhts,bshd->bthd", p, vv.float())
        o = o.to(h.dtype).reshape(B, T, nh * d)
    h = h + kwol.matmul(o, wl["self_attn.o_proj"])
    a2 = _rms(h, wl["post_attention_layernorm.weight"], cfg.rms_norm_eps)
    up = _serving_mlp(a2, wl)
    return h + kwol.matmul(up, wl["mlp.down_proj"])


def _lm_head(state, h):
    """h [..., H] -> logits in the weights' dtype (the tied embedding
    when the state has no lm_head; an int8 lm_head through the W8A16
    kernel)."""
    if "lm_head" in state:
        return kwol.matmul(h, state["lm_head"])
    return h @ state["model.embed_tokens"].transpose(0, 1)


@torch.no_grad()
def _forward_with_cache(state, cfg, ids, cache_k, cache_v, cur_len,
                        wls=None):
    """ids: [B, T] new tokens (T = prompt at prefill, 1 at decode);
    cache_k/v: [L, B, S_max, kvh, d], written in place; cur_len: i32[B]
    tokens already cached. Returns (logits[B, T, V] f32, cache_k,
    cache_v). `wls`: pre-gathered per-layer weights."""
    B, T = ids.shape
    S_max = cache_k.shape[2]
    dev = ids.device
    h = state["model.embed_tokens"][ids.long()]
    cur = cur_len.to(device=dev, dtype=torch.int32)
    pos_ids = cur[:, None] + torch.arange(T, dtype=torch.int32,
                                          device=dev)[None, :]
    cache_mask = (torch.arange(S_max, device=dev)[None, :]
                  < (cur + T)[:, None])
    if wls is None:
        wls = _gather_layer_weights(state, cfg)
    kps = None
    if T == 1 and S_max % kpa._PAGE == 0:
        # decode: every layer's page views of the cache (no copy), the
        # block table and the lengths (incl. this token), once per step
        kps, vps, pidx = kpa.paginate_cache(cache_k, cache_v)
        lengths = cur + 1
    for li, wl in enumerate(wls):
        paged = None if kps is None else (kps[li], vps[li], lengths, pidx)
        h = _block_with_cache(cfg, h, wl, cache_k[li], cache_v[li], pos_ids,
                              cache_mask, paged)
    h = _rms(h, state["model.norm.weight"], cfg.rms_norm_eps)
    return _lm_head(state, h).float(), cache_k, cache_v


def _block_paged(cfg, h, wl, kp, vp, pos_ids, pg, off, page_table, lens):
    """One decoder layer for a single-token decode over the page pool.

    h: [B, 1, H]; kp/vp: [kvh, P, page, d] (this layer's pool, written IN
    PLACE); pos_ids: [B, 1]; pg/off: i32[B] page id + in-page offset for
    this token's KV write; page_table: i32[B, ppmax]; lens: i32[B] tokens
    cached BEFORE this step. Returns h."""
    B = h.shape[0]
    nh, d = cfg.num_attention_heads, cfg.head_dim
    a = _rms(h, wl["input_layernorm.weight"], cfg.rms_norm_eps)
    max_pos = max(cfg.max_position_embeddings,
                  page_table.shape[1] * kp.shape[2])
    q, k, v = _qkv(cfg, a, wl, pos_ids, max_pos)
    # this token's k/v into page (pg[b], off[b]): a B-row write
    pg_, off_ = pg.long(), off.long()
    kp[:, pg_, off_] = k[:, 0].transpose(0, 1).to(kp.dtype)
    vp[:, pg_, off_] = v[:, 0].transpose(0, 1).to(vp.dtype)
    o = kpa.paged_decode_attention(q[:, 0], kp, vp,
                                   (lens + 1).to(torch.int32), page_table,
                                   scale=1.0 / math.sqrt(d))
    h = h + kwol.matmul(o.to(h.dtype).reshape(B, 1, nh * d),
                        wl["self_attn.o_proj"])
    a2 = _rms(h, wl["post_attention_layernorm.weight"], cfg.rms_norm_eps)
    up = _serving_mlp(a2, wl)
    return h + kwol.matmul(up, wl["mlp.down_proj"])


@torch.no_grad()
def _decode_step_paged(state, cfg, toks, k_pool, v_pool, page_table, lens,
                       active, wls=None):
    """One decode token for every slot over the shared page pool.

    toks: i32[B]; k/v_pool: [L, kvh, P, page, d], written in place;
    page_table: i32[B, ppmax] (page ids per slot, unused entries 0 =
    scratch); lens: i32[B] tokens already cached; active: bool[B].
    Inactive slots write the scratch page, attend to one token of it and
    their logits are ignored by the caller. Returns (logits[B, V] f32
    for the new token, k_pool, v_pool)."""
    h = state["model.embed_tokens"][toks.long()][:, None]   # [B, 1, H]
    lens = torch.where(active, lens, 0).to(torch.int32)
    pos_ids = lens[:, None]
    page = k_pool.shape[3]
    pg = torch.gather(page_table, 1, (lens // page)[:, None].long())[:, 0]
    pg = torch.where(active, pg, 0)                  # scratch for inactive
    off = lens % page
    if wls is None:
        wls = _gather_layer_weights(state, cfg)
    for li, wl in enumerate(wls):
        h = _block_paged(cfg, h, wl, k_pool[li], v_pool[li], pos_ids, pg,
                         off, page_table, lens)
    h = _rms(h, state["model.norm.weight"], cfg.rms_norm_eps)
    # rank-3 matmul h[B, 1, H] @ W, as the reference (greedy ties)
    return _lm_head(state, h).float()[:, 0], k_pool, v_pool


def _block_ragged(cfg, h, wl, kp, vp, pos, page_ids, offs, page_table,
                  q_start, q_len, kv_len, row_tiles=None):
    """One decoder layer over packed ragged rows against the page pool.

    h: [T, H] packed rows; kp/vp: [kvh, P, page, d] (this layer's pool,
    written IN PLACE); pos: i32[T] absolute positions; page_ids/offs:
    i32[T] page id + in-page offset for each row's KV write (padding
    rows carry page 0 = scratch); page_table: i32[B, ppmax];
    q_start/q_len/kv_len: i32[B] (kv_len includes this step's rows);
    row_tiles: the attention kernel's per-row tiling flags (None: off).
    Returns h."""
    T = h.shape[0]
    nh, d = cfg.num_attention_heads, cfg.head_dim
    a = _rms(h, wl["input_layernorm.weight"], cfg.rms_norm_eps)
    max_pos = max(cfg.max_position_embeddings,
                  page_table.shape[1] * kp.shape[2])
    q, k, v = (t[0] for t in _qkv(cfg, a[None], wl, pos[None], max_pos))
    # ONE T-row page write per layer (prefill chunks and decode tokens
    # alike); duplicate scratch-page writes from padding rows are benign
    pid, off = page_ids.long(), offs.long()
    kp[:, pid, off] = k.transpose(0, 1).to(kp.dtype)
    vp[:, pid, off] = v.transpose(0, 1).to(vp.dtype)
    o = krpa.ragged_paged_attention(q, kp, vp, q_start, q_len, kv_len,
                                    page_table, scale=1.0 / math.sqrt(d),
                                    row_tiles=row_tiles)
    h = h + kwol.matmul(o.to(h.dtype).reshape(T, nh * d),
                        wl["self_attn.o_proj"])
    a2 = _rms(h, wl["post_attention_layernorm.weight"], cfg.rms_norm_eps)
    up = _serving_mlp(a2, wl)
    return h + kwol.matmul(up, wl["mlp.down_proj"])


@torch.no_grad()
def _ragged_step_paged(state, cfg, toks, pos, k_pool, v_pool, page_ids,
                       offs, page_table, q_start, q_len, kv_len,
                       verify_rows=None, wls=None, row_tiles=None):
    """Mixed prefill-chunk + decode rows in ONE step over the page pool.

    toks/pos/page_ids/offs: i32[T] packed rows (padding rows: token 0,
    page 0); k/v_pool: [L, kvh, P, page, d], written in place;
    page_table: i32[B, ppmax]; q_start/q_len/kv_len: i32[B]. Returns
    (last_logits[B, V] f32, k_pool, v_pool); last_logits[b] is the
    logits at sequence b's LAST packed row (garbage for q_len == 0
    slots — callers mask). `wls` passes pre-gathered per-layer weights
    (`_gather_layer_weights`) so a caller stepping repeatedly gathers
    once.

    verify_rows=K (speculation armed): returns f32 logits [B, K, V] for
    each sequence's LAST min(K, q_len) packed rows instead, right-
    aligned (slot K-1 is the last row; short sequences repeat their
    first row in the unused leading slots — callers mask). Each slot is
    its own lm-head product of the last-row branch's [B, 1, H] shape,
    so a row's logits are bitwise what that branch gives for the same
    row. row_tiles: bool/i32[B], the sequences (decode and verify
    entries) whose every row the attention kernel tiles as a q_len = 1
    decode row, so that a verify row is bitwise a decode row."""
    h = state["model.embed_tokens"][toks.long()]             # [T, H]
    if wls is None:
        wls = _gather_layer_weights(state, cfg)
    if row_tiles is not None:
        row_tiles = row_tiles.to(torch.int32)   # once, not once a layer
    for li, wl in enumerate(wls):
        h = _block_ragged(cfg, h, wl, k_pool[li], v_pool[li], pos, page_ids,
                          offs, page_table, q_start, q_len, kv_len,
                          row_tiles)
    h = _rms(h, state["model.norm.weight"], cfg.rms_norm_eps)
    if verify_rows:
        return _verify_logits(state, h, q_start, q_len,
                              int(verify_rows)), k_pool, v_pool
    return _last_row_logits(state, h, q_start, q_len), k_pool, v_pool


def _last_row_logits(state, h, q_start, q_len):
    """f32 logits [B, V] of each sequence's last packed row of h [T, H]:
    one rank-3 product [B, 1, H] @ W, as in the reference (its parity
    note: the batched form is what every other decode path uses)."""
    last = torch.clamp(q_start.long() + q_len.long() - 1, 0, h.shape[0] - 1)
    return _lm_head(state, h[last][:, None]).float()[:, 0]


def _verify_logits(state, h, q_start, q_len, K):
    """f32 logits [B, K, V] of each sequence's last min(K, q_len) packed
    rows of h [T, H], right-aligned. K products of `_last_row_logits`'
    [B, 1, H] shape, not one of [B * K, 1, H], whose algorithm may follow
    its row count: slot i of sequence b is bitwise the last-row logits
    of that row."""
    j = torch.arange(K, device=h.device)
    rows = q_start.long()[:, None] + torch.clamp(
        q_len.long()[:, None] - K + j[None, :], min=0)
    rows = torch.clamp(rows, 0, h.shape[0] - 1)              # [B, K]
    return torch.stack([_lm_head(state, h[rows[:, i]][:, None])
                        .float()[:, 0] for i in range(K)], dim=1)


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
