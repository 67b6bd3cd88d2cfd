"""The port's `incubate.nn` layers, `fused_multi_transformer` and
`fused_ec_moe` against the JAX package's, in f32 on the CPU: every
layer with the reference layer's parameters carried across
(`models.convert.incubate_state_from_jax`), its forward in eval and in
training with the reference's dropout masks replayed
(`tests/_torch_masks.py`); a 3-step `FusedTransformerEncoderLayer`
trajectory at dropout 0 under SGD; `fused_multi_transformer`'s prefill
and two decode steps with caches (rotary by `apply_rope` and by
`rotary_embs`, post-LN, gelu / relu / swiglu, and (int8, scale) weight
pairs as tests/test_sparse_quant.py:199 builds them).

Tolerances: 1e-5 relative to the output's largest magnitude on values
(summation order), 1e-4 on grads and on the trajectory's weights."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.incubate.nn as JNN
import paddle_tpu.incubate.nn.functional as JIF
import paddle_tpu_torch.incubate.nn as TNN
import paddle_tpu_torch.incubate.nn.functional as TIF
from paddle_tpu_torch import optimizer as t_opt
from paddle_tpu_torch.models.convert import incubate_state_from_jax

from _torch_masks import SharedMasks
from _torch_threads import one_torch_thread  # noqa: F401,E402

PROD = 1e-5
GRAD = 1e-4


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a.numpy() if hasattr(a, "numpy") else a,
                                  jnp.float32))


def _rel(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def P(a):
    return paddle.to_tensor(a)


def T(a):
    return torch.from_numpy(np.array(a))


def _carry(jlayer, tlayer):
    """The reference layer's parameters into the port's."""
    np_state = {k: _np(v) for k, v in jlayer.state_dict().items()}
    tlayer.load_state_dict(incubate_state_from_jax(np_state, tlayer))
    return tlayer


# (reference class, port class, constructor args, inputs' shapes)
LAYERS = {
    "FusedLinear": ((16, 24), {}, [(3, 5, 16)]),
    "FusedLinear_t": ((16, 24), {"transpose_weight": True}, [(3, 5, 16)]),
    "FusedDropoutAdd": ((), {"p": 0.3}, [(4, 32), (4, 32)]),
    "FusedDropoutAdd_down": ((), {"p": 0.3, "mode": "downscale_in_infer"},
                             [(4, 32), (4, 32)]),
    "FusedBiasDropoutResidualLayerNorm": ((32,), {"dropout_rate": 0.2},
                                          [(2, 6, 32), (2, 6, 32)]),
    "FusedMultiHeadAttention": ((128, 2), {"dropout_rate": 0.1,
                                           "attn_dropout_rate": 0.2},
                                [(2, 8, 128)]),
    "FusedMultiHeadAttention_pre": ((128, 2), {
        "dropout_rate": 0.1, "attn_dropout_rate": 0.0,
        "normalize_before": True}, [(2, 8, 128)]),
    "FusedFeedForward": ((32, 64), {"dropout_rate": 0.1}, [(2, 6, 32)]),
    "FusedFeedForward_gelu_pre": ((32, 64), {
        "dropout_rate": 0.1, "activation": "gelu",
        "normalize_before": True}, [(2, 6, 32)]),
    "FusedTransformerEncoderLayer": ((128, 2, 256), {"dropout_rate": 0.1},
                                     [(2, 8, 128)]),
    "FusedEcMoe": ((16, 32, 4), {}, [(2, 8, 16)]),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
@pytest.mark.parametrize("training", [False, True])
def test_layer_forward(monkeypatch, name, training):
    masks = SharedMasks(monkeypatch)
    args, kw, shapes = LAYERS[name]
    cls = name.split("_")[0]
    paddle.seed(0)
    jl = getattr(JNN, cls)(*args, **kw)
    tl = _carry(jl, getattr(TNN, cls)(*args, device="cpu", **kw)
                if cls != "FusedDropoutAdd"
                else getattr(TNN, cls)(*args, **kw))
    if not training:
        jl.eval()
        tl.eval()
    rng = np.random.default_rng(1)
    xs = [_rand(rng, *s) for s in shapes]
    jo = jl(*[P(x) for x in xs])
    to = tl(*[T(x) for x in xs])
    assert masks.all_used()
    assert _rel(to, jo) <= PROD


def test_parameter_names_and_shapes():
    """Every layer's parameters carry the reference's names and shapes."""
    for name, (args, kw, _) in LAYERS.items():
        cls = name.split("_")[0]
        paddle.seed(0)
        jl = getattr(JNN, cls)(*args, **kw)
        tl = (getattr(TNN, cls)(*args, **kw) if cls == "FusedDropoutAdd"
              else getattr(TNN, cls)(*args, device="cpu", **kw))
        assert ({k: tuple(v.shape) for k, v in jl.state_dict().items()}
                == {k: tuple(v.shape) for k, v in tl.state_dict().items()})


def test_encoder_layer_trajectory():
    """3 SGD steps of a FusedTransformerEncoderLayer at dropout 0 in
    training mode (the flash route, autograd through row 10's Function):
    losses and every weight after each step against the reference's."""
    paddle.seed(0)
    args = (128, 2, 256)
    jl = JNN.FusedTransformerEncoderLayer(*args, dropout_rate=0.0)
    tl = _carry(jl, TNN.FusedTransformerEncoderLayer(*args, dropout_rate=0.0,
                                                     device="cpu"))
    jo_ = paddle.optimizer.SGD(learning_rate=0.05,
                               parameters=jl.parameters())
    to_ = t_opt.SGD(learning_rate=0.05, parameters=list(tl.parameters()))
    rng = np.random.default_rng(2)
    for step in range(3):
        x, g = _rand(rng, 2, 8, 128), _rand(rng, 2, 8, 128)
        jloss = (jl(P(x)) * P(g)).sum()
        jloss.backward()
        jo_.step()
        jo_.clear_grad()
        tloss = (tl(T(x)) * T(g)).sum()
        tloss.backward()
        to_.step()
        to_.clear_grad()
        assert abs(float(tloss.detach()) - float(_np(jloss))) <= GRAD * max(
            1.0, abs(float(_np(jloss)))), step
        js = {k: _np(v) for k, v in jl.state_dict().items()}
        for k, v in tl.state_dict().items():
            assert _rel(v, js[k]) <= GRAD, (step, k)


def test_fused_ec_moe_functional():
    rng = np.random.default_rng(3)
    B, S, H, E, Fh = 2, 8, 16, 4, 32
    x, gate = _rand(rng, B, S, H), _rand(rng, B, S, E)
    w1, b1 = _rand(rng, E, H, Fh, scale=0.2), _rand(rng, E, Fh)
    w2, b2 = _rand(rng, E, Fh, H, scale=0.2), _rand(rng, E, H)
    for act in ("gelu", "relu"):
        jo = JIF.fused_ec_moe(P(x), P(gate), P(w1), P(b1), P(w2), P(b2),
                              act_type=act)
        to = TIF.fused_ec_moe(T(x), T(gate), T(w1), T(b1), T(w2), T(b2),
                              act_type=act)
        assert _rel(to, jo) <= PROD


# ------------------------------------------------- fused_multi_transformer

def _fmt_weights(rng, L, H, nh, ffn, activation, trans_qkvw, q8):
    d = H // nh
    mk = lambda *sh: _rand(rng, *sh, scale=0.1)     # noqa: E731
    f1 = 2 * ffn if activation == "swiglu" else ffn
    w = dict(
        ln_scales=[1.0 + mk(H) for _ in range(L)],
        ln_biases=[mk(H) for _ in range(L)],
        qkv_weights=[mk(3, nh, d, H) if trans_qkvw else mk(H, 3, nh, d)
                     for _ in range(L)],
        qkv_biases=[mk(3 * nh * d) for _ in range(L)],
        linear_weights=[mk(nh * d, H) for _ in range(L)],
        linear_biases=[mk(H) for _ in range(L)],
        ffn_ln_scales=[1.0 + mk(H) for _ in range(L)],
        ffn_ln_biases=[mk(H) for _ in range(L)],
        ffn1_weights=[mk(H, f1) for _ in range(L)],
        ffn1_biases=[None if activation == "swiglu" else mk(f1)
                     for _ in range(L)],
        ffn2_weights=[mk(ffn, H) for _ in range(L)],
        ffn2_biases=[mk(H) for _ in range(L)])
    if q8:
        def q(a):
            # the reference test's per-tensor absmax pairs
            # (tests/test_sparse_quant.py:214-218)
            scale = np.maximum(np.abs(a).max() / 127.0, 1e-8)
            return (np.clip(np.round(a / scale), -127, 127).astype(np.int8),
                    np.float32(scale).reshape(1))
        for n in ("qkv_weights", "linear_weights", "ffn1_weights",
                  "ffn2_weights"):
            w[n] = [q(a) for a in w[n]]
    return w


def _conv(w, fn):
    out = {}
    for n, lst in w.items():
        out[n] = [None if a is None else
                  (tuple(fn(x) for x in a) if isinstance(a, tuple) else fn(a))
                  for a in lst]
    return out


@pytest.mark.parametrize("case", [
    "gelu_rope", "relu_post_ln", "swiglu_rotary_embs", "int8_rope",
    "int8_swiglu_seq_lens", "untransposed"])
def test_fused_multi_transformer_prefill_and_decode(case):
    """Prefill of S tokens into [2, B, nh, S_max, d] caches, then two
    decode steps (time_step, or per-sequence seq_lens): outputs and
    caches against the reference's."""
    rng = np.random.default_rng(4)
    B, S, H, nh, ffn, L, S_max = 2, 5, 32, 4, 48, 2, 12
    d = H // nh
    activation = ("relu" if "relu" in case else
                  "swiglu" if "swiglu" in case else "gelu")
    trans = case != "untransposed"
    w = _fmt_weights(rng, L, H, nh, ffn, activation, trans, "int8" in case)
    kw = dict(activation=activation, trans_qkvw=trans,
              pre_layer_norm=case != "relu_post_ln", epsilon=1e-5)
    if case != "relu_post_ln":
        kw["rotary_emb_dims"] = 1
    embs = None
    if case == "swiglu_rotary_embs":
        ang = rng.uniform(0, 3, (S_max, d)).astype(np.float32)
        embs = np.stack([np.cos(ang), np.sin(ang)])
    x = _rand(rng, B, S + 2, H)
    jw, tw = _conv(w, P), _conv(w, T)
    jc = [P(np.zeros((2, B, nh, S_max, d), np.float32)) for _ in range(L)]
    tc = [torch.zeros((2, B, nh, S_max, d)) for _ in range(L)]
    extra_j = {} if embs is None else {"rotary_embs": P(embs)}
    extra_t = {} if embs is None else {"rotary_embs": T(embs)}
    jo, jc = JIF.fused_multi_transformer(P(x[:, :S]), **jw, cache_kvs=jc,
                                         **kw, **extra_j)
    to, tc = TIF.fused_multi_transformer(T(x[:, :S]), **tw, cache_kvs=tc,
                                         **kw, **extra_t)
    assert _rel(to, jo) <= PROD
    for a, b in zip(tc, jc):
        assert _rel(a, b) <= PROD
    for step in range(2):
        t = S + step
        if case == "int8_swiglu_seq_lens":
            sl = np.array([t, t], np.int32)
            dj = dict(time_step=P(np.array(t, np.int32)), seq_lens=P(sl))
            dt = dict(time_step=T(np.array(t, np.int32)), seq_lens=T(sl))
        else:
            dj = dict(time_step=P(np.array(t, np.int32)))
            dt = dict(time_step=T(np.array(t, np.int32)))
        jo, jc = JIF.fused_multi_transformer(
            P(x[:, t:t + 1]), **jw, cache_kvs=jc, **kw, **extra_j, **dj)
        to, tc = TIF.fused_multi_transformer(
            T(x[:, t:t + 1]), **tw, cache_kvs=tc, **kw, **extra_t, **dt)
        assert _rel(to, jo) <= PROD, step
        for a, b in zip(tc, jc):
            assert _rel(a, b) <= PROD, step


def test_fused_multi_transformer_no_cache():
    """Without caches the output alone (causal), as the reference."""
    rng = np.random.default_rng(5)
    w = _fmt_weights(rng, 2, 32, 4, 48, "gelu", True, False)
    x = _rand(rng, 2, 6, 32)
    jo = JIF.fused_multi_transformer(P(x), **_conv(w, P))
    to = TIF.fused_multi_transformer(T(x), **_conv(w, T))
    assert isinstance(to, torch.Tensor)
    assert _rel(to, jo) <= PROD
