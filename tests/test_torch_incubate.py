"""The port's `incubate.nn.functional` against the JAX package's, on
seeded numpy inputs in f32 on the CPU (each kernel through its plain
version): norms, rope, activations, the decode attentions over
contiguous and paged caches, the GEMM epilogues, the dropout-mode
functions (the reference's masks replayed into the port's draws,
`tests/_torch_masks.py`), `fused_multi_head_attention` (values and
grads) and `variable_length_memory_efficient_attention`. The layers,
`fused_multi_transformer` and `fused_ec_moe` are in
test_torch_incubate_layers.py.

Tolerances: an elementwise expression in the reference's float order is
held to 1e-6 relative to the output's largest magnitude (transcendental
functions differ in the last bits between XLA and PyTorch); a product
or softmax to 1e-5 (summation order); grads to 1e-4."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.incubate.nn.functional as JIF
import paddle_tpu_torch.incubate as t_incubate
import paddle_tpu_torch.incubate.nn.functional as TIF

from _torch_masks import SharedMasks
from _torch_threads import one_torch_thread  # noqa: F401,E402

ELEM = 1e-6
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


# ------------------------------------------------------------------ norms

@pytest.mark.parametrize("case", ["last", "last_bias", "flattened"])
def test_fused_rms_norm(case):
    rng = np.random.default_rng(0)
    if case == "flattened":
        x, w, axis = _rand(rng, 2, 4, 16), _rand(rng, 64), 1
    else:
        x, w, axis = _rand(rng, 2, 5, 64), _rand(rng, 64), -1
    b = _rand(rng, 64) if case == "last_bias" else None
    jo = JIF.fused_rms_norm(P(x), P(w), None if b is None else P(b),
                            epsilon=1e-6, begin_norm_axis=axis)
    to = TIF.fused_rms_norm(T(x), T(w), None if b is None else T(b),
                            epsilon=1e-6, begin_norm_axis=axis)
    assert _rel(to, jo) <= ELEM


def test_fused_layer_norm():
    rng = np.random.default_rng(1)
    x, w, b = _rand(rng, 3, 7, 48), _rand(rng, 48), _rand(rng, 48)
    jo = JIF.fused_layer_norm(P(x), P(w), P(b), epsilon=1e-5)
    to = TIF.fused_layer_norm(T(x), T(w), T(b), epsilon=1e-5)
    assert _rel(to, jo) <= ELEM


# ------------------------------------------------------------------- rope

@pytest.mark.parametrize("case", ["cache_neox", "cache_gptj", "cache_pos",
                                  "neox", "neox_pos", "gptj", "gptj_pos",
                                  "q_only"])
def test_fused_rotary_position_embedding(case):
    """Caches ([S, D], optionally gathered at position_ids), the neox
    table route (`apply_rope`) and GPT-J pairs; v passes through."""
    rng = np.random.default_rng(2)
    B, S, H, D = 2, 6, 3, 16
    q, k, v = (_rand(rng, B, S, H, D) for _ in range(3))
    # positions inside the table (without a cache the reference's table
    # has q's length and its gather reads NaN past it)
    pos = np.stack([np.arange(S), np.arange(S)[::-1]]).astype(np.int64)
    kw = {}
    if case.startswith("cache"):
        ang = rng.uniform(0, 3, (S + 4, D)).astype(np.float32)
        kw = dict(sin=np.sin(ang), cos=np.cos(ang))
        if case != "cache_pos":
            kw = {n: a[:S] for n, a in kw.items()}
    if case.endswith("_pos"):
        kw["position_ids"] = pos
    neox = case not in ("cache_gptj", "gptj", "gptj_pos")
    kk = None if case == "q_only" else k
    jo = JIF.fused_rotary_position_embedding(
        P(q), None if kk is None else P(kk), P(v),
        use_neox_rotary_style=neox, **{n: P(a) for n, a in kw.items()})
    to = TIF.fused_rotary_position_embedding(
        T(q), None if kk is None else T(kk), T(v),
        use_neox_rotary_style=neox, **{n: T(a) for n, a in kw.items()})
    assert _rel(to[0], jo[0]) <= ELEM
    if kk is None:
        assert to[1] is None and jo[1] is None
    else:
        assert _rel(to[1], jo[1]) <= ELEM
    np.testing.assert_array_equal(_np(to[2]), v)


# ------------------------------------------------------------ activations

@pytest.mark.parametrize("act", ["gelu", "relu", "silu", "swiglu"])
@pytest.mark.parametrize("bias", [False, True])
def test_fused_bias_act(act, bias):
    rng = np.random.default_rng(3)
    x, b = _rand(rng, 4, 32), _rand(rng, 32)
    jo = JIF.fused_bias_act(P(x), P(b) if bias else None, act_method=act)
    to = TIF.fused_bias_act(T(x), T(b) if bias else None, act_method=act)
    assert _rel(to, jo) <= ELEM


def test_swiglu():
    rng = np.random.default_rng(4)
    x, y = _rand(rng, 4, 32), _rand(rng, 4, 32)
    assert _rel(TIF.swiglu(T(x), T(y)), JIF.swiglu(P(x), P(y))) <= ELEM
    assert _rel(TIF.swiglu(T(x)), JIF.swiglu(P(x))) <= ELEM


# ------------------------------------------------------- decode attention

@pytest.mark.parametrize("case", ["plain", "neox", "gptj", "src_mask"])
def test_masked_multihead_attention(case):
    """One decode step over [2, B, nh, S_max, d]: the output and the
    updated cache (an index write here, a one-hot blend there)."""
    rng = np.random.default_rng(5)
    B, nh, d, S_max = 2, 2, 64, 32
    x = _rand(rng, B, 3 * nh * d)
    cache = _rand(rng, 2, B, nh, S_max, d)
    sl = np.array([5, 17], np.int32)
    kw = dict(sequence_lengths=sl)
    if case in ("neox", "gptj"):
        kw.update(rotary_emb_dims=1, use_neox_rotary_style=case == "neox")
    mask = None
    if case == "src_mask":
        mask = (rng.uniform(size=(B, 1, 1, 18)) < 0.3).astype(
            np.float32) * -1e4
    jo, jc = JIF.masked_multihead_attention(
        P(x), P(cache), None if mask is None else P(mask),
        **{n: (P(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()})
    tc = T(cache)
    to, tc2 = TIF.masked_multihead_attention(
        T(x), tc, None if mask is None else T(mask),
        **{n: (T(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()})
    assert tc2 is tc
    assert _rel(to, jo) <= PROD
    if case in ("neox", "gptj"):
        # the rotated key is written: sin/cos differ in the last bit
        assert _rel(tc2, jc) <= ELEM
    else:
        np.testing.assert_array_equal(_np(tc2), _np(jc))


def test_block_multihead_attention():
    """GQA (4 q heads over 2 kv heads) over [pages, kvh, block, d]
    pools: output and both pools after the token's write."""
    rng = np.random.default_rng(6)
    B, nh, kvh, d, bs, n_pages = 2, 4, 2, 64, 16, 8
    qkv = _rand(rng, B, (nh + 2 * kvh) * d)
    kc = _rand(rng, n_pages, kvh, bs, d)
    vc = _rand(rng, n_pages, kvh, bs, d)
    bt = np.array([[1, 2], [5, 3]], np.int32)
    enc = np.zeros(B, np.int32)
    dec = np.array([5, 20], np.int32)
    this = np.ones(B, np.int32)
    jo, jk, jv = JIF.block_multihead_attention(
        P(qkv), P(kc), P(vc), P(enc), P(dec), P(this), block_tables=P(bt))
    to, tk, tv = TIF.block_multihead_attention(
        T(qkv), T(kc), T(vc), T(enc), T(dec), T(this), block_tables=T(bt))
    assert _rel(to, jo) <= PROD
    np.testing.assert_array_equal(_np(tk), _np(jk))
    np.testing.assert_array_equal(_np(tv), _np(jv))


def test_blha_get_max_len():
    enc, dec = np.array([3, 9, 1], np.int32), np.array([4, 2, 8], np.int32)
    jo = JIF.blha_get_max_len(P(enc), P(dec), 3)
    to = TIF.blha_get_max_len(T(enc), T(dec), 3)
    assert [int(t) for t in to] == [int(_np(j)) for j in jo] == [9, 8]


def test_apply_per_channel_scale():
    rng = np.random.default_rng(7)
    x, s = _rand(rng, 5, 24), _rand(rng, 24)
    assert _rel(TIF.apply_per_channel_scale(T(x), T(s)),
                JIF.apply_per_channel_scale(P(x), P(s))) == 0.0


# ---------------------------------------------------------- GEMM epilogue

@pytest.mark.parametrize("act", ["gelu", "relu", "none"])
@pytest.mark.parametrize("trans", [(False, False), (True, False),
                                   (False, True)])
def test_fused_linear_activation(act, trans):
    rng = np.random.default_rng(8)
    tx, ty = trans
    x = _rand(rng, 3, 16, 8) if tx else _rand(rng, 3, 8, 16)
    y = _rand(rng, 12, 16) if ty else _rand(rng, 16, 12)
    b = _rand(rng, 12)
    jo = JIF.fused_linear_activation(P(x), P(y), P(b), trans_x=tx,
                                     trans_y=ty, activation=act)
    to = TIF.fused_linear_activation(T(x), T(y), T(b), trans_x=tx,
                                     trans_y=ty, activation=act)
    assert _rel(to, jo) <= PROD


def test_fused_linear_and_matmul_bias():
    rng = np.random.default_rng(9)
    x, w, wt, b = (_rand(rng, 4, 16), _rand(rng, 16, 8), _rand(rng, 8, 16),
                   _rand(rng, 8))
    assert _rel(TIF.fused_linear(T(x), T(w), T(b)),
                JIF.fused_linear(P(x), P(w), P(b))) <= PROD
    assert _rel(TIF.fused_linear(T(x), T(wt), T(b), transpose_weight=True),
                JIF.fused_linear(P(x), P(wt), P(b),
                                 transpose_weight=True)) <= PROD
    assert _rel(TIF.fused_gemm_epilogue(T(x), T(w)),
                JIF.fused_gemm_epilogue(P(x), P(w))) <= PROD
    assert _rel(TIF.fused_matmul_bias(T(x), T(wt), T(b), transpose_y=True),
                JIF.fused_matmul_bias(P(x), P(wt), P(b),
                                      transpose_y=True)) <= PROD


# ---------------------------------------------------------------- dropout

@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
@pytest.mark.parametrize("training", [True, False])
def test_fused_dropout_add(monkeypatch, mode, training):
    masks = SharedMasks(monkeypatch)
    rng = np.random.default_rng(10)
    x, y = _rand(rng, 6, 40), _rand(rng, 6, 40)
    jo = JIF.fused_dropout_add(P(x), P(y), p=0.3, training=training,
                               mode=mode)
    to = TIF.fused_dropout_add(T(x), T(y), p=0.3, training=training,
                               mode=mode)
    assert masks.all_used() and len(masks.drawn) == int(training)
    assert _rel(to, jo) <= ELEM


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_fused_bias_dropout_residual_layer_norm(monkeypatch, mode):
    masks = SharedMasks(monkeypatch)
    rng = np.random.default_rng(11)
    x, res, b, g, lb = (_rand(rng, 3, 5, 32), _rand(rng, 3, 5, 32),
                        _rand(rng, 32), _rand(rng, 32), _rand(rng, 32))
    jo = JIF.fused_bias_dropout_residual_layer_norm(
        P(x), P(res), P(b), P(g), P(lb), dropout_rate=0.25, mode=mode)
    to = TIF.fused_bias_dropout_residual_layer_norm(
        T(x), T(res), T(b), T(g), T(lb), dropout_rate=0.25, mode=mode)
    assert masks.all_used() and len(masks.drawn) == 1
    assert _rel(to, jo) <= PROD


# -------------------------------------------------------------- attention

def _fmha_inputs(rng, H=128, nh=2):
    d = H // nh
    return dict(x=_rand(rng, 2, 8, H), qkv_weight=_rand(rng, 3, nh, d, H,
                                                        scale=0.1),
                linear_weight=_rand(rng, H, H, scale=0.1),
                qkv_bias=_rand(rng, 3, nh, d, scale=0.1),
                linear_bias=_rand(rng, H, scale=0.1),
                pre_ln_scale=_rand(rng, H), pre_ln_bias=_rand(rng, H),
                ln_scale=_rand(rng, H), ln_bias=_rand(rng, H))


@pytest.mark.parametrize("case", ["flash_pre_ln", "flash_post_ln",
                                  "dense_mask", "transpose_qkv_wb"])
def test_fused_multi_head_attention_grads(case):
    """Eval (no dropout): values and grads of x and every weight. With no
    mask the attention is row 10's flash route (its plain version here),
    with a mask the dense route."""
    rng = np.random.default_rng(12)
    inp = _fmha_inputs(rng)
    kw = dict(pre_layer_norm=case != "flash_post_ln", training=False)
    if case == "dense_mask":
        inp["attn_mask"] = (rng.uniform(size=(2, 1, 8, 8)) < 0.2).astype(
            np.float32) * -1e4
    if case == "transpose_qkv_wb":
        H = inp["x"].shape[-1]
        inp["qkv_weight"] = inp["qkv_weight"].reshape(-1, H).T.copy()
        inp["qkv_bias"] = inp["qkv_bias"].reshape(-1)
        kw.update(transpose_qkv_wb=True, num_heads=2)
    g = _rand(rng, *inp["x"].shape)
    diff = [n for n in inp if n != "attn_mask"]
    jt = {n: paddle.to_tensor(a, stop_gradient=n not in diff)
          for n, a in inp.items()}
    jo = JIF.fused_multi_head_attention(**jt, **kw)
    (jo * P(g)).sum().backward()
    tt = {n: T(a).requires_grad_(n in diff) for n, a in inp.items()}
    to = TIF.fused_multi_head_attention(**tt, **kw)
    to.backward(T(g))
    assert _rel(to, jo) <= PROD
    for n in diff:
        # the other LN placement's weights get no grad (or zeros)
        want = (np.zeros(inp[n].shape, np.float32) if jt[n].grad is None
                else _np(jt[n].grad))
        got = (np.zeros(inp[n].shape, np.float32) if tt[n].grad is None
               else _np(tt[n].grad))
        if not want.any():
            assert not got.any(), n
            continue
        assert _rel(got, want) <= GRAD, n


def test_fused_multi_head_attention_dropout(monkeypatch):
    """Training with attention-probability and output dropout: the dense
    route, both masks the reference's."""
    masks = SharedMasks(monkeypatch)
    rng = np.random.default_rng(13)
    inp = _fmha_inputs(rng)
    kw = dict(pre_layer_norm=True, training=True, dropout_rate=0.2,
              attn_dropout_rate=0.3)
    jo = JIF.fused_multi_head_attention(**{n: P(a) for n, a in inp.items()},
                                        **kw)
    to = TIF.fused_multi_head_attention(**{n: T(a) for n, a in inp.items()},
                                        **kw)
    assert masks.all_used() and len(masks.drawn) == 2
    assert _rel(to, jo) <= PROD


def test_fused_multi_head_attention_cache_raises():
    rng = np.random.default_rng(14)
    inp = {n: T(a) for n, a in _fmha_inputs(rng).items()}
    with pytest.raises(NotImplementedError, match="cache_kv"):
        TIF.fused_multi_head_attention(**inp, cache_kv=torch.zeros(1))


@pytest.mark.parametrize("case", ["flash_lengths", "dense_causal",
                                  "dense_mask_pre_cache", "scale"])
def test_variable_length_memory_efficient_attention(case):
    """[B, nh, S, D] with per-sequence lengths: the flash padding route
    (no mask, not causal) and the dense route (causal; an additive mask
    with pre_cache_length); rows past seq_lens are zero."""
    rng = np.random.default_rng(15)
    B, nh, S, D = 2, 2, 16, 64
    q, k, v = (_rand(rng, B, nh, S, D) for _ in range(3))
    ql = np.array([16, 11], np.int32)
    kl = ql.copy()
    kw = {}
    mask = None
    if case == "dense_causal":
        kw["causal"] = True
    if case == "dense_mask_pre_cache":
        kl = np.array([12, 7], np.int32)
        kw["pre_cache_length"] = 3
        mask = (rng.uniform(size=(B, 1, S, S)) < 0.2).astype(
            np.float32) * -1e4
    if case == "scale":
        kw["scale"] = 0.07
    jo = JIF.variable_length_memory_efficient_attention(
        P(q), P(k), P(v), P(ql), P(kl),
        mask=None if mask is None else P(mask), **kw)
    to = TIF.variable_length_memory_efficient_attention(
        T(q), T(k), T(v), T(ql), T(kl),
        mask=None if mask is None else T(mask), **kw)
    assert _rel(to, jo) <= PROD
    assert not _np(to)[1, :, 11:].any()


def test_unported_incubate_modules_raise():
    for name in ("asp", "autograd", "distributed"):
        with pytest.raises(NotImplementedError, match="not ported"):
            getattr(t_incubate, name)


def test_every_reference_function_has_a_counterpart():
    """Each public function of the reference's incubate.nn.functional
    has a port counterpart of the same name."""
    import inspect
    names = {n for n, f in vars(JIF).items()
             if inspect.isfunction(f) and not n.startswith("_")
             and f.__module__ == JIF.__name__}
    names.add("fused_gemm_epilogue")
    missing = sorted(n for n in names if not callable(getattr(TIF, n, None)))
    assert missing == []
    assert names <= set(TIF.__all__)
