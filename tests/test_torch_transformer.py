"""The port's Transformer stack (paddle_tpu_torch.nn.Transformer and its
encoder / decoder layers, `MultiHeadAttention(weight_attr=)`, every
`gen_cache`) and the attention functionals this slice ends the refusals
of (`sparse_attention`, causal `flash_attn_unpadded` over packings that
differ) against the JAX package, in fp32 on the CPU, from the same
seeded numpy inputs and weights (`layer_state_from_jax`).

Sizes are llama_tiny-like: 2 encoder and 2 decoder layers, d_model 128
in 2 heads of 64 (the kernels' head dim, whose plain versions the port
runs on the CPU), d_ff 256, a batch of 2 sources of 24 tokens (one
padded to 17) and targets of 16, or of 24 (as long as the sources: a
valid target row at a padded source index keeps its keys).

The reference takes its dense `_sdpa_ref` on the CPU; the port runs the
kernels' functions (the bias route's plain version for float masks, the
segment route's for a boolean padding mask, which masks the keys alone,
as `_sdpa_ref` does), so the output and every parameter grad compare
whole. Limits, as max|a - b| / max|b|:
FWD_RTOL 1e-5 for outputs, GRAD_RTOL 2e-5 for each parameter's grad
(four layers of f32 summation in different orders).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as JN
import paddle_tpu.nn.functional as JF
from paddle_tpu.nn import initializer as JI
from paddle_tpu_torch import nn as TN
from paddle_tpu_torch.models.convert import layer_state_from_jax
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn import initializer as TI

from _torch_threads import one_torch_thread  # noqa: F401,E402

FWD_RTOL = 1e-5
GRAD_RTOL = 2e-5
D, H, FF, L = 128, 2, 256, 2
B, S, T = 2, 24, 16
LENGTHS = (24, 17)


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_(grad) if t.is_floating_point() else t


def _j(a, grad=False):
    return paddle.to_tensor(np.array(a), stop_gradient=not grad)


def _max_rel(got, want):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _random_state(jm, rng):
    """Distinct random weights for every tensor (the reference's clones
    start equal): weights N(0, 1/fan_in), norm weights near 1, biases
    small."""
    out = {}
    for k, v in jm.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("norm1.weight") or "norm" in k and k.endswith(
                "weight"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif len(shape) == 1:
            a = 0.1 * rng.standard_normal(shape)
        else:
            a = rng.standard_normal(shape) / np.sqrt(shape[0])
        out[k] = a.astype(np.float32)
    return out


def _models(normalize_before, seed=0, activation="relu"):
    rng = np.random.default_rng(seed)
    jm = JN.Transformer(D, H, L, L, FF, dropout=0.0, activation=activation,
                        normalize_before=normalize_before)
    tm = TN.Transformer(D, H, L, L, FF, dropout=0.0, activation=activation,
                        normalize_before=normalize_before, device="cpu")
    assert list(tm.state_dict()) == list(jm.state_dict())
    state = _random_state(jm, rng)
    jm.set_state_dict(state)
    layer_state_from_jax(state, tm)
    return jm, tm, rng


def _inputs(rng, kind, T=T):
    src = rng.standard_normal((B, S, D)).astype(np.float32)
    tgt = rng.standard_normal((B, T, D)).astype(np.float32)
    valid = np.arange(S)[None, :] < np.array(LENGTHS)[:, None]
    if kind == "float":
        src_mask = np.where(valid, 0.0, -1e9).astype(np.float32)[
            :, None, None, :]
        tgt_mask = np.asarray(JN.Transformer.generate_square_subsequent_mask(
            T).numpy())
    else:
        src_mask = valid[:, None, None, :]
        tgt_mask = np.tril(np.ones((T, T), bool))
    return src, tgt, src_mask, tgt_mask


@pytest.mark.parametrize("kind", ["float", "bool"])
@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer_forward_and_grads_match_reference(normalize_before,
                                                       kind):
    _forward_and_grads_match(normalize_before, kind, T)


@pytest.mark.parametrize("kind", ["float", "bool"])
@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer_equal_lengths_match_reference(normalize_before, kind):
    """Targets as long as the sources: the memory mask's padded keys lie
    at indices that are valid target rows, which must keep attending to
    the valid keys (a bool mask lowered to query ids as well as key ids
    would leave them only the padded ones)."""
    _forward_and_grads_match(normalize_before, kind, S)


def _forward_and_grads_match(normalize_before, kind, T):
    jm, tm, rng = _models(normalize_before)
    src, tgt, sm, tmask = _inputs(rng, kind, T)
    g = rng.standard_normal((B, T, D)).astype(np.float32)
    yj = jm(_j(src), _j(tgt), _j(sm), _j(tmask), _j(sm))
    (yj * _j(g)).sum().backward()
    yt = tm(_t(src), _t(tgt), _t(sm), _t(tmask), _t(sm))
    (yt * _t(g)).sum().backward()
    assert _max_rel(yt, yj.numpy()) <= FWD_RTOL
    jp = dict(jm.named_parameters())
    tp = dict(tm.named_parameters())
    assert list(tp) == list(jp)
    errs = []
    for k in jp:
        got, want = tp[k].grad.numpy(), jp[k].grad.numpy()
        if k.endswith("k_proj.bias"):
            # 0 analytically (one constant added to every key's score
            # leaves the softmax as it is): both read summation noise,
            # held against the scale of the same layer's q bias grad
            scale = np.abs(jp[k.replace("k_proj", "q_proj")].grad.numpy())
            errs.append((np.abs(got - want).max() / scale.max(), k))
        else:
            errs.append((_max_rel(got, want), k))
    worst = max(errs)
    assert worst[0] <= GRAD_RTOL, worst


def test_encoder_layer_gelu_pre_norm_matches_reference():
    rng = np.random.default_rng(3)
    jl = JN.TransformerEncoderLayer(D, H, FF, 0.0, "gelu",
                                    normalize_before=True)
    tl = TN.TransformerEncoderLayer(D, H, FF, 0.0, "gelu",
                                    normalize_before=True, device="cpu")
    layer_state_from_jax(_random_state(jl, rng), tl)
    jl.set_state_dict({k: v.numpy() for k, v in tl.state_dict().items()})
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    assert _max_rel(tl(_t(x)), jl(_j(x)).numpy()) <= FWD_RTOL


def test_clones_start_from_layer_zero():
    """The stacks deep-copy the layer they are given: every layer starts
    from its values, in both packages (ROADMAP Queue 3)."""
    tm = TN.Transformer(64, 1, 3, 2, 64, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    jm = JN.Transformer(64, 1, 3, 2, 64)
    for model, get in ((tm, lambda p: p.detach().numpy()),
                       (jm, lambda p: p.numpy())):
        for stack in (model.encoder, model.decoder):
            first = dict(stack.layers[0].named_parameters())
            for layer in list(stack.layers)[1:]:
                for k, p in layer.named_parameters():
                    assert np.array_equal(get(p), get(first[k]))
                    assert p is not first[k]


def test_weight_attr_and_masks_match_reference():
    """MultiHeadAttention(weight_attr=, bias_attr=) builds its four
    projections from the attrs, as the reference's; the subsequent mask
    is the reference's."""
    jm = JN.MultiHeadAttention(
        64, 2, weight_attr=JN.ParamAttr(initializer=JI.Constant(0.05)),
        bias_attr=JN.ParamAttr(initializer=JI.Constant(0.1)))
    tm = TN.MultiHeadAttention(
        64, 2, weight_attr=TN.ParamAttr(initializer=TI.Constant(0.05)),
        bias_attr=TN.ParamAttr(initializer=TI.Constant(0.1)), device="cpu")
    for k, v in jm.state_dict().items():
        assert np.array_equal(tm.state_dict()[k].numpy(), v.numpy())
    x = np.random.default_rng(4).standard_normal((2, 5, 64)).astype(
        np.float32)
    assert _max_rel(tm(_t(x)), jm(_j(x)).numpy()) <= FWD_RTOL
    nob = TN.MultiHeadAttention(64, 2, bias_attr=False, device="cpu")
    assert nob.q_proj.bias is None
    want = JN.Transformer.generate_square_subsequent_mask(7).numpy()
    got = TN.Transformer.generate_square_subsequent_mask(7, device="cpu")
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)


def _decode_incremental(model, tgt, memory, memory_mask, zipped):
    caches = model.decoder.gen_cache(memory, do_zip=zipped)
    if zipped:
        caches = [tuple(c) for c in zip(*caches)]
    outs = []
    for t in range(tgt.shape[1]):
        out, caches = model.decoder(tgt[:, t:t + 1], memory, None,
                                    memory_mask, caches)
        outs.append(out)
    return outs, caches


@pytest.mark.parametrize("zipped", [False, True])
def test_incremental_decode_equals_teacher_forcing(zipped):
    """gen_cache's (Cache, StaticCache) per layer, one target token a
    step with no mask: each step equals the teacher-forced forward under
    the causal mask at that row, and the reference's step."""
    jm, tm, rng = _models(False, seed=5)
    src, tgt, sm, tmask = _inputs(rng, "float")
    jm.eval()
    tm.eval()
    with torch.no_grad():
        mem_t = tm.encoder(_t(src), _t(sm))
        full = tm.decoder(_t(tgt), mem_t, _t(tmask), _t(sm))
        outs, caches = _decode_incremental(tm, _t(tgt), mem_t, _t(sm),
                                           zipped)
    mem_j = jm.encoder(_j(src), _j(sm))
    outs_j, caches_j = _decode_incremental(jm, _j(tgt), mem_j, _j(sm),
                                           zipped)
    Cache, Static = TN.MultiHeadAttention.Cache, \
        TN.MultiHeadAttention.StaticCache
    assert all(isinstance(c[0], Cache) and isinstance(c[1], Static)
               for c in caches)
    assert caches[0][0].k.shape == (B, T, H, D // H)
    for t, (a, b) in enumerate(zip(outs, outs_j)):
        assert _max_rel(a[:, 0], full[:, t].numpy()) <= FWD_RTOL, t
        assert _max_rel(a, b.numpy()) <= FWD_RTOL, t
    j_caches = jm.decoder.gen_cache(mem_j, do_zip=True)
    t_caches = tm.decoder.gen_cache(mem_t, do_zip=True)
    assert len(t_caches) == len(j_caches) == 2
    assert [type(c).__name__ for c in t_caches[1]] == [
        type(c).__name__ for c in j_caches[1]]
    assert _max_rel(t_caches[1][1].v.detach(),
                    j_caches[1][1].v.numpy()) <= FWD_RTOL


def test_incremental_encoder_cache_matches_reference():
    """TransformerEncoder.gen_cache: a growing Cache per layer, one
    source token a step."""
    jm, tm, rng = _models(True, seed=6)
    x = rng.standard_normal((B, 5, D)).astype(np.float32)
    jc = jm.encoder.gen_cache(_j(x))
    tc = tm.encoder.gen_cache(_t(x))
    for t in range(5):
        yj, jc = jm.encoder(_j(x[:, t:t + 1]), None, jc)
        yt, tc = tm.encoder(_t(x[:, t:t + 1]), None, tc)
        assert _max_rel(yt, yj.numpy()) <= FWD_RTOL, t
    assert tc[0].k.shape == (B, 5, H, D // H)


def _csr(rng, Bs, Hs, Ss, per_row):
    """A CSR pattern, the same row counts in every (batch, head) and
    different columns; row 2 attends nothing."""
    counts = rng.integers(1, per_row + 1, Ss)
    counts[2] = 0
    off = np.concatenate([[0], np.cumsum(counts)])
    cols = np.concatenate([rng.choice(Ss, c, replace=False)
                           for c in counts]).astype(np.int32)
    offs = np.broadcast_to(off, (Bs, Hs, Ss + 1)).astype(np.int32).copy()
    # each (batch, head) shifts the columns (mod S), so rows stay distinct
    all_cols = np.stack([np.stack([(cols + b + 2 * h) % Ss
                                   for h in range(Hs)]) for b in range(Bs)])
    return offs, all_cols.astype(np.int32)


@pytest.mark.parametrize("masks", [False, True])
def test_sparse_attention_matches_reference(masks):
    rng = np.random.default_rng(7)
    Bs, Hs, Ss, Dd = 2, 2, 8, 16
    q, k, v, do = (rng.standard_normal((Bs, Hs, Ss, Dd)).astype(np.float32)
                   for _ in range(4))
    off, cols = _csr(rng, Bs, Hs, Ss, 4)
    kpm = np.ones((Bs, Ss), np.float32)
    kpm[1, 5:] = 0
    am = (rng.random((Ss, Ss)) > 0.2).astype(np.float32)
    extra = (kpm, am) if masks else (None, None)
    jx = [_j(a, True) for a in (q, k, v)]
    tx = [_t(a, True) for a in (q, k, v)]
    oj = JF.sparse_attention(*jx, _j(off), _j(cols),
                             *[None if e is None else _j(e) for e in extra])
    ot = TF.sparse_attention(*tx, _t(off), _t(cols),
                             *[None if e is None else _t(e) for e in extra])
    assert _max_rel(ot, oj.numpy()) <= FWD_RTOL
    assert bool((ot[:, :, 2] == 0).all())
    (oj * _j(do)).sum().backward()
    (ot * _t(do)).sum().backward()
    for a, b in zip(tx, jx):
        assert _max_rel(a.grad, b.grad.numpy()) <= FWD_RTOL


def test_causal_unpadded_over_differing_packings_matches_reference():
    """GQA (4 q heads, 2 kv heads), q packed as 5, 7, 8 and kv as 8, 2,
    10: the reference's dense packed route, output and grads."""
    rng = np.random.default_rng(8)
    cq = np.array([0, 5, 12, 20], np.int32)
    ck = np.array([0, 8, 10, 20], np.int32)
    q, do = (rng.standard_normal((20, 4, 64)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((20, 2, 64)).astype(np.float32)
            for _ in range(2))
    jx = [_j(a, True) for a in (q, k, v)]
    tx = [_t(a, True) for a in (q, k, v)]
    oj, _ = JF.flash_attn_unpadded(*jx, _j(cq), _j(ck), 8, 10, 0.125,
                                   causal=True)
    ot, _ = TF.flash_attn_unpadded(*tx, _t(cq), _t(ck), 8, 10, 0.125,
                                   causal=True)
    assert _max_rel(ot, oj.numpy()) <= FWD_RTOL
    (oj * _j(do)).sum().backward()
    (ot * _t(do)).sum().backward()
    for a, b in zip(tx, jx):
        assert _max_rel(a.grad, b.grad.numpy()) <= FWD_RTOL
