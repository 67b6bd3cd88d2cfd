"""The port's beam search (paddle_tpu_torch.nn: `BeamSearchDecoder`,
`dynamic_decode`, `nn.functional.gather_tree`) against the JAX package
on a shared Transformer cell, in fp32 on the CPU.

The cell is the same on both sides, built from each package's public
pieces: a token embedding scaled by sqrt(d_model) and shared with the
output projection, sinusoidal positions, and a 2-layer
`TransformerDecoder` stepping on its `gen_cache(do_zip=True)` caches
(the `StaticCache` projected from the encoder output, and the growing
self-attention `Cache`, which the cell makes at the first step: the
reference's decoder cannot fold a zero-length cache into beams) under
the source's float padding mask. The
decoder's states (the caches and the mask) ride the folded batch and
are gathered by parent beam each step. Weights are one seeded draw
carried by `layer_state_from_jax`. The token paths and lengths must be
equal, the final beam log-probs within FWD_RTOL (1e-5, max|a - b| /
max|b|).
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as JN
from paddle_tpu.ops.extra import gather_tree as j_gather_tree
from paddle_tpu_torch import nn as TN
from paddle_tpu_torch.models.convert import layer_state_from_jax
from paddle_tpu_torch.nn import functional as TF

from _torch_threads import one_torch_thread  # noqa: F401,E402

FWD_RTOL = 1e-5
D, H, FF, L, V = 128, 2, 256, 2, 16
START, END, BEAM = 0, 1, 4
LENGTHS = (10, 7, 4)
S = max(LENGTHS)


def _sinusoid(n, d):
    pos = np.arange(n)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    out = np.zeros((n, d), np.float32)
    out[:, 0::2], out[:, 1::2] = np.sin(ang), np.cos(ang)
    return out


PE = _sinusoid(64, D)
EOS_BIAS = np.zeros(V, np.float32)
EOS_BIAS[END] = 5.5


class _Model:
    """One package's seq2seq pieces: the Transformer, the shared
    embedding, and the decode cell."""

    def __init__(self, nn, to_tensor, matmul_t, state=None, **kw):
        self.tr = nn.Transformer(D, H, L, L, FF, dropout=0.0, **kw)
        self.emb = nn.Embedding(V, D, **kw)
        self.to_tensor, self.matmul_t = to_tensor, matmul_t
        self.tr.eval()

    def embed(self, ids):
        return self.emb(ids) * math.sqrt(D)

    def logits(self, h):
        # EOS_BIAS lifts the end token's logit, so beams finish within
        # the steps
        return self.matmul_t(h, self.emb.weight) + self.to_tensor(EOS_BIAS)

    def encode(self, src, mask):
        return self.tr.encoder(self.embed(src) + self.to_tensor(PE[:S]),
                               mask)

    def cell(self, inp, states):
        incr, static, mask = states
        pos = incr[0].k.shape[1] if incr else 0
        x = (inp + self.to_tensor(PE[pos]))[:, None, :]
        if not incr:
            # the first step makes the empty growing caches: the
            # reference's decoder cannot fold a zero-length one into beams
            incr = [layer.self_attn.gen_cache(x)
                    for layer in self.tr.decoder.layers]
        out, new = self.tr.decoder(x, None, None, mask,
                                   list(zip(incr, static)))
        return out[:, 0], ([c[0] for c in new], [c[1] for c in new], mask)


def _ref_and_port(seed=0):
    rng = np.random.default_rng(seed)
    jm = _Model(JN, lambda a: paddle.to_tensor(a),
                lambda h, w: paddle.matmul(h, w, transpose_y=True))
    tm = _Model(TN, lambda a: torch.from_numpy(a), lambda h, w: h @ w.T,
                device="cpu")
    for jl, tl in ((jm.tr, tm.tr), (jm.emb, tm.emb)):
        state = {}
        for k, v in jl.state_dict().items():
            shape = tuple(v.shape)
            scale = 0.1 if len(shape) == 1 else 1.0 / math.sqrt(shape[0])
            base = 1.0 if "norm" in k and k.endswith("weight") else 0.0
            state[k] = (base + scale * rng.standard_normal(shape)).astype(
                np.float32)
        jl.set_state_dict(state)
        layer_state_from_jax(state, tl)
    src = rng.integers(2, V, (len(LENGTHS), S)).astype(np.int64)
    valid = np.arange(S)[None, :] < np.array(LENGTHS)[:, None]
    mask = np.where(valid, 0.0, -1e9).astype(np.float32)[:, None, None, :]
    return jm, tm, src, mask


def _port_decode(tm, src, mask, max_steps, **kw):
    with torch.no_grad():
        m = torch.from_numpy(mask)
        memory = tm.encode(torch.from_numpy(src), m)
        _, static = tm.tr.decoder.gen_cache(memory, do_zip=True)
        dec = TN.BeamSearchDecoder(tm.cell, START, END, BEAM,
                                   embedding_fn=tm.embed,
                                   output_fn=tm.logits)
        return TN.dynamic_decode(dec, ([], static, m), max_steps,
                                 return_length=True, **kw)


def _ref_decode(jm, src, mask, max_steps, **kw):
    m = paddle.to_tensor(mask)
    memory = jm.encode(paddle.to_tensor(src), m)
    _, static = jm.tr.decoder.gen_cache(memory, do_zip=True)
    dec = JN.BeamSearchDecoder(jm.cell, START, END, BEAM,
                               embedding_fn=jm.embed, output_fn=jm.logits)
    return JN.dynamic_decode(dec, ([], static, m), max_steps,
                             return_length=True, **kw)


@pytest.mark.parametrize("time_major", [False, True])
def test_beam_search_paths_and_lengths_match_reference(time_major):
    """Token paths [batch, beam, T] (or time-major), lengths and the
    final log-probs; some beams end early (the end token), so the
    finished-beam rule and the length carry through parents are held."""
    jm, tm, src, mask = _ref_and_port(0)
    out_t, state_t, len_t = _port_decode(tm, src, mask, 12,
                                         output_time_major=time_major)
    out_j, state_j, len_j = _ref_decode(jm, src, mask, 12,
                                        output_time_major=time_major)
    assert np.array_equal(out_t.numpy(), np.asarray(out_j.numpy()))
    assert np.array_equal(len_t.numpy(), np.asarray(len_j.numpy()))
    steps = out_t.shape[0 if time_major else 2]
    assert len_t.numpy().min() < steps, "no beam finished early"
    assert _max_rel(state_t[1], np.asarray(state_j[1])) <= FWD_RTOL
    assert np.array_equal(state_t[2].numpy(), np.asarray(state_j[2]))


def _max_rel(got, want):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def test_beam_states_keep_their_types_and_order():
    """initialize folds each source into beam consecutive rows (batch-
    major, beam-minor); a step gathers the parents' caches and keeps
    Cache and StaticCache as their own types."""
    _, tm, src, mask = _ref_and_port(1)
    with torch.no_grad():
        m = torch.from_numpy(mask)
        memory = tm.encode(torch.from_numpy(src), m)
        incr, static = tm.tr.decoder.gen_cache(memory, do_zip=True)
        dec = TN.BeamSearchDecoder(tm.cell, START, END, BEAM,
                                   embedding_fn=tm.embed,
                                   output_fn=tm.logits)
        tokens, state = dec.initialize((incr, static, m))
        assert tokens.shape == (len(LENGTHS), BEAM)
        st = state[0][1][0]
        assert isinstance(st, TN.MultiHeadAttention.StaticCache)
        for b in range(len(LENGTHS)):
            for j in range(BEAM):
                assert torch.equal(st.k[b * BEAM + j], static[0].k[b])
        nxt, parent, state, fin = dec.step(0, tokens, state)
        assert bool((parent == 0).all())      # step 1 expands beam 0
        c0, s0 = state[0][0][0], state[0][1][0]
        assert isinstance(c0, TN.MultiHeadAttention.Cache)
        assert isinstance(s0, TN.MultiHeadAttention.StaticCache)
        assert c0.k.shape == (len(LENGTHS) * BEAM, 1, H, D // H)


@pytest.mark.parametrize("seed", [0, 1])
def test_gather_tree_matches_reference(seed):
    rng = np.random.default_rng(seed)
    Tn, Bn, K = 7, 3, 4
    ids = rng.integers(0, 50, (Tn, Bn, K)).astype(np.int64)
    parents = rng.integers(0, K, (Tn, Bn, K)).astype(np.int64)
    want = np.asarray(j_gather_tree(paddle.to_tensor(ids),
                                    paddle.to_tensor(parents)).numpy())
    got = TF.gather_tree(torch.from_numpy(ids), torch.from_numpy(parents))
    assert np.array_equal(got.numpy(), want)
