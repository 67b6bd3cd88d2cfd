"""The port's dropout (paddle_tpu_torch.nn.functional.common, the dropout
layers, the dropout stream of framework.core, and the attention
functionals' training dropout) against the JAX package, in fp32 on the
CPU, from the same seeded numpy inputs.

The port's draws cannot reproduce `jax.random`'s, so the parity tests
share masks: `_torch_masks.SharedMasks` records the masks the
reference's `jax.random.bernoulli` returns and feeds them to the port's
`_keep_mask` in draw order. The port's own masks are held to the
binomial (keep share within DROPOUT_SIGMAS standard deviations) and to
the generator rules. Limit: max|a - b| / max|b| <= RTOL (the scaling
x / (1 - p) and the attention's f32 products, a few ulps).
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.nn.layer.transformer import MultiHeadAttention as JMHA
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import testing
from paddle_tpu_torch.framework import core
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.functional import common as t_common
from paddle_tpu_torch.nn.layer import MultiHeadAttention as TMHA

from _torch_masks import SharedMasks

from _torch_threads import one_torch_thread  # noqa: F401,E402

RTOL = 1e-5


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


def _max_rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _pair(j_fn, t_fn, x, g):
    """The reference's and the port's output and input grad for the same
    x and output cotangent g."""
    jx = paddle.to_tensor(x, stop_gradient=False)
    jo = j_fn(jx)
    (jo * paddle.to_tensor(g)).sum().backward()
    tx = _t(x, True)
    to = t_fn(tx)
    to.backward(_t(g))
    return (to.detach().numpy(), tx.grad.numpy(), jo.numpy(),
            jx.grad.numpy())


def _assert_pair(got, got_dx, want, want_dx):
    assert got.shape == want.shape
    assert _max_rel(got, want) <= RTOL
    assert _max_rel(got_dx, want_dx) <= RTOL


# ------------------------------------------------------- functionals


DROPOUT_CASES = {
    "upscale": dict(p=0.3),
    "upscale_axis1": dict(p=0.4, axis=1),
    "upscale_axes02": dict(p=0.25, axis=[0, 2]),
    "downscale_train": dict(p=0.3, mode="downscale_in_infer"),
    "downscale_axis": dict(p=0.5, axis=2, mode="downscale_in_infer"),
    "eval_upscale": dict(p=0.3, training=False),
    "eval_downscale": dict(p=0.3, training=False,
                           mode="downscale_in_infer"),
    "p0": dict(p=0.0),
    "p1": dict(p=1.0),
}


@pytest.mark.parametrize("case", list(DROPOUT_CASES))
def test_dropout_matches_reference(case, monkeypatch):
    kw = DROPOUT_CASES[case]
    masks = SharedMasks(monkeypatch)
    rng = np.random.default_rng(0)
    x, g = _rand(rng, 4, 6, 8), _rand(rng, 4, 6, 8)
    got = _pair(lambda a: JF.dropout(a, **kw), lambda a: TF.dropout(a, **kw),
                x, g)
    _assert_pair(*got)
    assert masks.all_used()
    drawn = kw.get("training", True) and kw["p"] not in (0.0, 1.0)
    assert len(masks.drawn) == int(drawn)
    if kw["p"] == 1.0:
        assert not got[0].any()


@pytest.mark.parametrize("case", ["dropout2d_nchw", "dropout2d_nhwc",
                                  "dropout3d_ncdhw", "dropout3d_ndhwc",
                                  "alpha", "feature_alpha"])
def test_channel_and_alpha_dropout_match_reference(case, monkeypatch):
    masks = SharedMasks(monkeypatch)
    rng = np.random.default_rng(1)
    shape = (3, 4, 5, 6, 2) if "3d" in case else (3, 4, 5, 6)
    x, g = _rand(rng, *shape), _rand(rng, *shape)
    fmt = {"dropout2d_nhwc": "NHWC", "dropout3d_ndhwc": "NDHWC"}
    if case.startswith("dropout2d"):
        kw = dict(p=0.4, data_format=fmt.get(case, "NCHW"))
        pair = (lambda a: JF.dropout2d(a, **kw),
                lambda a: TF.dropout2d(a, **kw))
    elif case.startswith("dropout3d"):
        kw = dict(p=0.4, data_format=fmt.get(case, "NCDHW"))
        pair = (lambda a: JF.dropout3d(a, **kw),
                lambda a: TF.dropout3d(a, **kw))
    else:
        name = "alpha_dropout" if case == "alpha" else "feature_alpha_dropout"
        pair = (lambda a: getattr(JF, name)(a, p=0.2),
                lambda a: getattr(TF, name)(a, p=0.2))
    _assert_pair(*_pair(*pair, x, g))
    assert masks.all_used() and len(masks.drawn) == 1
    if case.startswith("dropout"):
        # whole channels: the mask is 1 on the spatial axes
        m = masks.drawn[0]
        assert m.size == shape[0] * shape[1 if "nc" in case else -1]


@pytest.mark.parametrize("layer", ["Dropout", "Dropout_axis",
                                   "Dropout_downscale", "Dropout2D",
                                   "Dropout3D", "AlphaDropout"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_dropout_layers_match_reference(layer, training, monkeypatch):
    SharedMasks(monkeypatch)
    kw = {"Dropout_axis": dict(p=0.3, axis=1),
          "Dropout_downscale": dict(p=0.3, mode="downscale_in_infer")}.get(
              layer, dict(p=0.3))
    cls = layer.split("_")[0]
    jl, tl = getattr(jnn, cls)(**kw), getattr(tnn, cls)(**kw)
    for m in (jl, tl):
        m.train() if training else m.eval()
    rng = np.random.default_rng(2)
    shape = (2, 3, 4, 5, 2) if cls == "Dropout3D" else (2, 3, 4, 5)
    x, g = _rand(rng, *shape), _rand(rng, *shape)
    _assert_pair(*_pair(jl, tl, x, g))


# ------------------------------------------------- the port's own masks


def test_keep_share_is_binomial():
    """The keep share of a 16 x 512 x 768 mask (the encoders' hidden
    shape) at p = 0.1 lies within DROPOUT_SIGMAS standard deviations of
    1 - p; so does a dropped activation's mean scale."""
    g = torch.Generator().manual_seed(0)
    shape, p = (16, 512, 768), 0.1
    keep = t_common._keep_mask(shape, p, g, "cpu")
    assert keep.dtype == torch.bool and tuple(keep.shape) == shape
    n = keep.numel()
    z = (int(keep.sum()) - n * (1 - p)) / math.sqrt(n * p * (1 - p))
    assert z == testing.keep_share_sigmas(keep, p)
    assert abs(z) <= testing.DROPOUT_SIGMAS, z
    x = torch.ones(shape)
    scale = TF.dropout(x, p, generator=g).mean().item()
    assert abs(scale - 1.0) <= testing.DROPOUT_SIGMAS * math.sqrt(
        p / ((1 - p) * n))


def test_generator_rules():
    """An explicit generator: the same seed gives the same mask. None:
    the dropout stream, which advances with each draw and which
    `core.seed` resets."""
    x = torch.ones(64, 64)
    a = TF.dropout(x, 0.5, generator=torch.Generator().manual_seed(3))
    b = TF.dropout(x, 0.5, generator=torch.Generator().manual_seed(3))
    c = TF.dropout(x, 0.5, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    core.seed(7)
    s1, s2 = TF.dropout(x, 0.5), TF.dropout(x, 0.5)
    assert not torch.equal(s1, s2)
    core.seed(7)
    assert torch.equal(TF.dropout(x, 0.5), s1)
    assert torch.equal(TF.dropout(x, 0.5), s2)
    assert core.dropout_generator("cpu") is core.dropout_generator("cpu")
    # the stream's first draw after seed(s) is a generator seeded with s
    core.seed(9)
    want = TF.dropout(x, 0.5, generator=torch.Generator().manual_seed(9))
    assert torch.equal(TF.dropout(x, 0.5), want)
    assert set(torch.unique(s1).tolist()) == {0.0, 2.0}


def test_identity_cases():
    x = torch.randn(8, 8, requires_grad=True)
    assert TF.dropout(x, 0.0) is x
    assert TF.dropout(x, 0.7, training=False) is x
    assert TF.alpha_dropout(x, 0.7, training=False) is x
    assert not TF.dropout(x, 1.0).any()
    torch.testing.assert_close(
        TF.dropout(x, 0.25, training=False, mode="downscale_in_infer"),
        x * 0.75)
    layer = tnn.Dropout(0.9).eval()
    assert layer(x) is x


# ------------------------------------------ attention functionals


def _sdpa_inputs(seed, B=2, S=64, H=2, D=32):
    rng = np.random.default_rng(seed)
    return [_rand(rng, B, S, H, D) for _ in range(4)]


@pytest.mark.parametrize("mask_kind", ["none", "bool", "float", "causal"])
def test_sdpa_dropout_matches_reference(mask_kind, monkeypatch):
    """dropout_p > 0 in training: the reference's dense `_sdpa_ref`, then
    F.dropout on the output, with the same mask; output and q, k, v
    grads over every row."""
    masks = SharedMasks(monkeypatch)
    q, k, v, g = _sdpa_inputs(3)
    B, S = q.shape[0], q.shape[1]
    valid = np.arange(S)[None, :] < np.array([S - 20, S])[:, None]
    mask = {"bool": valid[:, None, None, :],
            "float": np.where(valid, 0.0, -1e4).astype(
                np.float32)[:, None, None, :]}.get(mask_kind)
    causal = mask_kind == "causal"
    jl = [paddle.to_tensor(t, stop_gradient=False) for t in (q, k, v)]
    jo = JF.scaled_dot_product_attention(
        *jl, attn_mask=None if mask is None else paddle.to_tensor(mask),
        dropout_p=0.2, is_causal=causal, training=True)
    (jo * paddle.to_tensor(g)).sum().backward()
    tl = [_t(t, True) for t in (q, k, v)]
    to = TF.scaled_dot_product_attention(
        *tl, attn_mask=None if mask is None else torch.from_numpy(mask),
        dropout_p=0.2, is_causal=causal, training=True)
    to.backward(_t(g))
    assert masks.all_used() and len(masks.drawn) == 1
    assert masks.drawn[0].shape == (B, S, 2, 32)
    assert _max_rel(to.detach().numpy(), jo.numpy()) <= RTOL
    for t, j in zip(tl, jl):
        assert _max_rel(t.grad.numpy(), j.grad.numpy()) <= RTOL


def test_flash_attention_dropout_and_eval(monkeypatch):
    """`flash_attention(dropout=)` in training: the same dense route and
    output dropout; out of training it draws no mask."""
    masks = SharedMasks(monkeypatch)
    q, k, v, _ = _sdpa_inputs(4)
    jo, _ = JF.flash_attention(*(paddle.to_tensor(t) for t in (q, k, v)),
                               dropout=0.3, causal=True)
    to, sm = TF.flash_attention(_t(q), _t(k), _t(v), dropout=0.3,
                                causal=True)
    assert sm is None and masks.all_used() and len(masks.drawn) == 1
    assert _max_rel(to.numpy(), jo.numpy()) <= RTOL
    je, _ = JF.flash_attention(*(paddle.to_tensor(t) for t in (q, k, v)),
                               dropout=0.3, causal=True, training=False)
    te, _ = TF.flash_attention(_t(q), _t(k), _t(v), dropout=0.3,
                               causal=True, training=False)
    assert len(masks.drawn) == 1
    assert _max_rel(te.numpy(), je.numpy()) <= RTOL


def test_multi_head_attention_dropout_matches_reference(monkeypatch):
    """MultiHeadAttention(dropout=) passes its dropout to sdpa in
    training: the same mask on the attention output, then out_proj."""
    paddle.seed(12)
    jm = JMHA(64, 2, dropout=0.25)
    tm = TMHA(64, 2, dropout=0.25, device="cpu")
    tm.load_state_dict({k: torch.from_numpy(np.array(v.numpy()))
                        for k, v in jm.state_dict().items()})
    masks = SharedMasks(monkeypatch)
    rng = np.random.default_rng(13)
    x, g = _rand(rng, 2, 32, 64), _rand(rng, 2, 32, 64)
    _assert_pair(*_pair(jm, tm, x, g))
    assert masks.all_used() and len(masks.drawn) == 1
    jm.eval()
    tm.eval()
    _assert_pair(*_pair(jm, tm, x, g))
    assert len(masks.drawn) == 1


@pytest.mark.parametrize("hq,hk,causal", [(2, 2, True), (2, 2, False),
                                          (4, 2, True)],
                         ids=["mha_causal", "mha_full", "gqa_causal"])
def test_flash_attn_unpadded_dropout_takes_dense_route(hq, hk, causal,
                                                       monkeypatch):
    """dropout > 0 in training: the reference's dense packed route,
    which applies no dropout (no mask is drawn on either side); output
    and grads against the reference's."""
    masks = SharedMasks(monkeypatch)
    rng = np.random.default_rng(14)
    cq = np.array([0, 7, 40, 41, 64], np.int32)
    ck = cq if causal else np.array([0, 10, 30, 50, 64], np.int32)
    q, do = _rand(rng, 64, hq, 32), _rand(rng, 64, hq, 32)
    k, v = _rand(rng, 64, hk, 32), _rand(rng, 64, hk, 32)
    jl = [paddle.to_tensor(t, stop_gradient=False) for t in (q, k, v)]
    jcq = paddle.to_tensor(cq)
    jck = jcq if causal else paddle.to_tensor(ck)
    jo, _ = JF.flash_attn_unpadded(*jl, jcq, jck, 64, 64, 0.2,
                                   dropout=0.5, causal=causal)
    (jo * paddle.to_tensor(do)).sum().backward()
    tl = [_t(t, True) for t in (q, k, v)]
    tcq = torch.from_numpy(cq)
    tck = tcq if causal else torch.from_numpy(ck)
    to, _ = TF.flash_attn_unpadded(*tl, tcq, tck, 64, 64, 0.2, dropout=0.5,
                                   causal=causal)
    to.backward(_t(do))
    assert masks.drawn == []
    assert _max_rel(to.detach().numpy(), jo.numpy()) <= RTOL
    for t, j in zip(tl, jl):
        assert _max_rel(t.grad.numpy(), j.grad.numpy()) <= RTOL
