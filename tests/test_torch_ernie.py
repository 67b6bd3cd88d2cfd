"""Port ERNIE (paddle_tpu_torch.models.ernie) against the JAX package's
`ErnieForPretraining` at `ernie_tiny` (hidden 128, 4 layers, 4 heads of
32, vocab 1024), fp32 on the CPU, in eval. Weights move from the
reference's `state_dict()` through `models.convert.state_from_jax`;
inputs are seeded numpy.

ERNIE's attention is full and unmasked, so the port's route (the
one-length flash function, its plain version here) and the reference's
CPU route (its dense branch) compute the same function on every row.
Limit: max|a - b| / max|b| <= MODEL_RTOL = 1e-5 (f32 summation order
through four pre-LN blocks).
"""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu.models import ernie as JE
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.kernels import flash_attention as t_fa
from paddle_tpu_torch.models import ernie as TE
from paddle_tpu_torch.models.convert import state_from_jax, to_numpy

from _torch_threads import one_torch_thread  # noqa: F401,E402

MODEL_RTOL = 1e-5


def _max_rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _np_state(jm):
    return {k: np.asarray(v.numpy()).astype(np.float32)
            for k, v in jm.state_dict().items()}


def _models(seed=0):
    paddle.seed(seed)
    jm = JE.ErnieForPretraining(JE.ernie_tiny())
    jm.eval()
    tcfg = TE.ernie_tiny()
    tm = TE.ErnieForPretraining(tcfg, device="cpu")
    tm.load_state_dict(state_from_jax(_np_state(jm), tcfg, "cpu"))
    tm.eval()
    return jm, tm


def _ids(seed=1, B=2, S=64):
    return np.random.default_rng(seed).integers(0, 1024, (B, S))


def test_state_dict_keys_and_shapes_match_reference():
    jm, tm = _models()
    want = {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == want
    assert "ernie.embeddings.word_emb" in got
    assert "ernie.blocks.3.qkv.weight" in got and "head.weight" in got
    back = to_numpy(tm)
    assert all(np.array_equal(back[k], v) for k, v in _np_state(jm).items())
    assert all(p.dtype == torch.float32 for p in tm.parameters())


def test_eval_forward_matches_reference():
    jm, tm = _models()
    ids = _ids()
    want = jm(paddle.to_tensor(ids)).numpy()
    seq_j = jm.ernie(paddle.to_tensor(ids)).numpy()
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
        seq = tm.ernie(torch.from_numpy(ids)).numpy()
    assert got.shape == (2, 64, 1024) and got.dtype == np.float32
    assert _max_rel(got, want) <= MODEL_RTOL
    assert _max_rel(seq, seq_j) <= MODEL_RTOL


def test_loss_matches_reference():
    """bench.py's pretraining loss, `model.loss(ids, ids)`, and one with
    ignored labels."""
    jm, tm = _models()
    ids = _ids(seed=2)
    labels = np.random.default_rng(3).integers(0, 1024, ids.shape)
    labels[:, ::4] = -100
    for lab in (ids, labels):
        want = float(jm.loss(paddle.to_tensor(ids),
                             paddle.to_tensor(lab)).numpy())
        with torch.no_grad():
            got = tm.loss(torch.from_numpy(ids), torch.from_numpy(lab)).item()
        assert abs(got - want) <= MODEL_RTOL * abs(want)


def test_head_matches_reference():
    """`ErnieHead` (the pipeline's suffix): final norm + decoder."""
    paddle.seed(4)
    cfg = JE.ernie_tiny()
    jh = JE.ErnieHead(cfg)
    th = TE.ErnieHead(TE.ernie_tiny(), device="cpu")
    th.load_state_dict(state_from_jax(_np_state(jh), TE.ernie_tiny(), "cpu"))
    x = np.random.default_rng(5).standard_normal((2, 8, 128)).astype(
        np.float32)
    want = jh(paddle.to_tensor(x)).numpy()
    with torch.no_grad():
        got = th(torch.from_numpy(x)).numpy()
    assert _max_rel(got, want) <= MODEL_RTOL


@pytest.mark.parametrize("flag", [True, False], ids=["flash", "dense"])
def test_attention_route_and_kill_switch(flag, monkeypatch):
    """FLAGS_use_flash_attention on: every block calls
    `flash_attention_bshd(causal=False)`; off: the reference's dense
    branch, never the flash function. Both match the reference on every
    row."""
    jm, tm = _models()
    ids = _ids(seed=6)
    calls = []
    real = t_fa.flash_attention_bshd

    def spy(*a, **kw):
        calls.append(kw.get("causal"))
        return real(*a, **kw)

    monkeypatch.setattr(t_fa, "flash_attention_bshd", spy)
    ptt.set_flags({"FLAGS_use_flash_attention": flag})
    try:
        with torch.no_grad():
            got = tm(torch.from_numpy(ids)).numpy()
    finally:
        ptt.set_flags({"FLAGS_use_flash_attention": True})
    assert calls == ([False] * 4 if flag else [])
    want = jm(paddle.to_tensor(ids)).numpy()
    assert _max_rel(got, want) <= MODEL_RTOL


def test_presets_match_reference():
    for name in ("ernie_tiny", "ernie_base", "ernie_3_0_medium"):
        got = dataclasses.asdict(getattr(TE, name)())
        want = dataclasses.asdict(getattr(JE, name)())
        assert got == want, name
    base = TE.ernie_base()
    assert (base.hidden_size, base.num_hidden_layers, base.head_dim,
            base.vocab_size, base.layer_norm_eps,
            base.hidden_dropout_prob) == (768, 12, 64, 40000, 1e-5, 0.1)
    assert TE.ernie_3_0_medium().num_hidden_layers == 6
    assert tmodels.ErnieForPretraining is TE.ErnieForPretraining


def test_device_rule_and_pipeline():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TE.ErnieForPretraining(TE.ernie_tiny())
    with pytest.raises(NotImplementedError, match="PipelineLayer"):
        TE.build_ernie_pipeline(TE.ernie_tiny(), 2)
