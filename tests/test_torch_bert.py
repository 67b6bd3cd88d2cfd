"""Port BERT (paddle_tpu_torch.models.bert, in eval) against the JAX
package's `BertForMaskedLM` at `bert_tiny` (hidden 128, 2 layers, 2
heads of 64), fp32 on the CPU. Weights move from the reference's
`state_dict()` through `models.convert.state_from_jax`; inputs are
seeded numpy.

The port's attention is the segment-id flash route on both devices
(its plain version here), where a padded query row attends to the
padded keys, as on the TPU; the reference's CPU route (its dense branch)
has it attend to the valid keys. So the tests compare the sequence
output and the logits at valid rows, the pooled output (row 0, always
valid), and the masked-LM loss with the padding labels at -100. Under
FLAGS_use_flash_attention=0 the port's CPU route is the reference's
dense branch and every row is compared. Limit: max|a - b| / max|b| <=
MODEL_RTOL = 1e-5 (f32 summation order through two post-LN layers).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu.models import bert as JB
from paddle_tpu_torch.models import bert as TB
from paddle_tpu_torch.models.convert import state_from_jax, to_numpy

from _torch_threads import one_torch_thread  # noqa: F401,E402

MODEL_RTOL = 1e-5
LENGTHS = (64, 40, 17)


def _max_rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _np_state(jm):
    return {k: np.asarray(v.numpy()).astype(np.float32)
            for k, v in jm.state_dict().items()}


def _models(cls_j=JB.BertForMaskedLM, cls_t=TB.BertForMaskedLM, seed=0,
            **kw):
    paddle.seed(seed)
    jcfg = JB.bert_tiny()
    jm = cls_j(jcfg, **kw)
    jm.eval()
    tcfg = TB.bert_tiny()
    tm = cls_t(tcfg, device="cpu", **kw)
    tm.load_state_dict(state_from_jax(_np_state(jm), tcfg, "cpu"))
    tm.eval()
    return jm, tm


def _batch(seed=1, S=64):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 1024, (len(LENGTHS), S))
    mask = (np.arange(S)[None] < np.array(LENGTHS)[:, None]).astype(np.int64)
    tt = (np.arange(S)[None] >= 20).astype(np.int64).repeat(len(LENGTHS), 0)
    return ids, mask, tt


def test_state_dict_keys_and_shapes_match_reference():
    jm, tm = _models()
    want = {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == want
    back = to_numpy(tm)
    assert all(np.array_equal(back[k], v) for k, v in _np_state(jm).items())


@pytest.mark.parametrize("with_mask", [True, False], ids=["padded", "no_mask"])
def test_masked_lm_matches_reference(with_mask):
    """Sequence output and logits at valid rows, pooled output."""
    jm, tm = _models()
    ids, mask, tt = _batch()
    if not with_mask:
        mask = np.ones_like(mask)
    jmask = paddle.to_tensor(mask) if with_mask else None
    tmask = torch.from_numpy(mask) if with_mask else None
    seq_j, pooled_j = jm.bert(paddle.to_tensor(ids), paddle.to_tensor(tt),
                              jmask)
    logits_j = jm(paddle.to_tensor(ids), paddle.to_tensor(tt), jmask)
    with torch.no_grad():
        seq, pooled = tm.bert(torch.from_numpy(ids), torch.from_numpy(tt),
                              tmask)
        logits = tm(torch.from_numpy(ids), torch.from_numpy(tt), tmask)
    valid = mask.astype(bool)
    assert _max_rel(seq.numpy()[valid], seq_j.numpy()[valid]) <= MODEL_RTOL
    assert _max_rel(pooled.numpy(), pooled_j.numpy()) <= MODEL_RTOL
    assert _max_rel(logits.numpy()[valid],
                    logits_j.numpy()[valid]) <= MODEL_RTOL
    assert logits.shape == (len(LENGTHS), ids.shape[1], 1024)


def test_masked_lm_loss_matches_reference():
    jm, tm = _models()
    ids, mask, _ = _batch(seed=2)
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 1024, ids.shape)
    labels[mask == 0] = -100
    labels[:, ::3] = -100
    want = float(jm.loss(paddle.to_tensor(ids), paddle.to_tensor(labels),
                         attention_mask=paddle.to_tensor(mask)).numpy())
    with torch.no_grad():
        got = tm.loss(torch.from_numpy(ids), torch.from_numpy(labels),
                      attention_mask=torch.from_numpy(mask)).item()
    assert abs(got - want) <= MODEL_RTOL * abs(want)


def test_sequence_classification_matches_reference():
    jm, tm = _models(JB.BertForSequenceClassification,
                     TB.BertForSequenceClassification, num_classes=3)
    ids, mask, _ = _batch(seed=4)
    want = jm(paddle.to_tensor(ids), attention_mask=paddle.to_tensor(mask))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask))
    assert got.shape == (len(LENGTHS), 3)
    assert _max_rel(got.numpy(), want.numpy()) <= MODEL_RTOL


def test_padding_garbage_moves_no_valid_row():
    """The counterpart of the reference's test_bert_mask_semantics: other
    token ids in the padded slots change no valid row's logits, on the
    port and on the reference alike."""
    jm, tm = _models()
    ids, mask, _ = _batch(seed=5)
    junk = ids.copy()
    rng = np.random.default_rng(6)
    junk[mask == 0] = rng.integers(1, 1024, int((mask == 0).sum()))
    valid = mask.astype(bool)
    with torch.no_grad():
        a, b = (tm(torch.from_numpy(x), attention_mask=torch.from_numpy(mask))
                .numpy() for x in (ids, junk))
    ja, jb = (jm(paddle.to_tensor(x), attention_mask=paddle.to_tensor(mask))
              .numpy() for x in (ids, junk))
    assert _max_rel(a[valid], b[valid]) <= 1e-6
    assert _max_rel(ja[valid], jb[valid]) <= 1e-6
    assert np.abs(a[~valid] - b[~valid]).max() > 0     # padded rows move


def test_dense_kill_switch_matches_reference_on_every_row():
    """FLAGS_use_flash_attention=0: the reference's dense branch on the
    CPU on both sides, so padded rows agree too."""
    jm, tm = _models()
    ids, mask, _ = _batch(seed=7)
    ptt.set_flags({"FLAGS_use_flash_attention": False})
    try:
        with torch.no_grad():
            got = tm(torch.from_numpy(ids),
                     attention_mask=torch.from_numpy(mask)).numpy()
    finally:
        ptt.set_flags({"FLAGS_use_flash_attention": True})
    want = jm(paddle.to_tensor(ids),
              attention_mask=paddle.to_tensor(mask)).numpy()
    assert _max_rel(got, want) <= MODEL_RTOL


def test_training_with_dropout_raises():
    """Train mode with the default dropout runs and differs from eval;
    at p = 0 train mode equals eval. tests/test_torch_encoder_train.py
    holds training to the reference."""
    _, tm = _models()
    ids, mask, _ = _batch()
    args = (torch.from_numpy(ids),)
    kw = dict(attention_mask=torch.from_numpy(mask))
    with torch.no_grad():
        want = tm(*args, **kw)
        tm.train()
        got = tm(*args, **kw)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert not torch.equal(got, want)
    cfg = TB.bert_tiny(hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0)
    model = TB.BertForMaskedLM(cfg, device="cpu")
    with torch.no_grad():
        out = model(*args, **kw)
        model.eval()
        assert torch.equal(model(*args, **kw), out)
    assert out.shape == (len(LENGTHS), ids.shape[1], 1024)


def test_presets_and_device_rule():
    base, large = TB.bert_base(), TB.bert_large()
    assert (base.hidden_size, base.num_hidden_layers, base.head_dim,
            base.vocab_size, base.max_position_embeddings) == \
        (768, 12, 64, 30522, 512)
    assert (large.hidden_size, large.num_hidden_layers, large.head_dim) == \
        (1024, 24, 64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TB.BertForMaskedLM(TB.bert_tiny())
