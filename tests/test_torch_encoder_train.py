"""Encoder training (bench.py's BERT masked-LM fine-tuning and ERNIE
pretraining configurations) through the port against the JAX package,
in fp32 on the CPU, at `ernie_tiny` and `bert_tiny` on seeded numpy ids,
weights moved by `models.convert.state_from_jax`.

- Dropout 0, train mode: the loss and every grad of ERNIE, BERT without
  a mask and BERT with a padding mask (labels -100 on padding: the
  port's padded query rows attend to padded keys, the reference's CPU
  route to valid keys, and no valid row or grad depends on them).
- A 5-step `TrainStep` trajectory with bench.py's `AdamW(1e-4, weight
  decay 0.01)` against `paddle_tpu.jit.TrainStep`: losses and final
  weights (relative L2 per tensor, ROADMAP's Differences by design 1).
  An element whose first grad is at summation noise (|g| <=
  NOISE_GRAD: the key third of each QKV bias, whose grad is 0
  analytically since a softmax ignores a shift common to a row's
  scores, and the odd element near 0) moves by up to lr a step on that
  noise's sign; those are held to Adam's bound, 2 lr a step, and the
  rest of the tensor to the relative L2 limit. The reference's compiled
  step folds the step into its dropout key inside the executable, so
  no mask can be shared there: the trajectory runs at dropout 0.
- Dropout on (hidden 0.1, BERT's attention probs 0.1), eager: with the
  reference's masks fed to the port (`_torch_masks.SharedMasks`), the
  loss and every grad match. BERT's probs dropout takes the dense route
  on both sides, so every row agrees.
- The port's own masks in a `TrainStep`: drawn from the dropout stream
  in the forward's order, new masks each step, binomial keep shares,
  the same losses after `core.seed` with the same seed.

Limits, as max|a - b| / max|b|: LOSS_RTOL for the loss, GRAD_RTOL for
each grad (f32 summation order through two or four layers and the
vocabulary head), TRAJ_RTOL for the trajectory.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.models import bert as JB
from paddle_tpu.models import ernie as JE
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import testing
from paddle_tpu_torch.framework import core
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import bert as TB
from paddle_tpu_torch.models import ernie as TE
from paddle_tpu_torch.models.convert import state_from_jax, to_numpy
from paddle_tpu_torch.nn.functional import common as t_common

from _torch_masks import SharedMasks

from _torch_threads import one_torch_thread  # noqa: F401,E402

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
TRAJ_RTOL = 1e-5
NOISE_GRAD = 1e-6
B, S = 2, 64
LENGTHS = (64, 37)
CASES = ["ernie", "bert", "bert_mask"]


def _max_rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _models(case, hidden=0.0, probs=0.0, seed=0):
    """The reference's model in train mode and the port's with its
    weights, at the given dropout probabilities."""
    paddle.seed(seed)
    if case == "ernie":
        jm = JE.ErnieForPretraining(JE.ernie_tiny(hidden_dropout_prob=hidden))
        tcfg = TE.ernie_tiny(hidden_dropout_prob=hidden)
        tm = TE.ErnieForPretraining(tcfg, device="cpu")
    else:
        kw = dict(hidden_dropout_prob=hidden,
                  attention_probs_dropout_prob=probs)
        jm = JB.BertForMaskedLM(JB.bert_tiny(**kw))
        tcfg = TB.bert_tiny(**kw)
        tm = TB.BertForMaskedLM(tcfg, device="cpu")
    state = {k: np.asarray(v.numpy()).astype(np.float32)
             for k, v in jm.state_dict().items()}
    tm.load_state_dict(state_from_jax(state, tcfg, "cpu"))
    jm.train()
    tm.train()
    return jm, tm


def _batch(case, seed=1):
    """(ids, labels, mask): bench.py's `loss(ids, ids)`; with a mask,
    the padding labelled -100."""
    ids = np.random.default_rng(seed).integers(0, 1024, (B, S))
    if case != "bert_mask":
        return ids, ids, None
    mask = (np.arange(S)[None] < np.array(LENGTHS)[:, None]).astype(np.int64)
    return ids, np.where(mask == 1, ids, -100), mask


def _loss_fns(case, jm, tm, batch):
    ids, labels, mask = batch
    if case == "ernie":
        return (lambda: jm.loss(paddle.to_tensor(ids),
                                paddle.to_tensor(labels)),
                lambda: tm.loss(torch.from_numpy(ids),
                                torch.from_numpy(labels)))
    jmask = None if mask is None else paddle.to_tensor(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    return (lambda: jm.loss(paddle.to_tensor(ids), paddle.to_tensor(labels),
                            attention_mask=jmask),
            lambda: tm.loss(torch.from_numpy(ids), torch.from_numpy(labels),
                            attention_mask=tmask))


def _assert_loss_and_grads(case, jm, tm, batch):
    j_loss, t_loss = _loss_fns(case, jm, tm, batch)
    lj = j_loss()
    lj.backward()
    lt = t_loss()
    lt.backward()
    want = float(lj.numpy())
    assert abs(lt.item() - want) <= LOSS_RTOL * abs(want)
    got = to_numpy(tm, grads=True)
    compared = 0
    for name, p in jm.named_parameters():
        jg = None if p.grad is None else np.asarray(p.grad.numpy())
        if name not in got:
            # no path from the loss (BERT's pooler under a masked-LM
            # loss): the reference's grad is absent or zero
            assert jg is None or not jg.any(), name
            continue
        assert _max_rel(got[name], jg) <= GRAD_RTOL, name
        compared += 1
    return compared


@pytest.mark.parametrize("case", CASES)
def test_dropout0_loss_and_every_grad_match_reference(case):
    jm, tm = _models(case)
    n = _assert_loss_and_grads(case, jm, tm, _batch(case))
    assert n == sum(1 for _ in tm.parameters()) - (2 if "bert" in case
                                                   else 0)


@pytest.mark.parametrize("case", CASES)
def test_dropout_with_shared_masks_matches_reference(case, monkeypatch):
    """Hidden dropout 0.1 (and BERT's probs dropout 0.1): the same masks
    give the same loss and grads. Draw order: the embeddings, then per
    layer ERNIE's FFN; BERT's probs, attention output and FFN."""
    jm, tm = _models(case, hidden=0.1, probs=0.1)
    masks = SharedMasks(monkeypatch)
    _assert_loss_and_grads(case, jm, tm, _batch(case, seed=2))
    assert masks.all_used()
    L = len(tm.ernie.blocks) if case == "ernie" else len(tm.bert.layers)
    per_layer = 1 if case == "ernie" else 3
    assert len(masks.drawn) == 1 + per_layer * L
    if case != "ernie":
        assert masks.drawn[1].shape == (B, 2, S, S)      # the probs


@pytest.mark.parametrize("case", CASES)
def test_train_step_trajectory_matches_reference(case):
    """5 steps of bench.py's step (`AdamW(1e-4, weight_decay=0.01)`) at
    dropout 0 against the reference's compiled `TrainStep`."""
    jm, tm = _models(case)
    j_loss, t_loss = _loss_fns(case, jm, tm, _batch(case, seed=3))
    t_loss().backward()
    first = to_numpy(tm, grads=True)
    tm.zero_grad(set_to_none=True)
    lr, steps = 1e-4, 5
    jo = jopt.AdamW(learning_rate=lr, parameters=jm.parameters(),
                    weight_decay=0.01)
    js = paddle.jit.TrainStep(jm, jo, j_loss)
    to = topt.AdamW(learning_rate=lr, parameters=tm.parameters(),
                    weight_decay=0.01)
    ts = TrainStep(tm, to, t_loss)
    j_losses = [float(js().numpy()) for _ in range(steps)]
    t_losses = [ts().item() for _ in range(steps)]
    assert t_losses[-1] < t_losses[0]
    np.testing.assert_allclose(t_losses, j_losses, rtol=TRAJ_RTOL)
    got = to_numpy(tm)
    for k, p in jm.state_dict().items():
        want = np.asarray(p.data, np.float64)
        noise = (np.abs(first[k]) <= NOISE_GRAD if k in first
                 else np.zeros(want.shape, bool))
        diff = got[k] - want
        assert np.abs(diff[noise]).max(initial=0.0) <= 2 * lr * steps, k
        err, norm = (np.linalg.norm(t[~noise]) for t in (diff, want))
        assert err <= TRAJ_RTOL * norm, (k, err, norm)
    assert all(p.grad is None for p in tm.parameters())


def _recording_keep_mask(monkeypatch):
    """Wrap the port's `_keep_mask`: each draw's shape, p and mask, in
    order."""
    drawn = []
    real = t_common._keep_mask

    def record(shape, p, generator, device):
        keep = real(shape, p, generator, device)
        drawn.append((tuple(shape), p, keep))
        return keep

    monkeypatch.setattr(t_common, "_keep_mask", record)
    return drawn


@pytest.mark.parametrize("case", ["ernie", "bert"])
def test_train_step_draws_the_stream_in_forward_order(case, monkeypatch):
    """Under `TrainStep` the masks come from the dropout stream in the
    forward's order, new ones each step, each keep share binomial; the
    remat policy changes nothing (an encoder has no remat site); after
    `core.seed` with the same seed the same steps give the same losses."""
    drawn = _recording_keep_mask(monkeypatch)
    batch = _batch(case, seed=4)

    def run(remat_policy):
        core.seed(11)
        jm, tm = _models(case, hidden=0.1, probs=0.1)
        opt = topt.AdamW(learning_rate=1e-4, parameters=tm.parameters(),
                         weight_decay=0.01)
        step = TrainStep(tm, opt, _loss_fns(case, jm, tm, batch)[1],
                         remat_policy=remat_policy)
        return [step().item() for _ in range(2)]

    losses = run("save_matmul_outputs")
    hidden = (B, S, 128)
    if case == "ernie":
        order = [hidden] * (1 + 4)
    else:
        order = [hidden] + [(B, 2, S, S), hidden, hidden] * 2
    assert [d[0] for d in drawn] == order * 2
    assert all(d[1] == 0.1 for d in drawn)
    n = len(order)
    assert not any(torch.equal(a[2], b[2])
                   for a, b in zip(drawn[:n], drawn[n:2 * n]))
    for _, p, keep in drawn:
        assert abs(testing.keep_share_sigmas(keep, p)) \
            <= testing.DROPOUT_SIGMAS
    assert run(None) == losses
    assert run("save_matmul_outputs") == losses
    assert torch.equal(drawn[0][2], drawn[2 * n][2])


def test_encoder_launch_rule():
    """`testing.encoder_launches` names only `encoder_counters` wrappers:
    the one-length route's forward, delta and backward, the segment
    route's forward, delta, dkv and dq, L a pass each; the dense route
    none. On the CPU the plain versions run: no counter moves."""
    counters = testing.encoder_counters()
    assert testing.encoder_launches(12, 5, "flash") == {
        "flash_attention_fwd": 60, "flash_attention_delta": 60,
        "flash_attention_bwd": 60}
    assert testing.encoder_launches(2, 1, "segment") == {
        "flash_attention_seg_fwd": 2, "flash_attention_delta": 2,
        "flash_attention_seg_dkv": 2, "flash_attention_seg_dq": 2}
    assert testing.encoder_launches(12, 5, "dense") == {}
    for route in ("flash", "segment"):
        assert set(testing.encoder_launches(1, 1, route)) <= set(counters)
    with pytest.raises(ValueError, match="route"):
        testing.encoder_launches(1, 1, "bias")
    before = {n: c.launches for n, c in counters.items()}
    jm, tm = _models("bert_mask")
    _loss_fns("bert_mask", jm, tm, _batch("bert_mask"))[1]().backward()
    assert {n: c.launches for n, c in counters.items()} == before
