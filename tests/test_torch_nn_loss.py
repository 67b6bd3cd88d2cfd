"""The port's losses (paddle_tpu_torch.nn.functional.loss and
nn.layer.loss) against the JAX package, in fp32 on the CPU, from the
same seeded numpy inputs: each loss forward and the grad of its input
(the reference tape's, `jax.vjp` underneath, against torch autograd),
in every reduction.

`cross_entropy` is held in each case the port once refused (class
weights, soft labels, label smoothing on hard and soft labels,
`use_softmax=False`, a non-last axis) and in the hard-label route rows
6-7 serve, which stays `_plain_cross_entropy` bit for bit on the CPU.

Limit: RTOL 1e-5 as max|a - b| / max|b| (the same f32 formula).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as JN
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch import nn as TN
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.functional import loss as t_loss

from _torch_threads import one_torch_thread  # noqa: F401,E402

RTOL = 1e-5


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


def _check(j_fn, t_fn, x, rest, rng):
    """Loss and the grad of x (a float array), the other inputs `rest`
    held fixed, under one random cotangent."""
    jx, tx = _j(x, True), _t(x, True)
    yj = j_fn(jx, *[_j(r) for r in rest])
    yt = t_fn(tx, *[_t(r) for r in rest])
    assert _max_rel(yt, yj.numpy()) <= RTOL
    g = rng.standard_normal(tuple(yt.shape)).astype(np.float32)
    (yj * _j(g)).sum().backward()
    (yt * _t(g)).sum().backward()
    assert _max_rel(tx.grad, jx.grad.numpy()) <= RTOL


def _case(seed=0, N=6, C=5):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((N, C)).astype(np.float32) * 2
    labels = rng.integers(0, C, N).astype(np.int64)
    labels[1] = -100
    soft = rng.random((N, C)).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    weight = (rng.random(C) + 0.5).astype(np.float32)
    return rng, logits, labels, soft, weight


CE_CASES = {
    "hard": dict(),
    "hard_ignore3": dict(ignore_index=3),
    "weight": dict(weight=True),
    "smooth": dict(label_smoothing=0.1),
    "smooth_weight": dict(label_smoothing=0.2, weight=True),
    "soft": dict(soft=True),
    "soft_flag": dict(soft=True, soft_label=True),
    "soft_weight": dict(soft=True, weight=True),
    "soft_smooth": dict(soft=True, label_smoothing=0.1),
    "no_softmax": dict(use_softmax=False),
    "no_softmax_soft": dict(use_softmax=False, soft=True),
    "label_col": dict(label_col=True),
}


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("case", sorted(CE_CASES))
def test_cross_entropy_matches_reference(case, reduction):
    kw = dict(CE_CASES[case])
    rng, logits, labels, soft, weight = _case()
    use_w = kw.pop("weight", False)
    is_soft = kw.pop("soft", False)
    col = kw.pop("label_col", False)
    if not kw.get("use_softmax", True):
        logits = np.abs(logits) / np.abs(logits).sum(-1, keepdims=True)
    if "ignore_index" in kw:
        labels = np.where(labels == -100, kw["ignore_index"], labels)
    lab = soft if is_soft else (labels[:, None] if col else labels)
    rest = [lab] + ([weight] if use_w else [])

    def run(F):
        def fn(x, y, *w):
            return F.cross_entropy(x, y, *w, reduction=reduction, **kw)
        return fn

    _check(run(JF), run(TF), logits, rest, rng)


@pytest.mark.parametrize("case", ["hard", "weight", "smooth", "soft"])
def test_cross_entropy_non_last_axis(case):
    """Classes on axis 1 of [N, C, L] logits."""
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 5, 4)).astype(np.float32)
    labels = rng.integers(0, 5, (3, 4)).astype(np.int64)
    labels[0, 2] = -100
    soft = rng.random((3, 5, 4)).astype(np.float32)
    soft /= soft.sum(1, keepdims=True)
    weight = (rng.random(5) + 0.5).astype(np.float32)
    kw = {"smooth": dict(label_smoothing=0.1)}.get(case, {})
    lab = soft if case == "soft" else labels
    rest = [lab] + ([weight] if case == "weight" else [])

    def run(F):
        def fn(x, y, *w):
            return F.cross_entropy(x, y, *w, axis=1, **kw)
        return fn

    _check(run(JF), run(TF), logits, rest, rng)


def test_hard_label_route_is_unchanged():
    """Hard labels without weights or smoothing on the last axis keep the
    route rows 6-7 serve: on the CPU `_plain_cross_entropy`, bit for
    bit, for every reduction."""
    _, logits, labels, _, _ = _case(2, N=9, C=7)
    x, y = _t(logits), _t(labels)
    for red in ("mean", "sum", "none"):
        assert torch.equal(TF.cross_entropy(x, y, reduction=red),
                           t_loss._plain_cross_entropy(x, y, -100, red))


@pytest.mark.parametrize("return_softmax", [False, True])
@pytest.mark.parametrize("soft", [False, True])
def test_softmax_with_cross_entropy(soft, return_softmax):
    rng, logits, labels, probs, _ = _case(3)
    lab = probs if soft else labels[:, None]
    got = TF.softmax_with_cross_entropy(_t(logits), _t(lab), soft_label=soft,
                                        return_softmax=return_softmax)
    want = JF.softmax_with_cross_entropy(_j(logits), _j(lab),
                                         soft_label=soft,
                                         return_softmax=return_softmax)
    if return_softmax:
        assert _max_rel(got[1], want[1].numpy()) <= RTOL
        got, want = got[0], want[0]
    assert got.shape == (6, 1)
    assert _max_rel(got, want.numpy()) <= RTOL


LOSSES = ["mse_loss", "l1_loss", "smooth_l1_loss", "smooth_l1_loss_delta",
          "square_error_cost", "bce", "bce_weight", "bce_logits",
          "bce_logits_pos_weight", "bce_logits_weight", "kl_div",
          "kl_div_log_target", "nll_loss", "nll_loss_weight",
          "nll_loss_nd"]


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("name", LOSSES)
def test_losses_match_reference(name, reduction):
    rng = np.random.default_rng(4)
    a = rng.standard_normal((4, 5)).astype(np.float32)
    b = rng.standard_normal((4, 5)).astype(np.float32)
    prob = (1 / (1 + np.exp(-a))).astype(np.float32)
    target = (rng.random((4, 5)) > 0.5).astype(np.float32)
    w = (rng.random((4, 5)) + 0.5).astype(np.float32)
    pw = (rng.random(5) + 0.5).astype(np.float32)
    logp = (a - np.log(np.exp(a).sum(-1, keepdims=True))).astype(np.float32)
    dist = np.exp(logp[::-1].copy()).astype(np.float32)
    ids = rng.integers(0, 5, 4).astype(np.int64)
    ids[2] = -100
    cw = (rng.random(5) + 0.5).astype(np.float32)
    r = dict(reduction=reduction)
    cases = {
        "mse_loss": (lambda F: lambda x, y: F.mse_loss(x, y, **r), a, [b]),
        "l1_loss": (lambda F: lambda x, y: F.l1_loss(x, y, **r), a, [b]),
        "smooth_l1_loss": (lambda F: lambda x, y: F.smooth_l1_loss(
            x, y, **r), a, [b]),
        "smooth_l1_loss_delta": (lambda F: lambda x, y: F.smooth_l1_loss(
            x, y, delta=0.5, **r), a, [b]),
        "square_error_cost": (lambda F: lambda x, y: F.square_error_cost(
            x, y), a, [b]),
        "bce": (lambda F: lambda x, y: F.binary_cross_entropy(x, y, **r),
                prob, [target]),
        "bce_weight": (lambda F: lambda x, y, z: F.binary_cross_entropy(
            x, y, z, **r), prob, [target, w]),
        "bce_logits": (lambda F: lambda x, y:
                       F.binary_cross_entropy_with_logits(x, y, **r),
                       a, [target]),
        "bce_logits_pos_weight": (
            lambda F: lambda x, y, z: F.binary_cross_entropy_with_logits(
                x, y, pos_weight=z, **r), a, [target, pw]),
        "bce_logits_weight": (
            lambda F: lambda x, y, z: F.binary_cross_entropy_with_logits(
                x, y, z, **r), a, [target, w]),
        "kl_div": (lambda F: lambda x, y: F.kl_div(
            x, y, reduction if reduction != "none" else "batchmean"),
            logp, [dist]),
        "kl_div_log_target": (lambda F: lambda x, y: F.kl_div(
            x, y, log_target=True, **r), logp, [np.log(dist)]),
        "nll_loss": (lambda F: lambda x, y: F.nll_loss(x, y, **r), logp,
                     [ids]),
        "nll_loss_weight": (lambda F: lambda x, y, z: F.nll_loss(
            x, y, z, **r), logp, [ids, cw]),
        "nll_loss_nd": (lambda F: lambda x, y: F.nll_loss(x, y, **r),
                        np.log(np.abs(rng.random((2, 5, 3)).astype(
                            np.float32)) + 0.1), [rng.integers(
                                0, 5, (2, 3)).astype(np.int64)]),
    }
    make, x, rest = cases[name]
    _check(make(JF), make(TF), x, rest, rng)


def test_loss_layers_match_reference():
    rng, logits, labels, soft, weight = _case(5)
    a = rng.standard_normal((4, 5)).astype(np.float32)
    b = rng.standard_normal((4, 5)).astype(np.float32)
    prob = (1 / (1 + np.exp(-a))).astype(np.float32)
    target = (rng.random((4, 5)) > 0.5).astype(np.float32)
    logp = np.log(prob / prob.sum(-1, keepdims=True)).astype(np.float32)
    ids = rng.integers(0, 5, 4).astype(np.int64)
    layers = [
        ("CrossEntropyLoss", dict(label_smoothing=0.1, reduction="sum"),
         logits, labels),
        ("MSELoss", {}, a, b), ("L1Loss", dict(reduction="sum"), a, b),
        ("NLLLoss", {}, logp, ids), ("BCELoss", {}, prob, target),
        ("BCEWithLogitsLoss", {}, a, target),
        ("SmoothL1Loss", dict(delta=0.7), a, b),
        ("KLDivLoss", dict(reduction="batchmean"), logp, prob)]
    for name, kw, x, y in layers:
        _check(getattr(JN, name)(**kw), getattr(TN, name)(**kw), x, [y],
               rng)
    jw, tw = _j(weight), _t(weight)
    _check(lambda x, y: JN.CrossEntropyLoss(weight=jw, soft_label=True)(x, y),
           lambda x, y: TN.CrossEntropyLoss(weight=tw, soft_label=True)(x, y),
           logits, [soft], rng)
