"""The port's nn core (paddle_tpu_torch.nn: `Layer`, `ParamAttr`, the
initializers, the containers, the activations, the norms and the common
functionals and layers) against the JAX package, in fp32 on the CPU,
from the same seeded numpy inputs. Weights go through
`models.convert.layer_state_from_jax`; grads are the reference tape's
(`jax.vjp` underneath) against torch autograd, under a random
cotangent.

Limits, as max|a - b| / max|b|: RTOL 1e-5 (the same formula in f32;
libm and summation order differ by a few ulp). The random initializers
cannot reproduce `jax.random`: they are held to their distribution's
bounds and moments within SIGMAS standard errors, the deterministic ones
exactly.
"""
import math
from collections import OrderedDict

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as JN
import paddle_tpu.nn.functional as JF
from paddle_tpu.nn import initializer as JI
from paddle_tpu import optimizer as jopt
from paddle_tpu_torch import nn as TN
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models.convert import layer_state_from_jax
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn import initializer as TI

from _torch_threads import one_torch_thread  # noqa: F401,E402

RTOL = 1e-5
SIGMAS = 5.0


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


def _j(a, grad=False):
    return paddle.to_tensor(np.array(a, np.float32), stop_gradient=not grad)


def _max_rel(got, want):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _carry(jl, tl):
    return layer_state_from_jax({k: np.asarray(v.numpy())
                                 for k, v in jl.state_dict().items()}, tl)


def _both(j_fn, t_fn, inputs, rng, grad=True):
    """Forward of both packages on the same inputs, then each input's
    grad under one random cotangent; asserts every pair within RTOL."""
    jx = [_j(a, grad) for a in inputs]
    tx = [_t(a, grad) for a in inputs]
    yj, yt = j_fn(*jx), t_fn(*tx)
    assert _max_rel(yt, yj.numpy()) <= RTOL
    if not grad:
        return
    g = _rand(rng, *yt.shape)
    (yj * _j(g)).sum().backward()
    (yt * _t(g)).sum().backward()
    for a, b in zip(tx, jx):
        assert _max_rel(a.grad, b.grad.numpy()) <= RTOL


# ----------------------------------------------------------- activations

ACTS = [("relu", {}), ("relu6", {}), ("elu", {"alpha": 0.7}), ("selu", {}),
        ("celu", {"alpha": 1.3}), ("gelu", {}),
        ("gelu", {"approximate": True}), ("silu", {}), ("swish", {}),
        ("sigmoid", {}), ("hardsigmoid", {}), ("hardswish", {}),
        ("hardtanh", {"min": -0.5, "max": 0.8}),
        ("hardshrink", {"threshold": 0.3}),
        ("softshrink", {"threshold": 0.3}), ("tanhshrink", {}),
        ("leaky_relu", {"negative_slope": 0.2}), ("log_sigmoid", {}),
        ("softmax", {"axis": 0}), ("softmax", {"axis": -1,
                                               "dtype": "float32"}),
        ("log_softmax", {"axis": 1}),
        ("softplus", {"beta": 2.0, "threshold": 3.0}), ("softsign", {}),
        ("mish", {}), ("tanh", {}), ("thresholded_relu", {"threshold": 0.2}),
        ("glu", {"axis": -1}), ("maxout", {"groups": 2, "axis": 1}),
        ("rrelu", {"training": False})]


@pytest.mark.parametrize("name,kw", ACTS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(ACTS)])
def test_activation_matches_reference(name, kw):
    rng = np.random.default_rng(1)
    x = _rand(rng, 3, 4, 6, scale=3.0)
    _both(lambda a: getattr(JF, name)(a, **kw),
          lambda a: getattr(TF, name)(a, **kw), [x], rng)


INPLACE = ["relu_", "elu_", "selu_", "celu_", "silu_", "sigmoid_",
           "leaky_relu_", "hardswish_", "hardsigmoid_", "hardtanh_",
           "mish_", "softsign_", "thresholded_relu_", "softmax_", "tanh_"]


@pytest.mark.parametrize("name", INPLACE)
def test_inplace_activation_writes_its_input(name):
    """The in-place form writes the activation into x (the reference's
    value) and returns x; autograd through it equals the out-of-place
    form's."""
    assert hasattr(JF, name) and hasattr(TF, name)
    rng = np.random.default_rng(2)
    x = _rand(rng, 4, 6, scale=3.0)
    want = getattr(JF, name[:-1])(_j(x)).numpy()
    a = _t(x)
    out = getattr(TF, name)(a)
    assert out is a and _max_rel(a, want) <= RTOL
    leaf = _t(x, True)
    y = leaf * 1.0
    getattr(TF, name)(y).sum().backward()
    ref = _t(x, True)
    getattr(TF, name[:-1])(ref).sum().backward()
    assert torch.allclose(leaf.grad, ref.grad, rtol=1e-6, atol=1e-7)


def test_prelu_matches_reference():
    rng = np.random.default_rng(3)
    x = _rand(rng, 2, 6, 3, 3)
    w = _rand(rng, 6)
    _both(lambda a, b: JF.prelu(a, b), lambda a, b: TF.prelu(a, b),
          [x, w], rng)
    _both(lambda a, b: JF.prelu(a, b, data_format="NHWC"),
          lambda a, b: TF.prelu(a, b, data_format="NHWC"),
          [x.transpose(0, 2, 3, 1).copy(), w], rng)
    _both(lambda a, b: JF.prelu(a, b), lambda a, b: TF.prelu(a, b),
          [x, w[:1]], rng)


LAYER_ACTS = [("ReLU", ()), ("ReLU6", ()), ("ELU", (0.5,)), ("SELU", ()),
              ("CELU", ()), ("GELU", (True,)), ("Silu", ()), ("Swish", ()),
              ("Sigmoid", ()), ("Hardsigmoid", ()), ("Hardswish", ()),
              ("Hardtanh", (-0.5, 0.5)), ("Hardshrink", ()),
              ("Softshrink", ()), ("Tanhshrink", ()), ("LeakyReLU", (0.1,)),
              ("LogSigmoid", ()), ("Maxout", (2,)), ("Softmax", (1,)),
              ("LogSoftmax", ()), ("Softplus", ()), ("Softsign", ()),
              ("Mish", ()), ("Tanh", ()), ("ThresholdedReLU", (0.1,)),
              ("GLU", ()), ("Softmax2D", ())]


@pytest.mark.parametrize("name,args", LAYER_ACTS,
                         ids=[n for n, _ in LAYER_ACTS])
def test_activation_layer_matches_reference(name, args):
    rng = np.random.default_rng(4)
    x = _rand(rng, 2, 4, 3, 6, scale=2.0)
    _both(lambda a: getattr(JN, name)(*args)(a),
          lambda a: getattr(TN, name)(*args)(a), [x], rng)


def test_prelu_layer_and_random_activations():
    rng = np.random.default_rng(5)
    x = _rand(rng, 2, 6, 3, 3)
    jl, tl = JN.PReLU(6, 0.1), TN.PReLU(6, 0.1, device="cpu")
    assert _max_rel(tl.weight, jl.weight.numpy()) == 0.0
    _carry(jl, tl)
    assert _max_rel(tl(_t(x)), jl(_j(x)).numpy()) <= RTOL
    # rrelu in training: each negative element's slope in [lower, upper)
    g = torch.Generator().manual_seed(0)
    xt = _t(x)
    y = TF.rrelu(xt, 0.1, 0.3, training=True, generator=g)
    neg = xt < 0
    slope = y[neg] / xt[neg]
    assert bool((slope >= 0.1 - 1e-6).all() and (slope < 0.3 + 1e-6).all())
    assert torch.equal(y[~neg], xt[~neg])
    y2 = TF.rrelu(xt, 0.1, 0.3, generator=torch.Generator().manual_seed(0))
    assert torch.equal(y, y2)
    # gumbel softmax: rows of a distribution; hard rows one-hot with the
    # soft gradient
    soft = TF.gumbel_softmax(xt, 0.5, axis=1,
                             generator=torch.Generator().manual_seed(1))
    assert torch.allclose(soft.sum(1), torch.ones(2, 3, 3))
    leaf = _t(x, True)
    hard = TF.gumbel_softmax(leaf, 0.5, hard=True, axis=1,
                             generator=torch.Generator().manual_seed(1))
    assert torch.allclose(hard.detach().sum(1), torch.ones(2, 3, 3))
    assert bool(((hard.detach() - hard.detach().round()).abs()
                 < 1e-6).all())
    assert torch.equal(hard.detach().argmax(1), soft.argmax(1))
    (hard * _t(_rand(rng, 2, 6, 3, 3))).sum().backward()
    assert leaf.grad.abs().sum() > 0


# ----------------------------------------------------------------- norms

def test_norm_functionals_match_reference():
    rng = np.random.default_rng(6)
    x = _rand(rng, 3, 4, 5, 6)
    w, b = _rand(rng, 5, 6), _rand(rng, 5, 6)
    _both(lambda a, c, d: JF.layer_norm(a, [5, 6], c, d, 1e-5),
          lambda a, c, d: TF.layer_norm(a, [5, 6], c, d, 1e-5),
          [x, w, b], rng)
    _both(lambda a, c: JF.rms_norm(a, c, 1e-6),
          lambda a, c: TF.rms_norm(a, c, 1e-6), [x, w[0]], rng)
    for p in (2, 3):
        _both(lambda a: JF.normalize(a, p=p, axis=1),
              lambda a: TF.normalize(a, p=p, axis=1), [x], rng)
    wc, bc = _rand(rng, 4), _rand(rng, 4)
    _both(lambda a, c, d: JF.group_norm(a, 2, 1e-5, c, d),
          lambda a, c, d: TF.group_norm(a, 2, 1e-5, c, d), [x, wc, bc], rng)
    xl = x.transpose(0, 2, 3, 1).copy()
    _both(lambda a, c, d: JF.group_norm(a, 2, 1e-5, c, d, "NHWC"),
          lambda a, c, d: TF.group_norm(a, 2, 1e-5, c, d, "NHWC"),
          [xl, wc, bc], rng)
    _both(lambda a, c, d: JF.instance_norm(a, weight=c, bias=d),
          lambda a, c, d: TF.instance_norm(a, weight=c, bias=d),
          [x, wc, bc], rng)
    for size in (3, 4):
        _both(lambda a: JF.local_response_norm(a, size),
              lambda a: TF.local_response_norm(a, size), [x], rng)
        _both(lambda a: JF.local_response_norm(a, size, data_format="NHWC"),
              lambda a: TF.local_response_norm(a, size, data_format="NHWC"),
              [xl], rng)


@pytest.mark.parametrize("training,global_stats", [(True, None),
                                                   (False, None),
                                                   (True, True)])
def test_batch_norm_functional_matches_reference(training, global_stats):
    rng = np.random.default_rng(7)
    x = _rand(rng, 4, 3, 5)
    w, b = _rand(rng, 3), _rand(rng, 3)
    rm, rv = _rand(rng, 3), np.abs(_rand(rng, 3)) + 0.5
    jrm, jrv = _j(rm), _j(rv)
    trm, trv = _t(rm), _t(rv)
    _both(lambda a, c, d: JF.batch_norm(a, jrm, jrv, c, d, training, 0.8,
                                        1e-5, use_global_stats=global_stats),
          lambda a, c, d: TF.batch_norm(a, trm, trv, c, d, training, 0.8,
                                        1e-5, use_global_stats=global_stats),
          [x, w, b], rng)
    assert _max_rel(trm, jrm.numpy()) <= RTOL
    assert _max_rel(trv, jrv.numpy()) <= RTOL


def test_batch_norm_momentum_is_paddles():
    """running = 0.9 * running + 0.1 * batch (unbiased variance): torch's
    own batch_norm with its momentum = 1 - paddle's gives the same."""
    rng = np.random.default_rng(8)
    x = _t(_rand(rng, 8, 3, 4))
    layer = TN.BatchNorm1D(3, momentum=0.9, device="cpu")
    layer(x)
    rm, rv = torch.zeros(3), torch.ones(3)
    torch.nn.functional.batch_norm(x, rm, rv, training=True, momentum=0.1)
    assert torch.allclose(layer._mean, rm, rtol=1e-6, atol=1e-7)
    assert torch.allclose(layer._variance, rv, rtol=1e-6, atol=1e-7)
    mean = x.mean((0, 2))
    assert torch.allclose(layer._mean, 0.1 * mean, rtol=1e-6, atol=1e-7)


BN_CASES = [("BatchNorm1D", (4, 3), {}), ("BatchNorm1D", (4, 3, 5), {}),
            ("BatchNorm2D", (2, 3, 4, 4), {}),
            ("BatchNorm2D", (2, 4, 4, 3), {"data_format": "NHWC"}),
            ("BatchNorm3D", (2, 3, 2, 3, 3), {}),
            ("BatchNorm", (2, 3, 4, 4), {})]


@pytest.mark.parametrize("name,shape,kw", BN_CASES,
                         ids=[f"{n}-{len(s)}d-{i}" for i, (n, s, _)
                              in enumerate(BN_CASES)])
def test_batch_norm_layers_train_and_eval(name, shape, kw):
    """Two training steps (output, grads of x, weight and bias, the
    running statistics after each), then eval, against the reference."""
    rng = np.random.default_rng(9)
    jl = getattr(JN, name)(3, momentum=0.8, **kw)
    tl = getattr(TN, name)(3, momentum=0.8, device="cpu", **kw)
    assert list(tl.state_dict()) == list(jl.state_dict())
    _carry(jl, tl)
    for _ in range(2):
        x = _rand(rng, *shape)
        _both(jl, tl, [x], rng)
        assert _max_rel(tl._mean, jl._mean.numpy()) <= RTOL
        assert _max_rel(tl._variance, jl._variance.numpy()) <= RTOL
    jl.eval()
    tl.eval()
    _both(jl, tl, [_rand(rng, *shape)], rng)


def test_norm_layers_match_reference():
    rng = np.random.default_rng(10)
    x = _rand(rng, 2, 4, 3, 5)
    cases = [(JN.LayerNorm([3, 5]), TN.LayerNorm([3, 5], device="cpu")),
             (JN.RMSNorm(5), TN.RMSNorm(5, device="cpu")),
             (JN.GroupNorm(2, 4), TN.GroupNorm(2, 4, device="cpu")),
             (JN.InstanceNorm2D(4), TN.InstanceNorm2D(4, device="cpu")),
             (JN.LocalResponseNorm(3), TN.LocalResponseNorm(3))]
    for jl, tl in cases:
        assert list(tl.state_dict()) == list(jl.state_dict())
        for k, v in jl.state_dict().items():
            assert torch.equal(tl.state_dict()[k], _t(v.numpy()))
        # non-trivial affine parameters
        _carry(jl, tl)
        for p in tl.parameters():
            with torch.no_grad():
                p.add_(_t(_rand(rng, *p.shape, scale=0.3)))
        layer_state_from_jax({k: v.numpy() for k, v in
                              tl.state_dict().items()}, tl)
        jl.set_state_dict({k: v.numpy() for k, v in tl.state_dict().items()})
        _both(jl, tl, [x], rng)
    x1 = _rand(rng, 2, 4, 7)
    _both(JN.InstanceNorm1D(4), TN.InstanceNorm1D(4, device="cpu"), [x1],
          rng)


def test_unported_norms_raise():
    with pytest.raises(NotImplementedError, match="SyncBatchNorm"):
        TN.SyncBatchNorm(4, device="cpu")
    with pytest.raises(NotImplementedError, match="SyncBatchNorm"):
        TN.SyncBatchNorm.convert_sync_batchnorm(TN.Linear(2, 2,
                                                          device="cpu"))
    with pytest.raises(NotImplementedError, match="SpectralNorm"):
        TN.SpectralNorm((4, 4))


# ---------------------------------------------------------- initializers

@pytest.mark.parametrize("shape", [(5,), (3, 7), (6, 4, 3, 3), (2, 3, 5)])
def test_fans_and_gains_match_reference(shape):
    assert TI._fans(shape) == JI._fans(shape)
    for nl in ("sigmoid", "linear", "conv2d", "tanh", "relu", "leaky_relu",
               "selu"):
        assert TI.calculate_gain(nl) == JI.calculate_gain(nl)
    assert TI.calculate_gain("leaky_relu", 0.3) == JI.calculate_gain(
        "leaky_relu", 0.3)
    with pytest.raises(ValueError):
        TI.calculate_gain("nope")


def test_deterministic_initializers_equal_reference():
    val = np.arange(12, dtype=np.float32).reshape(3, 4)
    cases = [(JI.Constant(0.7), TI.Constant(0.7), (3, 4)),
             (JI.Assign(val), TI.Assign(val), (4, 3)),
             (JI.Assign(val.tolist()), TI.Assign(val.tolist()), (12,)),
             (JI.Dirac(), TI.Dirac(), (4, 4, 3, 3)),
             (JI.Dirac(groups=2), TI.Dirac(groups=2), (6, 3, 3, 3, 3))]
    for j, t, shape in cases:
        want = np.asarray(j(shape, "float32"))
        got = t(shape, torch.float32, device="cpu")
        assert got.shape == want.shape and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(6, 4), (4, 6), (3, 2, 5)])
def test_orthogonal_is_orthogonal(shape):
    g = torch.Generator().manual_seed(0)
    w = TI.Orthogonal(gain=1.5)(shape, device="cpu", generator=g)
    assert w.shape == shape
    m = w.reshape(-1, shape[-1]).double()
    gram = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
    assert torch.allclose(gram, 2.25 * torch.eye(gram.shape[0],
                                                 dtype=torch.float64),
                          atol=1e-5)
    ref = np.asarray(JI.Orthogonal(gain=1.5)(shape, "float32"),
                     np.float64).reshape(-1, shape[-1])
    ref_gram = ref.T @ ref if ref.shape[0] >= ref.shape[1] else ref @ ref.T
    assert np.allclose(ref_gram, gram.numpy(), atol=1e-5)


def _moments_ok(x, mean, std, n_sigma=SIGMAS):
    x = x.double().reshape(-1)
    n = x.numel()
    m_err = abs(x.mean().item() - mean) / (std / math.sqrt(n))
    s_err = abs(x.std().item() - std) / (std / math.sqrt(2 * n))
    return m_err <= n_sigma and s_err <= n_sigma, (m_err, s_err)


RANDOM_INITS = {
    "normal": (TI.Normal(0.5, 2.0), JI.Normal(0.5, 2.0), 0.5, 2.0, None),
    "uniform": (TI.Uniform(-0.5, 1.5), JI.Uniform(-0.5, 1.5), 0.5,
                2.0 / math.sqrt(12), (-0.5, 1.5)),
    "xavier_normal": (TI.XavierNormal(), JI.XavierNormal(), 0.0,
                      math.sqrt(2.0 / (400 + 500)), None),
    "xavier_uniform": (TI.XavierUniform(), JI.XavierUniform(), 0.0,
                       math.sqrt(6.0 / 900) / math.sqrt(3),
                       (-math.sqrt(6.0 / 900), math.sqrt(6.0 / 900))),
    "kaiming_normal": (TI.KaimingNormal(), JI.KaimingNormal(), 0.0,
                       math.sqrt(2.0) / math.sqrt(400), None),
    "kaiming_uniform": (TI.KaimingUniform(), JI.KaimingUniform(), 0.0,
                        math.sqrt(2.0) * math.sqrt(3.0 / 400)
                        / math.sqrt(3),
                        (-math.sqrt(2.0) * math.sqrt(3.0 / 400),
                         math.sqrt(2.0) * math.sqrt(3.0 / 400))),
}


@pytest.mark.parametrize("kind", sorted(RANDOM_INITS))
def test_random_initializers_hold_their_distribution(kind):
    """A [400, 500] draw: mean and std within SIGMAS standard errors of
    the distribution the reference's fan rule sets (the reference's own
    draw held to the same), inside its bounds; the same generator seed
    draws the same tensor."""
    t_init, j_init, mean, std, bounds = RANDOM_INITS[kind]
    shape = (400, 500)
    got = t_init(shape, device="cpu",
                 generator=torch.Generator().manual_seed(3))
    ref = torch.from_numpy(np.asarray(j_init(shape, "float32")))
    for x in (got, ref):
        ok, errs = _moments_ok(x, mean, std)
        assert ok, (kind, errs)
        if bounds is not None:
            assert bounds[0] <= x.min().item() and x.max().item() <= bounds[1]
    again = t_init(shape, device="cpu",
                   generator=torch.Generator().manual_seed(3))
    assert torch.equal(got, again)


def test_truncated_normal_holds_its_bounds_and_moments():
    """Cutoffs a, b absolute: a standard normal truncated to [-2, 2] has
    variance 1 - 2 * 2 phi(2) / (Phi(2) - Phi(-2))."""
    phi = math.exp(-2.0) / math.sqrt(2 * math.pi)
    big_phi = math.erf(2.0 / math.sqrt(2.0))
    std = math.sqrt(1 - 4 * phi / big_phi)
    got = TI.TruncatedNormal(1.0, 0.5, a=0.0, b=2.0)(
        (400, 500), device="cpu", generator=torch.Generator().manual_seed(4))
    assert 0.0 <= got.min().item() and got.max().item() <= 2.0
    ok, errs = _moments_ok(got, 1.0, 0.5 * std)
    assert ok, errs
    ref = np.asarray(JI.TruncatedNormal(1.0, 0.5, a=0.0, b=2.0)(
        (400, 500), "float32"))
    assert 0.0 <= ref.min() and ref.max() <= 2.0
    assert _moments_ok(torch.from_numpy(ref), 1.0, 0.5 * std)[0]


def test_linear_init_draws_as_before():
    """Linear's weight is XavierUniform from the layer's generator, the
    bias zeros: the draw the port's models (BERT, ERNIE) made before
    Linear moved onto Layer."""
    g = torch.Generator().manual_seed(11)
    lin = TN.Linear(7, 5, device="cpu", generator=g)
    bound = math.sqrt(6.0 / 12)
    want = torch.empty(7, 5).uniform_(
        -bound, bound, generator=torch.Generator().manual_seed(11))
    assert torch.equal(lin.weight.detach(), want)
    assert torch.equal(lin.bias.detach(), torch.zeros(5))


# ----------------------------------------------------- Layer and ParamAttr

def test_param_attr_reaches_the_parameter():
    reg = object()
    attr = TN.ParamAttr(name="w_attr", initializer=TI.Constant(0.3),
                        learning_rate=0.5, regularizer=reg, trainable=False,
                        need_clip=False)
    layer = TN.Linear(3, 2, weight_attr=attr, bias_attr=False, device="cpu")
    jlayer = JN.Linear(3, 2, weight_attr=JN.ParamAttr(
        name="w_attr", initializer=JI.Constant(0.3), learning_rate=0.5,
        trainable=False, need_clip=False), bias_attr=False)
    w = layer.weight
    assert layer.bias is None and jlayer.bias is None
    assert w.name == jlayer.weight.name == "w_attr"
    assert torch.equal(w.detach(), torch.full((3, 2), 0.3))
    assert not w.requires_grad and w.trainable is False
    assert w.optimize_attr == jlayer.weight.optimize_attr == {
        "learning_rate": 0.5}
    assert w.regularizer is reg and w.need_clip is False
    for a, kind in (("w", "name"), (TI.Normal(), "init"), (None, "plain"),
                    (False, "none")):
        got = TN.ParamAttr._to_attr(a)
        if kind == "none":
            assert got is False
        else:
            assert isinstance(got, TN.ParamAttr)
            assert (got.name == "w") == (kind == "name")
            assert got.initializer is (a if kind == "init" else None)
    import copy
    c = copy.deepcopy(w)
    assert c.name == "w_attr" and c.optimize_attr == w.optimize_attr


def test_adamw_decay_by_parameter_name():
    """apply_decay_param_fun reads the names ParamAttr gives: the named
    bias is not decayed, as in the reference, and one step of both
    optimizers lands on the same weights."""
    rng = np.random.default_rng(12)
    x, y = _rand(rng, 4, 3), _rand(rng, 4, 2)
    jl = JN.Linear(3, 2, weight_attr=JN.ParamAttr(name="fc.w"),
                   bias_attr=JN.ParamAttr(name="fc.b",
                                          initializer=JI.Constant(0.5)))
    tl = TN.Linear(3, 2, weight_attr=TN.ParamAttr(name="fc.w"),
                   bias_attr=TN.ParamAttr(name="fc.b",
                                          initializer=TI.Constant(0.5)),
                   device="cpu")
    _carry(jl, tl)

    def keep(name):
        return name != "fc.b"

    jo = jopt.AdamW(0.1, parameters=jl.parameters(), weight_decay=0.5,
                    apply_decay_param_fun=keep)
    to = topt.AdamW(0.1, parameters=tl.parameters(), weight_decay=0.5,
                    apply_decay_param_fun=keep)
    ((jl(_j(x)) - _j(y)) ** 2).mean().backward()
    jo.step()
    ((tl(_t(x)) - _t(y)) ** 2).mean().backward()
    to.step()
    for k, v in jl.state_dict().items():
        assert _max_rel(tl.state_dict()[k], v.numpy()) <= RTOL


def test_clip_skips_need_clip_false():
    a = TN.Linear(2, 2, weight_attr=TN.ParamAttr(need_clip=False),
                  device="cpu")
    for p in a.parameters():
        p.grad = torch.full_like(p, 10.0)
    TN.ClipGradByGlobalNorm(1.0)(a.parameters())
    assert torch.equal(a.weight.grad, torch.full((2, 2), 10.0))
    assert torch.allclose(a.bias.grad.norm(), torch.tensor(1.0))


def _models():
    j = JN.Sequential(JN.Linear(3, 4), JN.ReLU(), JN.BatchNorm1D(4),
                      JN.LayerList([JN.Linear(4, 4), JN.LayerNorm(4)]))
    t = TN.Sequential(TN.Linear(3, 4, device="cpu"), TN.ReLU(),
                      TN.BatchNorm1D(4, device="cpu"),
                      TN.LayerList([TN.Linear(4, 4, device="cpu"),
                                    TN.LayerNorm(4, device="cpu")]))
    return j, t


def test_containers_and_layer_state_keys_match_reference():
    j, t = _models()
    assert list(t.state_dict()) == list(j.state_dict())
    assert [n for n, _ in t.named_sublayers()] == [
        n for n, _ in j.named_sublayers()]
    assert len(t.sublayers(include_self=True)) == len(
        j.sublayers(include_self=True))
    assert t.full_name() == j.full_name() == "sequential"
    assert list(t.state_dict(structured_name_prefix="m")) == list(
        j.state_dict(structured_name_prefix="m"))
    assert list(t[2].state_dict(include_sublayers=False)) == [
        "weight", "bias", "_mean", "_variance"]
    od = OrderedDict([("a", JN.Linear(2, 2)), ("b", JN.Tanh())])
    odt = OrderedDict([("a", TN.Linear(2, 2, device="cpu")),
                       ("b", TN.Tanh())])
    assert list(TN.Sequential(odt).state_dict()) == list(
        JN.Sequential(od).state_dict())
    jd = JN.LayerDict({"x": JN.Linear(2, 3), "y": JN.Linear(3, 1)})
    td = TN.LayerDict({"x": TN.Linear(2, 3, device="cpu"),
                       "y": TN.Linear(3, 1, device="cpu")})
    assert list(td.state_dict()) == list(jd.state_dict())
    jp = JN.ParameterList([JN.Linear(2, 2).weight, JN.Linear(2, 2).bias])
    tp = TN.ParameterList([TN.Linear(2, 2, device="cpu").weight,
                           TN.Linear(2, 2, device="cpu").bias])
    assert list(tp.state_dict()) == list(jp.state_dict()) == ["0", "1"]
    _carry(j, t)
    x = _rand(np.random.default_rng(13), 5, 3)
    j.eval()
    t.eval()
    # the LayerList holds layers and has no forward of its own: run the
    # first three
    assert _max_rel(t[:3](_t(x)), j[:3](_j(x)).numpy()) <= RTOL
    assert _max_rel(t[3][1](t[3][0](_t(x @ np.ones((3, 4), np.float32)))),
                    j[3][1](j[3][0](_j(x @ np.ones((3, 4), np.float32))))
                    .numpy()) <= RTOL


def test_container_operations():
    lst = TN.LayerList([TN.ReLU(), TN.Tanh()])
    lst.append(TN.Sigmoid())
    lst.insert(0, TN.Identity())
    lst.extend([TN.GELU()])
    assert [type(m).__name__ for m in lst] == [
        "Identity", "ReLU", "Tanh", "Sigmoid", "GELU"]
    assert len(lst) == 5 and isinstance(lst[1:3], TN.LayerList)
    lst[0] = TN.Silu()
    assert type(lst[0]).__name__ == "Silu"
    seq = TN.Sequential(TN.Linear(2, 3, device="cpu"), TN.ReLU())
    assert isinstance(seq[0:1], TN.Sequential) and len(seq) == 2
    assert seq["1"] is seq[1] is seq[-1]
    d = TN.LayerDict()
    d["a"] = TN.ReLU()
    d.update([("b", TN.Tanh())])
    assert "a" in d and list(d.keys()) == ["a", "b"] and len(d) == 2
    assert isinstance(d.pop("a"), TN.ReLU) and list(d) == ["b"]
    del d["b"]
    assert len(d) == 0
    pl = TN.ParameterList()
    pl.append(torch.nn.Parameter(torch.ones(2)))
    assert len(pl) == 1 and torch.equal(pl[0].detach(), torch.ones(2))


def test_set_state_dict_and_hooks_match_reference():
    j, t = _models()
    part = {k: v.numpy() for k, v in j.state_dict().items()
            if not k.startswith("3.")}
    part["extra.w"] = np.zeros(2, np.float32)
    assert t.set_state_dict(part) == j.set_state_dict(part)
    for k, v in part.items():
        if k != "extra.w":
            assert np.array_equal(t.state_dict()[k].numpy(), v)
    rng = np.random.default_rng(14)
    x = _rand(rng, 2, 3)
    jl, tl = JN.Linear(3, 2), TN.Linear(3, 2, device="cpu")
    _carry(jl, tl)
    seen = []
    for layer in (jl, tl):
        pre = layer.register_forward_pre_hook(
            lambda m, inp: (inp[0] * 2.0,))
        post = layer.register_forward_post_hook(
            lambda m, inp, out: seen.append(type(out).__module__) or out + 1)
        xin = _j(x) if layer is jl else _t(x)
        got = layer(xin)
        pre.remove()
        post.remove()
        plain = layer(xin)
        if layer is jl:
            want, want_plain = got.numpy(), plain.numpy()
    assert _max_rel(got, want) <= RTOL and _max_rel(plain, want_plain) <= RTOL
    assert len(seen) == 2
    tl.astype("float64")
    assert tl.weight.dtype == torch.float64
    assert isinstance(tl.weight, TN.layer.layers.Parameter)
    assert tl.full_name() == jl.full_name() == "linear"


# -------------------------------------------- common functionals, layers

def test_common_functionals_match_reference():
    rng = np.random.default_rng(15)
    x, w, b = _rand(rng, 2, 5, 3), _rand(rng, 3, 4), _rand(rng, 4)
    _both(JF.linear, TF.linear, [x, w, b], rng)
    _both(lambda a, c: JF.linear(a, c), lambda a, c: TF.linear(a, c),
          [x, w], rng)
    ids = np.array([[0, 3, 2], [3, 3, 1]])
    table = _rand(rng, 5, 4)
    for pad in (None, 3):
        jt, tt = _j(table, True), _t(table, True)
        yj = JF.embedding(paddle.to_tensor(ids), jt, padding_idx=pad)
        yt = TF.embedding(torch.from_numpy(ids), tt, padding_idx=pad)
        assert _max_rel(yt, yj.numpy()) <= RTOL
        g = _rand(rng, *yt.shape)
        (yj * _j(g)).sum().backward()
        (yt * _t(g)).sum().backward()
        assert _max_rel(tt.grad, jt.grad.numpy()) <= RTOL
    assert np.array_equal(
        TF.one_hot(torch.from_numpy(ids), 5).numpy(),
        JF.one_hot(paddle.to_tensor(ids), 5).numpy())
    lab = np.abs(_rand(rng, 3, 5))
    prior = np.abs(_rand(rng, 5))
    _both(lambda a: JF.label_smooth(a, epsilon=0.2),
          lambda a: TF.label_smooth(a, epsilon=0.2), [lab], rng)
    _both(lambda a, p: JF.label_smooth(a, p, epsilon=0.2),
          lambda a, p: TF.label_smooth(a, p, epsilon=0.2), [lab, prior], rng)
    y1, y2 = _rand(rng, 4, 6, 3), _rand(rng, 4, 6, 3)
    _both(lambda a, c: JF.cosine_similarity(a, c, axis=1),
          lambda a, c: TF.cosine_similarity(a, c, axis=1), [y1, y2], rng)
    bw, bb = _rand(rng, 3, 4, 5), _rand(rng, 1, 3)
    _both(JF.bilinear, TF.bilinear, [_rand(rng, 2, 4), _rand(rng, 2, 5), bw,
                                     bb], rng)
    _both(lambda a: JF.unflatten(a, 1, [2, -1]),
          lambda a: TF.unflatten(a, 1, [2, -1]), [_rand(rng, 3, 6, 2)], rng)
    for p, keep in ((2.0, False), (1.0, True), (3.0, False)):
        _both(lambda a, c: JF.pairwise_distance(a, c, p, keepdim=keep),
              lambda a, c: TF.pairwise_distance(a, c, p, keepdim=keep),
              [y1, y2], rng)


def test_common_layers_match_reference():
    rng = np.random.default_rng(16)
    je = JN.Embedding(10, 4, padding_idx=-1)
    te = TN.Embedding(10, 4, padding_idx=-1, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    assert te.padding_idx == je.padding_idx == 9
    assert torch.equal(te.weight[9].detach(), torch.zeros(4))
    assert list(te.state_dict()) == list(je.state_dict())
    _carry(je, te)
    ids = np.array([[1, 9, 4]])
    assert _max_rel(te(torch.from_numpy(ids)),
                    je(paddle.to_tensor(ids)).numpy()) <= RTOL
    jb, tb = JN.Bilinear(3, 4, 2), TN.Bilinear(3, 4, 2, device="cpu")
    assert list(tb.state_dict()) == list(jb.state_dict())
    assert tb.weight.shape == tuple(jb.weight.shape)
    _carry(jb, tb)
    _both(jb, tb, [_rand(rng, 5, 3), _rand(rng, 5, 4)], rng)
    _both(JN.CosineSimilarity(axis=-1), TN.CosineSimilarity(axis=-1),
          [_rand(rng, 3, 4), _rand(rng, 3, 4)], rng)
    _both(JN.Flatten(1, 2), TN.Flatten(1, 2), [_rand(rng, 2, 3, 4, 5)], rng)
    x = _t(_rand(rng, 2, 3))
    assert TN.Identity(7, k=1)(x) is x


def test_o2_keeps_norm_layers_f32_as_the_reference():
    """amp.decorate(level="O2") casts a Linear to bf16 and leaves the
    port's BatchNorm and LayerNorm f32, as the reference skips its
    _BatchNormBase and LayerNorm."""
    from paddle_tpu import amp as jamp
    from paddle_tpu_torch import amp as tamp
    t = TN.Sequential(TN.Linear(4, 4, device="cpu"),
                      TN.BatchNorm1D(4, device="cpu"),
                      TN.LayerNorm(4, device="cpu"))
    j = JN.Sequential(JN.Linear(4, 4), JN.BatchNorm1D(4), JN.LayerNorm(4))
    tamp.decorate(t, level="O2", dtype="bfloat16")
    jamp.decorate(j, level="O2", dtype="bfloat16")
    assert [str(p.dtype).split(".")[-1] for p in t.parameters()] == [
        str(p.dtype) for p in j.parameters()] == [
        "bfloat16", "bfloat16"] + ["float32"] * 4
