"""The port's pooling (nn.functional.pooling, nn.layer.pooling) against
the JAX package's, in fp32 on the CPU, from the same seeded numpy
inputs: outputs, input grads under one random cotangent, and masks
exactly.

Covered: avg and max pooling in 1-3 d with and without `ceil_mode`
(the reference pads the high side; torch would drop a window starting
in the padding), with and without `exclusive`, every padding form,
pads above half the window, channels last; `return_mask` (symmetric int
padding alone, first maximum; it ignores `ceil_mode`); adaptive avg and
max over bins that do and do not divide, and the adaptive max's zero
mask; `lp_pool1d/2d`; `max_unpool1d/2d/3d`; `fractional_max_pool2d/3d`
at a given `random_u`; every layer of nn.layer.pooling.

Limit RTOL 1e-5 as max|port - reference| / max|reference| (f32 sums in
another order; max pooling and masks are exact).
"""
import numpy as np
import pytest
import torch

import paddle_tpu.nn as JN
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch import nn as TN
from paddle_tpu_torch.nn import functional as TF

from _torch_parity import both, j_, max_rel, rand, t_
from _torch_threads import one_torch_thread  # noqa: F401,E402

RTOL = 1e-5

SHAPES = {1: (2, 3, 11), 2: (2, 3, 9, 10), 3: (1, 2, 7, 6, 7)}

# (n, kwargs) for avg_pool{n}d and max_pool{n}d
POOL_CASES = {
    "k2": (2, dict(kernel_size=2)),
    "k3_s2": (2, dict(kernel_size=3, stride=2)),
    "k3_s2_p1": (2, dict(kernel_size=3, stride=2, padding=1)),
    "k3_s2_p1_ceil": (2, dict(kernel_size=3, stride=2, padding=1,
                              ceil_mode=True)),
    "k2_ceil": (2, dict(kernel_size=2, ceil_mode=True)),
    "k3_same": (2, dict(kernel_size=3, stride=2, padding="SAME")),
    "k2_valid": (2, dict(kernel_size=(2, 3), stride=(1, 2),
                         padding="VALID")),
    "k3_2n": (2, dict(kernel_size=3, stride=2, padding=[1, 0, 2, 1])),
    "k3_n_values": (2, dict(kernel_size=3, padding=[1, 0])),
    "k3_big_pad": (2, dict(kernel_size=3, padding=2, stride=2)),
    "nhwc": (2, dict(kernel_size=3, stride=2, padding=1,
                     data_format="NHWC")),
    "1d": (1, dict(kernel_size=3, stride=2, padding=1)),
    "1d_ceil": (1, dict(kernel_size=4, stride=3, ceil_mode=True)),
    "3d": (3, dict(kernel_size=3, stride=2, padding=1)),
    "3d_ceil": (3, dict(kernel_size=2, stride=(2, 1, 2), ceil_mode=True)),
}


def _shape(n, kw):
    s = SHAPES[n]
    if kw.get("data_format", "NCHW") == "NHWC":
        s = (s[0],) + s[2:] + (s[1],)
    return s


# `exclusive` only acts where some pad is non-zero: the unpadded cases
# run once
AVG_CASES = [(c, True) for c in sorted(POOL_CASES)] + [
    (c, False) for c in ("k3_s2_p1", "k3_s2_p1_ceil", "k2_ceil", "k3_same",
                         "k3_2n", "k3_big_pad", "1d_ceil", "3d")]


@pytest.mark.parametrize("case,exclusive", AVG_CASES, ids=[
    f"{c}-{'exclusive' if e else 'inclusive'}" for c, e in AVG_CASES])
def test_avg_pool_matches_reference(case, exclusive):
    n, kw = POOL_CASES[case]
    rng = np.random.default_rng(len(case))
    fn = f"avg_pool{n}d"
    both(lambda x: getattr(JF, fn)(x, exclusive=exclusive, **kw),
         lambda x: getattr(TF, fn)(x, exclusive=exclusive, **kw),
         [rand(rng, *_shape(n, kw))], rng, RTOL)


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_max_pool_matches_reference(case):
    n, kw = POOL_CASES[case]
    rng = np.random.default_rng(len(case) + 1)
    fn = f"max_pool{n}d"
    both(lambda x: getattr(JF, fn)(x, **kw),
         lambda x: getattr(TF, fn)(x, **kw),
         [rand(rng, *_shape(n, kw))], rng, RTOL)


@pytest.mark.parametrize("n,kw", [
    (1, dict(kernel_size=3, stride=2, padding=1)),
    (2, dict(kernel_size=2)),
    (2, dict(kernel_size=3, stride=2, padding=1)),
    (2, dict(kernel_size=3, stride=2, padding="SAME")),
    (2, dict(kernel_size=3, stride=2, padding=1, ceil_mode=True)),
    (3, dict(kernel_size=2, stride=2)),
    (3, dict(kernel_size=3, stride=2, padding=1))],
    ids=["1d", "2d_k2", "2d_p1", "2d_same", "2d_ceil", "3d_k2", "3d_p1"])
def test_max_pool_mask_matches_reference(n, kw):
    """The masks are equal; with ceil_mode the mask keeps the shape the
    pooling has without it, as in the reference."""
    rng = np.random.default_rng(11)
    x = rand(rng, *SHAPES[n])
    fn = f"max_pool{n}d"
    oj, mj = getattr(JF, fn)(j_(x), return_mask=True, **kw)
    ot, mt = getattr(TF, fn)(t_(x), return_mask=True, **kw)
    assert max_rel(ot, oj.numpy()) == 0.0
    assert mt.dtype == torch.int64
    assert np.array_equal(mt.numpy(), np.asarray(mj.numpy()))


ADAPTIVE = [(1, 5), (1, 4), (2, (3, 5)), (2, (2, 4)), (2, 1), (3, (2, 3, 4)),
            (3, 2)]
ADAPTIVE_IDS = ["1d_divides_no", "1d_divides", "2d_no", "2d_mixed", "2d_1",
                "3d_no", "3d_mixed"]


@pytest.mark.parametrize("kind", ["avg", "max"])
@pytest.mark.parametrize("n,out", ADAPTIVE, ids=ADAPTIVE_IDS)
def test_adaptive_pool_matches_reference(kind, n, out):
    rng = np.random.default_rng(n + 3)
    shape = {1: (2, 3, 12), 2: (2, 3, 9, 12), 3: (1, 2, 7, 6, 8)}[n]
    fn = f"adaptive_{kind}_pool{n}d"
    both(lambda x: getattr(JF, fn)(x, out), lambda x: getattr(TF, fn)(x, out),
         [rand(rng, *shape)], rng, RTOL)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_adaptive_max_mask_is_zeros(n):
    """Queue 3 "Noted": the adaptive max's `return_mask` is an int64
    zero tensor of the output's shape, as in the reference
    (pooling.py:208-211)."""
    rng = np.random.default_rng(9)
    x = rand(rng, *SHAPES[n])
    fn = f"adaptive_max_pool{n}d"
    oj, mj = getattr(JF, fn)(j_(x), 3, return_mask=True)
    ot, mt = getattr(TF, fn)(t_(x), 3, return_mask=True)
    assert max_rel(ot, oj.numpy()) == 0.0
    assert mt.dtype == torch.int64 and not bool(mt.any())
    assert np.array_equal(mt.numpy(), np.asarray(mj.numpy()))


@pytest.mark.parametrize("fn,p,kw", [
    ("lp_pool1d", 2, dict(kernel_size=3, stride=2)),
    ("lp_pool1d", 3, dict(kernel_size=2, ceil_mode=True)),
    ("lp_pool2d", 2, dict(kernel_size=2)),
    ("lp_pool2d", 3, dict(kernel_size=3, stride=2, padding=1,
                          ceil_mode=True))],
    ids=["1d_p2", "1d_p3_ceil", "2d_p2", "2d_p3_pad_ceil"])
def test_lp_pool_matches_reference(fn, p, kw):
    rng = np.random.default_rng(12)
    n = int(fn[-2])
    both(lambda x: getattr(JF, fn)(x, p, **kw),
         lambda x: getattr(TF, fn)(x, p, **kw),
         [rand(rng, *SHAPES[n])], rng, RTOL)


@pytest.mark.parametrize("n,kw,out_size", [
    (1, dict(kernel_size=2), None),
    (2, dict(kernel_size=2), None),
    (2, dict(kernel_size=3, stride=2, padding=1), None),
    (2, dict(kernel_size=2), (10, 11)),
    (3, dict(kernel_size=2), None)],
    ids=["1d", "2d", "2d_p1", "2d_output_size", "3d"])
def test_max_unpool_matches_reference(n, kw, out_size):
    """max_pool's mask scattered back: values and the values' grads."""
    rng = np.random.default_rng(13)
    x = rand(rng, *SHAPES[n])
    _, mask = getattr(TF, f"max_pool{n}d")(t_(x), return_mask=True, **kw)
    pooled = rand(rng, *mask.shape)
    fn = f"max_unpool{n}d"
    jmask = j_(mask.numpy()).astype("int64")
    both(lambda v: getattr(JF, fn)(v, jmask, output_size=out_size, **kw),
         lambda v: getattr(TF, fn)(v, mask, output_size=out_size, **kw),
         [pooled], rng, RTOL)


@pytest.mark.parametrize("n,out,u", [(2, (3, 4), 0.3), (2, 3, 0.75),
                                     (3, (2, 2, 3), 0.5)],
                         ids=["2d", "2d_int", "3d"])
def test_fractional_max_pool_matches_reference(n, out, u):
    rng = np.random.default_rng(14)
    x = rand(rng, *SHAPES[n])
    fn = f"fractional_max_pool{n}d"
    masks = []

    def call(F):
        def f(a):
            o, m = getattr(F, fn)(a, out, random_u=u, return_mask=True)
            masks.append(np.asarray(m.numpy()))
            return o
        return f

    both(call(JF), call(TF), [x], rng, RTOL)
    assert np.array_equal(masks[1], masks[0])


LAYERS = {
    "AvgPool1D": ((3,), dict(stride=2, padding=1), 1),
    "AvgPool2D": ((3,), dict(stride=2, padding=1, ceil_mode=True,
                             exclusive=False), 2),
    "AvgPool3D": ((2,), {}, 3),
    "MaxPool1D": ((2,), {}, 1),
    "MaxPool2D": ((3,), dict(stride=2, padding=1), 2),
    "MaxPool3D": ((3,), dict(stride=2, padding=1, ceil_mode=True), 3),
    "AdaptiveAvgPool1D": ((4,), {}, 1),
    "AdaptiveAvgPool2D": (((3, 4),), {}, 2),
    "AdaptiveAvgPool3D": ((2,), {}, 3),
    "AdaptiveMaxPool1D": ((4,), {}, 1),
    "AdaptiveMaxPool2D": ((3,), {}, 2),
    "AdaptiveMaxPool3D": ((3,), {}, 3),
    "LPPool1D": ((2, 3), dict(stride=2), 1),
    "LPPool2D": ((3, 2), {}, 2),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_pool_layer_matches_reference(name):
    args, kw, n = LAYERS[name]
    rng = np.random.default_rng(15)
    both(getattr(JN, name)(*args, **kw), getattr(TN, name)(*args, **kw),
         [rand(rng, *SHAPES[n])], rng, RTOL)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_unpool_layer_matches_reference(n):
    rng = np.random.default_rng(16)
    x = rand(rng, *SHAPES[n])
    jo, jm = getattr(JN, f"MaxPool{n}D")(2, return_mask=True)(j_(x))
    to, tm = getattr(TN, f"MaxPool{n}D")(2, return_mask=True)(t_(x))
    assert np.array_equal(tm.numpy(), np.asarray(jm.numpy()))
    ju = getattr(JN, f"MaxUnPool{n}D")(2)(jo, jm)
    tu = getattr(TN, f"MaxUnPool{n}D")(2)(to, tm)
    assert max_rel(tu, ju.numpy()) == 0.0
