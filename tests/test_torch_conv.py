"""The port's convolutions (nn.functional.conv, nn.layer.conv) against
the JAX package's, in fp32 on the CPU, from the same seeded numpy inputs
and weights: the output and the grads of the input, the weight and the
bias under one random cotangent.

Every padding form of the reference's resolver ("SAME" at odd and even
kernels and strides, "VALID", an int, n values, 2n values, nested pairs
with and without the N and C pairs), strides, dilations, groups and
channels-last formats, and every transpose case: symmetric pads on
torch's transpose, asymmetric pads, "SAME" and output_padding at or
above the stride through the cropped route.

Limit RTOL 1e-5 as max|port - reference| / max|reference|: the same
sums of f32 products in another order (XLA's convolution against
PyTorch's).
"""
import numpy as np
import pytest
import torch

import paddle_tpu.nn as JN
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch import nn as TN
from paddle_tpu_torch.nn import functional as TF

from _torch_parity import both, carry, j_, max_rel, rand, t_
from _torch_threads import one_torch_thread  # noqa: F401,E402

RTOL = 1e-5

# (n, data_format, x shape, weight shape, kwargs)
CONV_CASES = {
    "2d_p0": (2, "NCHW", (2, 4, 9, 8), (6, 4, 3, 3), {}),
    "2d_p1_s2": (2, "NCHW", (2, 4, 9, 8), (6, 4, 3, 3),
                 dict(padding=1, stride=2)),
    "2d_same_odd": (2, "NCHW", (2, 4, 9, 8), (6, 4, 3, 3),
                    dict(padding="SAME")),
    "2d_same_even_k": (2, "NCHW", (2, 4, 9, 8), (6, 4, 4, 2),
                       dict(padding="SAME")),
    "2d_same_stride": (2, "NCHW", (2, 4, 9, 8), (6, 4, 3, 3),
                       dict(padding="same", stride=2)),
    "2d_same_dilation": (2, "NCHW", (2, 4, 9, 8), (6, 4, 3, 2),
                         dict(padding="SAME", dilation=2)),
    "2d_valid": (2, "NCHW", (2, 4, 9, 8), (6, 4, 3, 3),
                 dict(padding="VALID", stride=(2, 1))),
    "2d_n_values": (2, "NCHW", (2, 4, 9, 8), (6, 4, 3, 3),
                    dict(padding=[1, 2])),
    "2d_2n_values": (2, "NCHW", (2, 4, 9, 8), (6, 4, 3, 3),
                     dict(padding=[1, 0, 2, 1])),
    "2d_nested": (2, "NCHW", (2, 4, 9, 8), (6, 4, 3, 3),
                  dict(padding=[(0, 1), (2, 0)], stride=2)),
    "2d_dilation": (2, "NCHW", (2, 4, 9, 8), (6, 4, 3, 3),
                    dict(padding=2, dilation=2)),
    "2d_groups": (2, "NCHW", (2, 4, 9, 8), (6, 2, 3, 3),
                  dict(padding=1, groups=2)),
    "2d_depthwise": (2, "NCHW", (2, 4, 9, 8), (8, 1, 3, 3),
                     dict(padding=1, groups=4, stride=2)),
    "2d_nhwc": (2, "NHWC", (2, 9, 8, 4), (6, 4, 3, 3),
                dict(padding=1, stride=2)),
    "2d_nhwc_same": (2, "NHWC", (2, 9, 8, 4), (6, 2, 2, 2),
                     dict(padding="SAME", groups=2)),
    "1d_ncl": (1, "NCL", (2, 4, 11), (6, 4, 3), dict(padding=1)),
    "1d_nlc": (1, "NLC", (2, 11, 4), (6, 4, 4), dict(padding="SAME",
                                                     stride=2)),
    "1d_nested_nc": (1, "NCL", (2, 4, 11), (6, 4, 3),
                     dict(padding=[(0, 0), (0, 0), (2, 1)])),
    "1d_2n_dilation": (1, "NCL", (2, 4, 11), (6, 2, 3),
                       dict(padding=[0, 3], dilation=3, groups=2)),
    "3d_ncdhw": (3, "NCDHW", (1, 3, 5, 6, 5), (4, 3, 3, 3, 3),
                 dict(padding=1, stride=(1, 2, 1))),
    "3d_ndhwc_same": (3, "NDHWC", (1, 5, 6, 5, 3), (4, 3, 2, 3, 2),
                      dict(padding="SAME")),
    "3d_nested_nc": (3, "NCDHW", (1, 3, 5, 6, 5), (4, 3, 3, 3, 3),
                     dict(padding=[(0, 0), (0, 0), (1, 0), (0, 1),
                                   (1, 1)])),
}


# the cases that run without a bias (every other case has one)
NO_BIAS = ("2d_valid", "2d_nested", "1d_nested_nc", "3d_ndhwc_same",
           "2d_plain", "2d_asym", "3d_ncdhw")


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_matches_reference(case):
    n, fmt, xs, ws, kw = CONV_CASES[case]
    bias = case not in NO_BIAS
    rng = np.random.default_rng(len(case))
    fn = f"conv{n}d"
    inputs = [rand(rng, *xs), rand(rng, *ws, scale=0.3)]
    if bias:
        inputs.append(rand(rng, ws[0]))

    def call(F):
        return lambda x, w, b=None: getattr(F, fn)(
            x, w, b, data_format=fmt, **kw)

    both(call(JF), call(TF), inputs, rng, RTOL)


# (n, data_format, x shape, weight shape [in, out / groups, *k], kwargs)
TRANSPOSE_CASES = {
    "2d_plain": (2, "NCHW", (2, 4, 5, 6), (4, 3, 3, 3), {}),
    "2d_s2_p1": (2, "NCHW", (2, 4, 5, 6), (4, 3, 3, 3),
                 dict(stride=2, padding=1)),
    "2d_s2_p1_op1": (2, "NCHW", (2, 4, 5, 6), (4, 3, 3, 3),
                     dict(stride=2, padding=1, output_padding=1)),
    "2d_op_at_stride": (2, "NCHW", (2, 4, 5, 6), (4, 3, 3, 3),
                        dict(stride=2, padding=1, output_padding=2)),
    "2d_asym": (2, "NCHW", (2, 4, 5, 6), (4, 3, 3, 3),
                dict(stride=2, padding=[1, 0, 0, 2])),
    "2d_same": (2, "NCHW", (2, 4, 5, 6), (4, 3, 4, 4),
                dict(stride=2, padding="SAME")),
    "2d_valid": (2, "NCHW", (2, 4, 5, 6), (4, 3, 3, 2),
                 dict(padding="VALID", stride=(1, 2))),
    "2d_dilation": (2, "NCHW", (2, 4, 5, 6), (4, 3, 3, 3),
                    dict(dilation=2, padding=1, stride=2)),
    "2d_groups": (2, "NCHW", (2, 4, 5, 6), (4, 2, 3, 3),
                  dict(groups=2, stride=2, padding=1, output_padding=1)),
    "2d_nhwc": (2, "NHWC", (2, 5, 6, 4), (4, 3, 3, 3),
                dict(stride=2, padding=1)),
    "2d_big_pad": (2, "NCHW", (2, 4, 5, 6), (4, 3, 3, 3),
                   dict(padding=3)),
    "1d_ncl": (1, "NCL", (2, 4, 7), (4, 3, 3), dict(stride=3, padding=1)),
    "1d_nlc_op": (1, "NLC", (2, 7, 4), (4, 3, 4),
                  dict(stride=2, padding=1, output_padding=1)),
    "3d_ncdhw": (3, "NCDHW", (1, 3, 3, 4, 3), (3, 2, 3, 3, 3),
                 dict(stride=(2, 1, 2), padding=1)),
    "3d_ndhwc_groups": (3, "NDHWC", (1, 3, 4, 3, 4), (4, 1, 2, 2, 2),
                        dict(stride=2, groups=2)),
}


@pytest.mark.parametrize("case", sorted(TRANSPOSE_CASES))
def test_conv_transpose_matches_reference(case):
    n, fmt, xs, ws, kw = TRANSPOSE_CASES[case]
    bias = case not in NO_BIAS
    rng = np.random.default_rng(7 + len(case))
    fn = f"conv{n}d_transpose"
    inputs = [rand(rng, *xs), rand(rng, *ws, scale=0.3)]
    if bias:
        groups = kw.get("groups", 1)
        inputs.append(rand(rng, ws[1] * groups))

    def call(F):
        return lambda x, w, b=None: getattr(F, fn)(
            x, w, b, data_format=fmt, **kw)

    both(call(JF), call(TF), inputs, rng, RTOL)


LAYERS = {
    "Conv1D": ((4, 6, 3), dict(padding=1), (2, 4, 10)),
    "Conv2D": ((4, 6, 3), dict(stride=2, padding="SAME", groups=2),
               (2, 4, 9, 8)),
    "Conv3D": ((3, 4, (2, 3, 2)), dict(padding=1), (1, 3, 4, 5, 4)),
    "Conv1DTranspose": ((4, 6, 3), dict(stride=2, padding=1), (2, 4, 7)),
    "Conv2DTranspose": ((4, 6, 3), dict(stride=2, output_padding=1,
                                        groups=2), (2, 4, 5, 6)),
    "Conv3DTranspose": ((3, 4, 2), dict(stride=2), (1, 3, 3, 4, 3)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_conv_layer_matches_reference(name):
    """The layer's weight and bias shapes and keys are the reference's
    (carried by layer_state_from_jax); its output and its parameters'
    grads match."""
    args, kw, xs = LAYERS[name]
    rng = np.random.default_rng(3)
    jl = getattr(JN, name)(*args, **kw)
    tl = getattr(TN, name)(*args, **kw, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    assert [(k, tuple(v.shape)) for k, v in tl.state_dict().items()] == \
        [(k, tuple(v.shape)) for k, v in jl.state_dict().items()]
    carry(jl, tl)
    x = rand(rng, *xs)
    yj, yt = jl(j_(x)), tl(t_(x))
    assert max_rel(yt, yj.numpy()) <= RTOL
    g = rand(rng, *yt.shape)
    (yj * j_(g)).sum().backward()
    (yt * t_(g)).sum().backward()
    for (kt, pt), (kj, pj) in zip(tl.named_parameters(),
                                  jl.named_parameters()):
        assert kt == kj
        assert max_rel(pt.grad, pj.grad.numpy()) <= RTOL


@pytest.mark.parametrize("name", ["Conv2D", "Conv2DTranspose"])
def test_conv_layer_init_bounds(name):
    """Weight and bias are Uniform(±1/sqrt(fan_in)) on the layer's
    generator: within the bound, spread over it, and the same seed gives
    the same draw."""
    def build(seed):
        return getattr(TN, name)(8, 6, 3, groups=2, device="cpu",
                                 generator=torch.Generator().manual_seed(
                                     seed))
    layer = build(0)
    fan_in = (8 // 2) * 9
    bound = 1.0 / np.sqrt(fan_in)
    for p in (layer.weight, layer.bias):
        a = p.detach().numpy()
        assert np.abs(a).max() <= bound
        assert np.abs(a).max() > 0.5 * bound
    assert torch.equal(build(0).weight, layer.weight)
    assert not torch.equal(build(1).weight, layer.weight)


def test_padding_mode_is_stored_not_applied():
    """Queue 3 "Noted": `padding_mode` is kept on the layer and its
    forward pads with zeros whatever it says, as the reference's
    (paddle_tpu/nn/layer/conv.py:62-66)."""
    rng = np.random.default_rng(4)
    x = rand(rng, 1, 2, 6, 6)
    out = {}
    for mode in ("zeros", "reflect", "circular"):
        jl = JN.Conv2D(2, 3, 3, padding=1, padding_mode=mode)
        layer = TN.Conv2D(2, 3, 3, padding=1, padding_mode=mode,
                          device="cpu")
        assert layer.padding_mode == jl.padding_mode == mode
        if out:
            jl.set_state_dict(first.state_dict())
        else:
            first = jl
        carry(jl, layer)
        out[mode] = layer(t_(x))
        assert max_rel(out[mode], jl(j_(x)).numpy()) <= RTOL
    assert torch.equal(out["zeros"], out["reflect"])
    assert torch.equal(out["zeros"], out["circular"])


def test_output_size_is_ignored():
    """Queue 3 "Noted": `output_size` is accepted and ignored by the
    transposes, as the reference's `pass` (conv.py:169-171): the output
    keeps the size its stride, padding and output_padding give."""
    rng = np.random.default_rng(5)
    x, w = rand(rng, 1, 2, 4, 4), rand(rng, 2, 3, 3, 3)
    base = TF.conv2d_transpose(t_(x), t_(w), stride=2, padding=1)
    got = TF.conv2d_transpose(t_(x), t_(w), stride=2, padding=1,
                              output_size=[8, 8])
    ref = JF.conv2d_transpose(j_(x), j_(w), stride=2, padding=1,
                              output_size=[8, 8])
    assert tuple(got.shape) == tuple(ref.shape) == (1, 3, 7, 7)
    assert torch.equal(got, base)
    layer = TN.Conv2DTranspose(2, 3, 3, stride=2, padding=1, device="cpu")
    assert tuple(layer(t_(x), output_size=[8, 8]).shape) == (1, 3, 7, 7)


def test_bf16_conv_rounds_once():
    """A bf16 conv2d equals the f32 conv of the same bf16 values rounded
    to bf16 once, as the reference's f32 accumulation
    (preferred_element_type) is, within one bf16 ulp."""
    rng = np.random.default_rng(6)
    x = t_(rand(rng, 2, 8, 7, 7)).bfloat16()
    w = t_(rand(rng, 6, 8, 3, 3, scale=0.2)).bfloat16()
    got = TF.conv2d(x, w, padding=1)
    assert got.dtype == torch.bfloat16
    want = TF.conv2d(x.float(), w.float(), padding=1)
    diff = (got.float() - want).abs()
    assert bool((diff <= 2.0 ** -7 * want.abs() + 1e-6).all())
    ref = JF.conv2d(j_(x.float().numpy()).astype("bfloat16"),
                    j_(w.float().numpy()).astype("bfloat16"), padding=1)
    assert max_rel(got.float(), np.asarray(ref.astype("float32").numpy())) \
        <= 2.0 ** -7
