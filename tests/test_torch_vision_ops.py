"""The port's image functionals and vision layers against the JAX
package's, in fp32 on the CPU, from the same seeded numpy inputs:
`interpolate` in every mode, upscale and downscale, both
`align_corners` and both `align_mode`, by size and by scale, channels
last; `pad` in every mode and form; `pixel_shuffle`,
`pixel_unshuffle`, `channel_shuffle`; `unfold` / `fold`;
`affine_grid` / `grid_sample` (every mode, padding mode and
`align_corners`, grads of the image and the grid); the vision layers of
nn.layer.common.

Limit RTOL 1e-5 as max|port - reference| / max|reference| (the
resampling matrices are built in f32 term for term as
jax.image.scale_and_translate builds them; sums in another order).
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

# (mode, input shape, data_format)
MODES = {"nearest": ((2, 3, 6, 7), None), "bilinear": ((2, 3, 6, 7), None),
         "bicubic": ((2, 3, 6, 7), None), "area": ((2, 3, 6, 7), None),
         "linear": ((2, 3, 9), None), "trilinear": ((1, 2, 4, 5, 6), None),
         "bilinear_nhwc": ((2, 6, 7, 3), "NHWC")}
# (size, scale_factor) per spatial rank
SIZES = {"up": {1: ((14,), None), 2: (None, 2), 3: ((7, 9, 10), None)},
         "down": {1: ((4,), None), 2: ((3, 4), None), 3: (None, 0.5)},
         "odd": {1: ((13,), None), 2: (None, 1.5), 3: ((3, 7, 4), None)}}
ALIGN = {"half_pixel": (False, 0), "corners": (True, 0),
         "asymmetric": (False, 1)}


# (mode, size, align): the linear family upscaling and downscaling at
# every alignment (align_mode=1 acts on it alone), and at a non-integer
# scale on the resize route; nearest ignores the alignment, and
# bicubic and area take the resize route except at align_corners
INTERP_CASES = (
    [(m, z, a) for m in ("bilinear", "linear") for z in ("up", "down")
     for a in sorted(ALIGN)]
    + [(m, "odd", "half_pixel") for m in ("bilinear", "linear")]
    + [("trilinear", "up", a) for a in sorted(ALIGN)]
    + [("trilinear", "down", "half_pixel")]
    + [("bilinear_nhwc", z, a) for z in ("up", "down")
       for a in ("half_pixel", "corners")]
    + [("nearest", z, "half_pixel") for z in sorted(SIZES)]
    + [("bicubic", z, "half_pixel") for z in sorted(SIZES)]
    + [("bicubic", "up", "corners"), ("area", "down", "half_pixel"),
       ("area", "up", "corners")])


@pytest.mark.parametrize("mode,size,align", INTERP_CASES,
                         ids=["-".join(c) for c in INTERP_CASES])
def test_interpolate_matches_reference(mode, size, align):
    shape, fmt = MODES[mode]
    rank = len(shape) - 2
    sz, sf = SIZES[size][rank]
    ac, am = ALIGN[align]
    m = mode.replace("_nhwc", "")
    rng = np.random.default_rng(len(mode) + len(size))
    kw = dict(size=list(sz) if sz else None, scale_factor=sf, mode=m,
              align_corners=ac, align_mode=am, data_format=fmt)
    both(lambda x: JF.interpolate(x, **kw), lambda x: TF.interpolate(x, **kw),
         [rand(rng, *shape)], rng, RTOL)


def test_interpolate_mode_map():
    """Queue 3 "Noted": the reference's modes are jax.image.resize's, so
    "area" is "bilinear" (not torch's area), "nearest" is torch's
    "nearest-exact" (not its "nearest") and "bicubic" is Keys a = -0.5
    (not torch's -0.75); downscaling antialiases (torch's bilinear with
    antialias=True)."""
    rng = np.random.default_rng(0)
    x = t_(rand(rng, 1, 2, 6, 7))
    tf = torch.nn.functional
    area = TF.interpolate(x, size=[4, 5], mode="area")
    assert torch.equal(area, TF.interpolate(x, size=[4, 5], mode="bilinear"))
    assert max_rel(area, tf.interpolate(x, size=[4, 5], mode="area")) > 1e-3
    near = TF.interpolate(x, size=[4, 5], mode="nearest")
    assert torch.equal(near, tf.interpolate(x, size=[4, 5],
                                            mode="nearest-exact"))
    assert not torch.equal(near, tf.interpolate(x, size=[4, 5],
                                                mode="nearest"))
    cubic = TF.interpolate(x, size=[12, 14], mode="bicubic")
    assert max_rel(cubic, tf.interpolate(x, size=[12, 14], mode="bicubic",
                                         align_corners=False)) > 1e-3
    down = TF.interpolate(x, size=[3, 3], mode="bilinear")
    assert max_rel(down, tf.interpolate(x, size=[3, 3], mode="bilinear",
                                        antialias=True)) <= RTOL
    assert max_rel(down, tf.interpolate(x, size=[3, 3],
                                        mode="bilinear")) > 1e-3
    ref = JF.interpolate(j_(x.detach().numpy()), size=[4, 5], mode="area")
    assert max_rel(area, ref.numpy()) <= RTOL


def test_upsample_is_interpolate():
    rng = np.random.default_rng(1)
    x = rand(rng, 1, 2, 5, 4)
    kw = dict(scale_factor=[2, 3], mode="bilinear", align_corners=True)
    both(lambda a: JF.upsample(a, **kw), lambda a: TF.upsample(a, **kw),
         [x], rng, RTOL)


# (input shape, pad, data_format)
PAD_FORMS = {
    "all_axes_4d": ((2, 3, 5, 6), [0, 1, 1, 0, 2, 1, 1, 3], "NCHW"),
    "last_pair": ((2, 3, 5, 6), [2, 1], "NCHW"),
    "two_pairs": ((2, 3, 5, 6), [1, 2, 3, 0], "NCHW"),
    "nhwc_two_pairs": ((2, 5, 6, 3), [1, 2, 3, 0], "NHWC"),
    "ncl": ((2, 3, 7), [2, 3], "NCL"),
    "nlc": ((2, 7, 3), [3, 1], "NLC"),
    "ncdhw_three_pairs": ((1, 2, 4, 5, 3), [1, 0, 2, 1, 0, 2], "NCDHW"),
    "ndhwc": ((1, 4, 5, 3, 2), [1, 2, 0, 1], "NDHWC"),
    "wide_reflect": ((1, 2, 3, 4), [5, 4, 2, 6], "NCHW"),
}
# every form in the four modes; the aliases ("edge" for "replicate",
# "wrap" for "circular") on two forms
PAD_CASES = ([(f, m) for f in sorted(PAD_FORMS)
              for m in ("constant", "reflect", "replicate", "circular")]
             + [(f, m) for f in ("two_pairs", "ndhwc")
                for m in ("edge", "wrap")])


@pytest.mark.parametrize("form,mode", PAD_CASES,
                         ids=["-".join(c) for c in PAD_CASES])
def test_pad_matches_reference(form, mode):
    shape, pad, fmt = PAD_FORMS[form]
    rng = np.random.default_rng(len(form) + len(mode))
    kw = dict(mode=mode, value=0.5, data_format=fmt)
    both(lambda x: JF.pad(x, pad, **kw), lambda x: TF.pad(x, pad, **kw),
         [rand(rng, *shape)], rng, RTOL)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("fn,arg", [("pixel_shuffle", 2),
                                    ("pixel_unshuffle", 2),
                                    ("channel_shuffle", 3)])
def test_shuffles_match_reference(fn, arg, fmt):
    rng = np.random.default_rng(2)
    shape = {"pixel_shuffle": (2, 12, 3, 4), "pixel_unshuffle": (2, 3, 6, 8),
             "channel_shuffle": (2, 6, 3, 4)}[fn]
    if fmt == "NHWC":
        shape = (shape[0], shape[2], shape[3], shape[1])
    out = both(lambda x: getattr(JF, fn)(x, arg, fmt),
               lambda x: getattr(TF, fn)(x, arg, fmt),
               [rand(rng, *shape)], rng, 0.0)
    assert out.numel() == int(np.prod(shape))


# (input shape, kernel, stride, padding, dilation)
UNFOLD_CASES = {
    "k3_s2_p1": ((2, 3, 7, 6), 3, 2, 1, 1),
    "k_rect_pads2": ((1, 2, 6, 7), (2, 3), (1, 2), [1, 2], 1),
    "pads4_dilation": ((1, 2, 7, 8), 2, 1, [1, 0, 2, 1], 2),
}


@pytest.mark.parametrize("case", sorted(UNFOLD_CASES))
def test_unfold_fold_match_reference(case):
    shape, k, s, p, d = UNFOLD_CASES[case]
    rng = np.random.default_rng(3)
    cols = both(lambda x: JF.unfold(x, k, s, p, d),
                lambda x: TF.unfold(x, k, s, p, d),
                [rand(rng, *shape)], rng, RTOL)
    out_hw = list(shape[2:])
    both(lambda c: JF.fold(c, out_hw, k, s, p, d),
         lambda c: TF.fold(c, out_hw, k, s, p, d),
         [rand(rng, *cols.shape)], rng, RTOL)


def test_zeropad2d_matches_reference():
    rng = np.random.default_rng(4)
    both(lambda x: JF.zeropad2d(x, [1, 0, 2, 3]),
         lambda x: TF.zeropad2d(x, [1, 0, 2, 3]),
         [rand(rng, 2, 3, 4, 5)], rng, 0.0)


@pytest.mark.parametrize("align", [True, False], ids=["corners", "centres"])
def test_affine_grid_matches_reference(align):
    rng = np.random.default_rng(5)
    both(lambda th: JF.affine_grid(th, [2, 3, 5, 7], align_corners=align),
         lambda th: TF.affine_grid(th, [2, 3, 5, 7], align_corners=align),
         [rand(rng, 2, 2, 3)], rng, RTOL)


@pytest.mark.parametrize("align", [True, False], ids=["corners", "centres"])
@pytest.mark.parametrize("padding", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample_matches_reference(mode, padding, align):
    """Grid points past the image on every side, so each padding mode
    acts; grads of the image and (bilinear) of the grid: rounding gives
    "nearest" no grid grad, which the reference returns as a scalar 0."""
    rng = np.random.default_rng(6)
    x = rand(rng, 2, 3, 5, 6)
    grid = rng.uniform(-1.4, 1.4, (2, 4, 7, 2)).astype(np.float32)
    kw = dict(mode=mode, padding_mode=padding, align_corners=align)
    if mode == "bilinear":
        both(lambda a, g: JF.grid_sample(a, g, **kw),
             lambda a, g: TF.grid_sample(a, g, **kw), [x, grid], rng, RTOL)
        return
    both(lambda a: JF.grid_sample(a, j_(grid), **kw),
         lambda a: TF.grid_sample(a, t_(grid), **kw), [x], rng, RTOL)


LAYERS = {
    "Upsample": ((None, 2, "bilinear"), (1, 2, 4, 5)),
    "UpsamplingBilinear2D": (([7, 9],), (1, 2, 4, 5)),
    "UpsamplingNearest2D": ((None, 3), (1, 2, 4, 5)),
    "Pad1D": (([1, 2], "reflect"), (2, 3, 6)),
    "Pad2D": (([1, 2, 0, 1], "replicate"), (2, 3, 4, 5)),
    "Pad3D": (([1, 0, 1, 2, 0, 1], "circular"), (1, 2, 3, 4, 5)),
    "ZeroPad2D": (([2, 1, 1, 0],), (2, 3, 4, 5)),
    "Unfold": ((3, 1, 1), (1, 2, 5, 6)),
    "Fold": (([4, 5], 2), (1, 8, 12)),
    "PixelShuffle": ((2,), (1, 8, 3, 4)),
    "PixelUnshuffle": ((2,), (1, 2, 4, 6)),
    "ChannelShuffle": ((2,), (1, 6, 3, 4)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_vision_layer_matches_reference(name):
    args, shape = LAYERS[name]
    rng = np.random.default_rng(7)
    jl, tl = getattr(JN, name)(*args), getattr(TN, name)(*args)
    assert list(tl.parameters()) == []
    both(jl, tl, [rand(rng, *shape)], rng, RTOL)
