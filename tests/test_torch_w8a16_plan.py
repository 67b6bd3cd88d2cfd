"""The W8A16 kernel's split-K schedule (`kernels/weight_only_linear.py::
plan`) on the CPU, and its arithmetic in plain PyTorch (`split_plain`)
against the plain route and the JAX package's int8 product.

The kernel sums each output over K in S splits of whole 64-row steps and
adds the splits' f32 partials in split order. The rules that keep a row
of an M-row product bitwise the 1-row product of that row, and a
ragged serving step within its memory gate, are checked here on `plan`
itself: S and the boundaries do not follow M; the splits cover K in
whole steps that each lie in one scale group; scratch stays under the
bf16 o_proj's bytes at the serving shapes and is none where a block
owns its K."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.incubate.nn.functional as JIF
from paddle_tpu_torch import testing
from paddle_tpu_torch.kernels import swiglu as ksw
from paddle_tpu_torch.kernels import weight_only_linear as kwol

from _torch_threads import one_torch_thread  # noqa: F401,E402

# llama_7b's serving products and the card tests' small and ragged ones
SHAPES = {**testing.W8A16_SHAPES, "tiny_gate_up": (688, 1376, True),
          "tiny_down": (688, 256, False), "layouts": (4096, 2752, False),
          "layouts_gu": (4096, 2752, True), "scalar_edges": (100, 72, False),
          "scalar_edges_gu": (100, 74, True)}
# every row count the engines give the kernel: the ragged step's 1 to
# 128 packed rows (T_pack), the card tests' ragged edges, the bucketed
# engine's 512-row prefill
ROWS = sorted({*range(1, 129), *testing.W8A16_ROWS, 512})
# a ragged serving step's memory gate: o_proj in bf16 (chip_smoke 6d)
O_PROJ_BF16 = 4096 * 4096 * 2


@pytest.mark.parametrize("name", list(SHAPES))
def test_splits_do_not_follow_rows(name):
    """S and the split boundaries are a function of (K, N, epilogue):
    the same for every M."""
    K, N, gu = SHAPES[name]
    first = kwol.plan(1, K, N, gu)
    for M in ROWS:
        p = kwol.plan(M, K, N, gu)
        assert (p.splits, p.bounds) == (first.splits, first.bounds), M


@pytest.mark.parametrize("name", list(SHAPES))
def test_splits_cover_k_in_whole_steps_within_groups(name):
    """The splits tile [0, ceil(K / 64)) steps, each split at least one
    step, and each 64-row step lies in one scale group: the whole of K
    (per column, per tensor) and every group of 64, 128 or 256 rows that
    divides K (the kernel takes groups of whole steps)."""
    K, N, gu = SHAPES[name]
    p = kwol.plan(4, K, N, gu)
    steps = -(-K // 64)
    assert p.bounds[0] == 0 and p.bounds[-1] == steps
    assert len(p.bounds) == p.splits + 1
    assert all(b < c for b, c in zip(p.bounds, p.bounds[1:]))
    for g in [K] + [g for g in (64, 128, 256) if K % g == 0]:
        for t in range(steps):
            assert (64 * t) // g == min(64 * t + 63, K - 1) // g, (g, t)


def test_split_counts_at_llama_7b():
    """At llama_7b o and down (32 column tiles of 128) split K four ways,
    filling 128 of the 132 SMs; qkv (96 tiles), the SwiGLU product (172)
    and the lm head (250) keep one split, where a merge would cost more
    than the rounds it saves."""
    want = {"qkv": 1, "o": 4, "gate_up": 1, "down": 4, "lm_head": 1}
    got = {n: kwol.plan(128, K, N, gu).splits
           for n, (K, N, gu) in testing.W8A16_SHAPES.items()}
    assert got == want


@pytest.mark.parametrize("name", list(testing.W8A16_SHAPES))
def test_scratch_under_the_step_gate(name):
    """At the ragged step's rows (up to 128) the split partials' f32
    scratch stays under a bf16 o_proj's bytes; at the bucketed prefill's
    512 rows, and wherever S is 1, a block owns its K and there is no
    scratch or ticket."""
    K, N, gu = testing.W8A16_SHAPES[name]
    for M in range(1, 129):
        p = kwol.plan(M, K, N, gu)
        assert 4 * p.scratch < O_PROJ_BF16, M
        if p.splits == 1:
            assert p.route == "direct" and p.scratch == 0 and p.tickets == 0
        else:
            assert p.route == "scratch" and p.tickets == p.tiles
            assert p.scratch == p.splits * p.n * p.tiles * 128
    p = kwol.plan(512, K, N, gu)
    assert p.scratch == 0 and p.tickets == 0
    assert p.route == ("owned" if p.splits > 1 else "direct")


@pytest.mark.parametrize("name", list(testing.W8A16_SHAPES))
def test_route_switches(name):
    """The products' N follows the rows (8, 32, 64, 128), and above 128
    rows the row groups of 128 multiply (and, where S > 1, scratch gives
    way to the in-register merge): the card checks rows at both sides of
    each switch."""
    K, N, gu = testing.W8A16_SHAPES[name]
    assert kwol.route_switches(K, N, gu) == [8, 32, 64, 128]
    assert [kwol.plan(M, K, N, gu).n for M in (1, 8, 9, 32, 33, 64, 65,
                                               128)] == \
        [8, 8, 32, 32, 64, 64, 128, 128]
    p = kwol.plan(129, K, N, gu)
    assert p.n == 128 and p.row_groups == 2
    assert p.route == ("owned" if p.splits > 1 else "direct")


@pytest.mark.parametrize("name", list(SHAPES))
def test_switch_rows_cover_every_switch(name):
    """The card's row-independence rows (`testing.W8A16_SWITCH_ROWS`)
    are both sides of every switch of the plan at each shape it checks,
    and 512."""
    K, N, gu = SHAPES[name]
    assert testing.w8a16_switch_rows(K, N, gu) == \
        list(testing.W8A16_SWITCH_ROWS)


def _case(M, K, N, layout, dtype, seed=0):
    """a [M, K] and a [K, N] weight from numpy, quantized by the
    reference's incubate rule (per column, or groups of `layout` rows)."""
    rng = np.random.default_rng(seed)
    w = (0.02 * rng.standard_normal((K, N))).astype(np.float32)
    a = rng.standard_normal((M, K)).astype(np.float32)
    group = -1 if layout == "column" else int(layout)
    jq, js = JIF.weight_quantize(paddle.to_tensor(w), group_size=group)
    q = torch.from_numpy(np.array(jq.numpy()))
    s = torch.from_numpy(np.array(jnp.asarray(js.numpy(), jnp.float32)))
    if s.dim() == 1:
        s = s.reshape(1, -1)
    return a, torch.from_numpy(a).to(dtype), q, s, group


# K = 2048 is 32 steps; N = 256 int8 columns give 2 column tiles
# (plain) or 2 (SwiGLU's 64-wide tiles): S = 4 splits of 8 steps
SPLIT_K, SPLIT_N = 2048, 256


@pytest.mark.parametrize("swiglu", [False, True], ids=["plain", "swiglu"])
@pytest.mark.parametrize("layout", ["column", "128"])
@pytest.mark.parametrize("M", [1, 5, 130])
def test_split_plain_matches_plain(M, layout, swiglu):
    """The kernel's split schedule in plain PyTorch against the plain
    route in bf16: within `testing.W8A16_LIMIT` of the plain version's
    f32 product over the same dequantized weight (what the card holds
    the kernel to), and for the plain epilogue of `_plain` itself."""
    assert kwol.plan(M, SPLIT_K, SPLIT_N, swiglu).splits == 4
    _, a, q, s, _ = _case(M, SPLIT_K, SPLIT_N, layout, torch.bfloat16)
    bias = None if swiglu else (
        0.1 * torch.from_numpy(np.random.default_rng(1).standard_normal(
            SPLIT_N).astype(np.float32))).to(torch.bfloat16)
    got = kwol.split_plain(a, q, s, bias=bias, swiglu=swiglu)
    w = kwol.dequantize(q, s, a.dtype).float()
    atol = testing.W8A16_LIMIT[0]
    if swiglu:
        ref = ksw._ref(a.float(), w)
    else:
        ref = a.float() @ w
        atol = atol + testing.BF16_RTOL * ref.abs()
        ref = ref.to(a.dtype).float() + bias.float()
        plain = kwol._plain(a, q, s, bias, False)
        assert testing.worst(got, plain.float(), atol,
                             testing.W8A16_LIMIT[1]) <= 1.0
    assert got.dtype == torch.bfloat16
    assert got.shape == (M, SPLIT_N // 2 if swiglu else SPLIT_N)
    assert testing.worst(got, ref, atol, testing.W8A16_LIMIT[1]) <= 1.0


@pytest.mark.parametrize("swiglu", [False, True], ids=["plain", "swiglu"])
@pytest.mark.parametrize("layout", ["column", "128"])
def test_split_plain_matches_jax_in_f32(layout, swiglu):
    """In f32 the split schedule against the JAX package's
    `weight_only_linear` (the reference's int8 product, XLA's f32 dot) on
    the same numpy-seeded codes and scales, SwiGLU composed from its
    product. The two differ only in summation order over K = 2048 terms:
    |diff| <= 1e-6 of the sum of |terms| (a few f32 roundoffs of 6e-8;
    the readings are 4e-8 to 7e-8)."""
    M = 7
    x, a, q, s, group = _case(M, SPLIT_K, SPLIT_N, layout, torch.float32,
                              seed=2)
    jq = paddle.to_tensor(q.numpy())
    js = paddle.to_tensor(s.numpy() if group > 0 else s.numpy()[0])
    jo = np.asarray(jnp.asarray(JIF.weight_only_linear(
        paddle.to_tensor(x), jq, None, js, group_size=group).numpy(),
        jnp.float32))
    w = kwol.dequantize(q, s, torch.float32).numpy()
    terms = np.abs(x) @ np.abs(w)
    if swiglu:
        h = SPLIT_N // 2
        g, u = jo[:, :h].astype(np.float64), jo[:, h:].astype(np.float64)
        jo = g / (1.0 + np.exp(-g)) * u
        # d(silu(g) u) = u silu'(g) dg + silu(g) du, |silu'| <= 1.1
        sg = np.abs(g / (1.0 + np.exp(-g)))
        terms = 1.1 * np.abs(u) * terms[:, :h] + sg * terms[:, h:]
    got = kwol.split_plain(a, q, s, swiglu=swiglu).numpy()
    err = np.abs(got - jo)
    assert (err <= 1e-6 * terms + 1e-30).all(), float(
        (err / (terms + 1e-30)).max())
