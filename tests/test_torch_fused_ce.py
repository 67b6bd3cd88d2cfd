"""The port's fused cross-entropy (paddle_tpu_torch/kernels/
cross_entropy.py) against the JAX package's, on the CPU. The same seeded
numpy logits and labels go through the reference's `fused_cross_entropy`
(its Pallas kernels in interpret mode off the TPU, cross_entropy.py:153)
and the port's CPU route (the plain f32 forward and backward the card's
kernels are held to): the per-row loss, and dx by `jax.vjp` against
autograd. The CUDA kernels themselves are held against the plain
version by tests/test_torch_cuda.py and chip_smoke.py on the card."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as ptt
from paddle_tpu.kernels import cross_entropy as j_ce
from paddle_tpu_torch.kernels import cross_entropy as t_ce
from paddle_tpu_torch.nn.functional import cross_entropy

from _torch_threads import one_torch_thread  # noqa: F401,E402

# f32: summation order alone (the reference sums exp over 2048-wide
# vocab blocks, the port over whole rows), max|a - b| / max|b|
F32_RTOL = 1e-5
# bf16 logits: the loss is still f32 math on the same inputs (F32_RTOL);
# dx is rounded to bf16 by both, so one rounding of either side's f32
# value may land on the neighbouring bf16 number: 2^-8 of max|dx|
BF16_DX_RTOL = 2.0 ** -8


def _max_rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _case(N, V, seed=0, out_of_range=True):
    """Logits N(0, 2^2), labels over the vocabulary with every 5th row
    ignore_index (-100) and, with `out_of_range`, one label far past the
    vocabulary and one negative label that is not ignore_index (neither
    reads a logit), a per-row cotangent N(0, 1)."""
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal((N, V))).astype(np.float32)
    lbl = rng.integers(0, V, N)
    lbl[::5] = -100
    if out_of_range:
        lbl[1] = 10 ** 6
        lbl[2] = -7
    g = rng.standard_normal(N).astype(np.float32)
    return x, lbl, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,V", [(37, 5000), (64, 2 * 4096 + 7), (8, 4096)],
                         ids=["37x5000", "64x8199", "8x4096"])
def test_plain_matches_reference_kernel(N, V, dtype):
    x, lbl, g = _case(N, V)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    loss_j, vjp = jax.vjp(
        lambda a: j_ce.fused_cross_entropy(a, jnp.asarray(lbl), -100),
        jnp.asarray(x).astype(jdt))
    (dx_j,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    loss_t = t_ce.fused_cross_entropy(xt, torch.from_numpy(lbl), -100)
    loss_t.backward(torch.from_numpy(g))
    assert loss_t.dtype == torch.float32 and xt.grad.dtype == xt.dtype
    assert float(loss_t.detach()[0]) == 0.0          # an ignore_index row
    assert _max_rel(loss_t.detach(), loss_j) <= F32_RTOL
    dx_rtol = BF16_DX_RTOL if dtype == "bfloat16" else F32_RTOL
    assert _max_rel(xt.grad.float(), np.asarray(dx_j, np.float32)) <= dx_rtol
    assert float(xt.grad[0].abs().max()) == 0.0      # no grad where ignored


def test_plain_backward_is_autograd_of_the_loss():
    """`_plain`, the comparison route chip_smoke.py swaps in, under
    autograd gives `_plain_bwd`'s dx and `_plain_fwd`'s loss."""
    x, lbl, g = _case(21, 4100, seed=1)
    xt = torch.from_numpy(x).requires_grad_()
    lt = torch.from_numpy(lbl)
    loss = t_ce._plain(xt, lt)
    loss.backward(torch.from_numpy(g))
    loss_f, m, l = t_ce._plain_fwd(xt.detach(), lt, -100)
    dx = t_ce._plain_bwd(xt.detach(), lt, m, l, torch.from_numpy(g), -100)
    assert _max_rel(loss.detach(), loss_f) <= F32_RTOL
    assert _max_rel(xt.grad, dx) <= F32_RTOL


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_flagged_route_on_cpu_matches_reference(reduction):
    """FLAGS_use_fused_ce=1 on both sides: off the accelerator both gates
    are closed and both packages take the plain route; loss and grad
    agree."""
    x, lbl, _ = _case(30, 4096, seed=2, out_of_range=False)
    ptt.set_flags({"FLAGS_use_fused_ce": True})
    paddle.set_flags({"FLAGS_use_fused_ce": True})
    try:
        assert not t_ce.supported(4096, device="cpu")
        assert not j_ce.supported(4096)
        xj = paddle.to_tensor(x, stop_gradient=False)
        lj = JF.cross_entropy(xj, paddle.to_tensor(lbl), reduction=reduction)
        lj.sum().backward()
        xt = torch.from_numpy(x).requires_grad_()
        lt = cross_entropy(xt, torch.from_numpy(lbl), reduction=reduction)
        lt.sum().backward()
    finally:
        ptt.set_flags({"FLAGS_use_fused_ce": False})
        paddle.set_flags({"FLAGS_use_fused_ce": False})
    assert _max_rel(lt.detach(), np.asarray(lj.numpy())) <= F32_RTOL
    assert _max_rel(xt.grad, np.asarray(xj.grad.numpy())) <= F32_RTOL


def test_gate():
    """The reference's gate: the flag, at least 4096 classes, and (for
    the port) a CUDA tensor."""
    assert not t_ce.supported(32000)                 # flag off
    ptt.set_flags({"FLAGS_use_fused_ce": True})
    try:
        assert t_ce.supported(32000) and t_ce.supported(4096, device="cuda:0")
        assert not t_ce.supported(4095)
        assert not t_ce.supported(32000, device="cpu")
        assert not t_ce.supported(32000, device="meta")
    finally:
        ptt.set_flags({"FLAGS_use_fused_ce": False})


@pytest.mark.parametrize("what", ["cpu_tensor", "fp16", "labels_2d",
                                  "float_labels"])
def test_use_kernel_refuses_what_the_kernels_do_not_take(what):
    x = torch.zeros(4, 4096)
    lbl = torch.zeros(4, dtype=torch.long)
    if what == "fp16":
        x = torch.zeros(4, 4096, dtype=torch.float16, device="meta")
        lbl = lbl.to("meta")
    elif what == "labels_2d":
        x, lbl = x.to("meta"), lbl[:, None].to("meta")
    elif what == "float_labels":
        x, lbl = x.to("meta"), lbl.float().to("meta")
    with pytest.raises(ValueError, match="fused_cross_entropy"):
        t_ce.fused_cross_entropy(x, lbl, use_kernel=True)
