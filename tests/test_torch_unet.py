"""The port's conditional UNet (paddle_tpu_torch.models.unet) against
the JAX package's `UNet2DConditionModel(unet_tiny())`, in fp32 on the
CPU, from seeded numpy inputs (latents [2, 4, 16, 16], timesteps,
context [2, 7, 64], target noise), with the reference's weights carried
by `models.convert.layer_state_from_jax` (its keys, in its order):

- the forward, then the MSE loss and every parameter's grad;
- a 3-step AdamW trajectory of the port's `jit.TrainStep` against
  `paddle_tpu.jit.TrainStep`: every loss and every parameter after it.
  An element whose first grad is at summation noise (|g| <= NOISE_GRAD
  1e-6: one element of the first GroupNorm's bias reads 5e-10, the
  next 3e-4) moves by up to lr a step on that noise's sign; it is held
  to Adam's bound, 2 lr a step, and the rest of its tensor to
  STEP_RTOL, as tests/test_torch_encoder_train.py holds its own;
- the context moves the output (cross-attention is wired in), and so
  does the timestep;
- the building blocks' rules: `timestep_embedding`, GEGLU's gelu on the
  second half, the head count, GroupNorm's gcd groups, and the
  parameter counts of bench.py's UNet and of `unet_sd15()`.

Limits: FWD_RTOL 1e-5 (max |port - reference| / max |reference|) for
the forward and the loss; GRAD_RTOL 1e-4 for each grad's relative L2
(twenty-odd layers of f32 sums in another order); STEP_RTOL 1e-4 for
the parameters' relative L2 after three steps.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import optimizer as jopt
from paddle_tpu.models import unet as JU
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import unet as TU
from paddle_tpu_torch.nn import functional as TF

from _torch_parity import carry, j_, max_rel, t_
from _torch_threads import one_torch_thread  # noqa: F401,E402

FWD_RTOL = 1e-5
GRAD_RTOL = 1e-4
STEP_RTOL = 1e-4
NOISE_GRAD = 1e-6
STEPS = 3


def _rel_l2(got, want):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    t = rng.integers(0, 1000, (2,)).astype(np.int64)
    ctx = rng.standard_normal((2, 7, 64)).astype(np.float32)
    noise = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    return x, t, ctx, noise


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    jm = JU.UNet2DConditionModel(JU.unet_tiny())
    tm = TU.UNet2DConditionModel(TU.unet_tiny(), device="cpu")
    carry(jm, tm)
    return jm, tm


def _j_args(x, t, ctx):
    return j_(x), paddle.to_tensor(t.astype(np.int32)), j_(ctx)


def _t_args(x, t, ctx):
    return t_(x), torch.from_numpy(t), t_(ctx)


def test_forward_loss_and_grads_match_reference(pair):
    jm, tm = pair
    x, t, ctx, noise = _inputs()
    yj = jm(*_j_args(x, t, ctx))
    yt = tm(*_t_args(x, t, ctx))
    assert max_rel(yt, yj.numpy()) <= FWD_RTOL
    lj = JF.mse_loss(yj, j_(noise))
    lt = TF.mse_loss(yt, t_(noise))
    assert abs(float(lt) - float(lj.numpy())) <= FWD_RTOL * float(
        lj.numpy())
    lj.backward()
    lt.backward()
    jgrads = dict(jm.named_parameters())
    err = {n: _rel_l2(p.grad, jgrads[n].grad.numpy())
           for n, p in tm.named_parameters()}
    assert len(err) == len(jgrads)
    worst = max(err, key=err.get)
    assert err[worst] <= GRAD_RTOL, (worst, err[worst])
    for p in jm.parameters():
        p.clear_grad()
    tm.zero_grad(set_to_none=True)


def test_trainstep_trajectory_matches_reference(pair):
    """Three AdamW(1e-4, weight_decay 0.01) steps, bench.py's optimizer,
    through each package's TrainStep from the same weights."""
    jm, tm = pair
    carry(jm, tm)
    x, t, ctx, noise = _inputs(1)
    jstep = paddle.jit.TrainStep(
        jm, jopt.AdamW(learning_rate=1e-4, parameters=jm.parameters(),
                       weight_decay=0.01),
        lambda a, b, c, n: JF.mse_loss(jm(a, b, c), n))
    tstep = TrainStep(
        tm, topt.AdamW(learning_rate=1e-4, parameters=tm.parameters(),
                       weight_decay=0.01),
        lambda a, b, c, n: TF.mse_loss(tm(a, b, c), n))
    jargs = (*_j_args(x, t, ctx), j_(noise))
    targs = (*_t_args(x, t, ctx), t_(noise))
    TF.mse_loss(tm(*targs[:3]), targs[3]).backward()
    first = {n: p.grad.numpy().copy() for n, p in tm.named_parameters()}
    tm.zero_grad(set_to_none=True)
    for i in range(STEPS):
        lj, lt = float(jstep(*jargs).numpy()), float(tstep(*targs))
        assert abs(lt - lj) <= FWD_RTOL * abs(lj), (i, lt, lj)
    jstate = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    lr = 1e-4
    for k, v in tm.state_dict().items():
        want = np.asarray(jstate[k], np.float64)
        noise = np.abs(first[k]) <= NOISE_GRAD
        diff = v.double().numpy() - want
        assert np.abs(diff[noise]).max(initial=0.0) <= 2 * lr * STEPS, k
        err, norm = (np.linalg.norm(a[~noise]) for a in (diff, want))
        assert err <= STEP_RTOL * norm, (k, err, norm)


def test_context_and_timestep_move_the_output(pair):
    _, tm = pair
    x, t, ctx, _ = _inputs(2)
    with torch.no_grad():
        base = tm(*_t_args(x, t, ctx))
        other_ctx = tm(*_t_args(x, t, -ctx))
        other_t = tm(*_t_args(x, t + 37, ctx))
    assert max_rel(other_ctx, base) > 1e-3
    assert max_rel(other_t, base) > 1e-3
    assert torch.isfinite(base).all()


def test_blocks_follow_the_reference():
    """timestep_embedding against the reference's; GEGLU is gelu(tanh)
    of the second half times the first; SD 1.5's heads are
    max(1, c // (8 * 8)) = 5 of 64 at 320 channels; GroupNorm groups are
    gcd(32, c)."""
    t = np.array([0, 1, 500, 999], np.int64)
    got = TU.timestep_embedding(torch.from_numpy(t), 64)
    want = JU.timestep_embedding(paddle.to_tensor(t.astype(np.int32)).data,
                                 64)
    assert max_rel(got, np.asarray(want)) <= FWD_RTOL
    g = TU.GEGLU(8, device="cpu")
    x = torch.randn(3, 8, generator=torch.Generator().manual_seed(0))
    a, b = g.proj(x).chunk(2, -1)
    want = g.out(torch.nn.functional.gelu(b, approximate="tanh") * a)
    assert torch.equal(g(x), want)
    m = TU.UNet2DConditionModel(TU.unet_sd15(), device="meta")
    attn = m.down_attn[0]
    assert attn.block.attn1.heads == 5 and attn.block.attn1.head_dim == 64
    assert attn.norm._num_groups == math.gcd(32, 320)
    tiny = TU.UNet2DConditionModel(TU.unet_tiny(), device="meta")
    assert tiny.down_res[0].norm1._num_groups == 8
    assert tiny.down_attn[0].block.attn1.heads == max(1, 32 // (4 * 8))


@pytest.mark.parametrize("cfg,count", [
    (dict(block_out_channels=(128, 256, 512, 512), cross_attention_dim=512,
          sample_size=32), 139680132),
    ("sd15", 859520964)], ids=["bench", "sd15"])
def test_parameter_counts(cfg, count):
    """bench.py's UNet (l.437-439) and the published SD 1.5 UNet, on the
    meta device."""
    m = (TU.UNet2DConditionModel(TU.unet_sd15(), device="meta")
         if cfg == "sd15" else
         TU.UNet2DConditionModel(device="meta", **cfg))
    assert sum(p.numel() for p in m.parameters()) == count
