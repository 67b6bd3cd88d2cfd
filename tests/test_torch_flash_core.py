"""The one-length flash route of the port (csrc/flash_wgmma.cu on the
card) against the JAX package, on the CPU: the backward's delta
pre-pass, `flash_attention_delta`, whose plain version a CPU tensor
takes, against the reference's expression (upstream
jax/experimental/pallas/ops/tpu/flash_attention.py l.273, which
paddle_tpu/kernels/flash_attention.py:283 reaches), and the route at a
ragged sequence length (not a multiple of any kernel tile) against the
reference's `_sdpa`. The same seeded numpy inputs go through both; the
wgmma kernels themselves are held against these plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models.llama import _sdpa as j_sdpa
from paddle_tpu_torch.kernels import flash_attention as t_fa

from _torch_threads import one_torch_thread  # noqa: F401,E402

# f32 against f32: summation order only
RTOL = 1e-5


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("B,S,H,D,dtype", [
    (2, 64, 4, 128, "float32"), (1, 100, 2, 64, "float32"),
    (2, 64, 4, 128, "bfloat16"), (1, 1000, 3, 64, "bfloat16")],
    ids=["f32_d128", "f32_d64_ragged", "bf16_d128", "bf16_d64_ragged"])
def test_delta_matches_reference(B, S, H, D, dtype):
    """D = rowsum(dO * O) in f32, [B, H, S]: the port's pre-pass on CPU
    tensors against upstream's `jnp.sum(o.astype(f32) * do.astype(f32),
    -1)` over the reference's BHSD layout, from the same (rounded)
    inputs."""
    rng = np.random.RandomState(5)
    dt = getattr(torch, dtype)
    o = torch.from_numpy(rng.randn(B, S, H, D).astype(np.float32)).to(dt)
    do = torch.from_numpy(rng.randn(B, S, H, D).astype(np.float32)).to(dt)
    before = t_fa.flash_attention_delta.launches
    got = t_fa.flash_attention_delta(o, do)
    assert t_fa.flash_attention_delta.launches == before  # plain version
    assert got.dtype == torch.float32 and got.shape == (B, H, S)
    o_j, do_j = (jnp.swapaxes(jnp.asarray(t.float().numpy()), 1, 2)
                 for t in (o, do))
    want = jnp.sum(o_j.astype(jnp.float32) * do_j.astype(jnp.float32),
                   axis=-1)
    assert _max_rel(got, want) <= RTOL


@pytest.mark.parametrize("S,H,D", [(1000, 2, 128), (333, 4, 64)],
                         ids=["d128_s1000", "d64_s333"])
def test_ragged_causal_matches_reference(S, H, D):
    """Causal MHA at a sequence length that is no multiple of the wgmma
    core's 64- and 128-row tiles, forward and VJP, against the
    reference's `_sdpa` (its CPU route)."""
    rng = np.random.RandomState(6)
    q, k, v, do = (rng.randn(1, S, H, D).astype(np.float32)
                   for _ in range(4))
    o_j, vjp = jax.vjp(j_sdpa, jnp.asarray(q), jnp.asarray(k),
                       jnp.asarray(v))
    grads_j = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    o = t_fa.flash_attention_bshd(*leaves, causal=True)
    o.backward(torch.from_numpy(do))
    assert _max_rel(o.detach(), o_j) <= RTOL
    for leaf, want in zip(leaves, grads_j):
        assert _max_rel(leaf.grad, want) <= RTOL
