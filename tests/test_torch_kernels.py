"""Port kernels (paddle_tpu_torch.kernels) against the JAX package's own
kernels: the same seeded numpy inputs through both, in fp32. The JAX
side runs as its own tests run it on the CPU — its plain reference and,
for swiglu and ragged paged attention, the Pallas kernel in interpret
mode. The port side runs each wrapper on CPU tensors (its plain
version). The CUDA kernels themselves are checked against the plain
versions by tests/test_torch_cuda.py (skipped without a card) and by
chip_smoke.py on the H100."""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels import ragged_paged_attention as j_rpa
from paddle_tpu.kernels import rms_norm as j_rms
from paddle_tpu.kernels import rope as j_rope
from paddle_tpu.kernels import swiglu as j_sw
from paddle_tpu_torch.kernels import ragged_paged_attention as t_rpa
from paddle_tpu_torch.kernels import rms_norm as t_rms
from paddle_tpu_torch.kernels import rope as t_rope
from paddle_tpu_torch.kernels import swiglu as t_sw


def _t(a):
    return torch.from_numpy(np.array(a))


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _ragged_case(seed=0, T=16, nh=4, kvh=2, d=64, n_pages=12, page=16,
                 ppmax=4, rows=((0, 5, 21), (5, 1, 7), (0, 0, 0),
                                (6, 6, 6))):
    """Packed metadata: a prefill chunk (q_len 5 deep in a 21-token
    sequence), a decode row, an idle slot, a from-scratch prefill, and
    rows 12.. that belong to no sequence (padding)."""
    rng = np.random.RandomState(seed)
    kp = rng.randn(kvh, n_pages, page, d).astype(np.float32)
    vp = rng.randn(kvh, n_pages, page, d).astype(np.float32)
    q = rng.randn(T, nh, d).astype(np.float32)
    B = len(rows)
    pt = np.zeros((B, ppmax), np.int32)
    nxt = 1
    for s, (_, _, kl) in enumerate(rows):
        for j in range(-(-max(kl, 1) // page)):
            pt[s, j] = nxt % n_pages or 1
            nxt += 1
    meta = [np.array([r[i] for r in rows], np.int32) for i in range(3)]
    return (q, kp, vp, *meta, pt)


class TestRmsNorm:
    def test_matches_jax(self):
        rng = np.random.RandomState(0)
        x = rng.randn(3, 5, 256).astype(np.float32)
        w = (1 + 0.1 * rng.randn(256)).astype(np.float32)
        want = np.asarray(j_rms.rms_norm(jnp.asarray(x), jnp.asarray(w),
                                         1e-5))
        got = t_rms.rms_norm(_t(x), _t(w), 1e-5).numpy()
        assert _max_rel(got, want) <= 1e-6
        assert t_rms.rms_norm.launches == 0     # CPU tensors never launch

    def test_bf16_keeps_dtype_and_f32_weight(self):
        x = torch.randn(4, 64).to(torch.bfloat16)
        y = t_rms.rms_norm(x, torch.ones(64), 1e-6)
        assert y.dtype == torch.bfloat16 and y.shape == x.shape


class TestSwiglu:
    @pytest.mark.parametrize("interpret", [False, True],
                             ids=["ref", "pallas_interpret"])
    def test_matches_jax(self, interpret):
        rng = np.random.RandomState(1)
        a = rng.randn(12, 256).astype(np.float32)
        w = (0.05 * rng.randn(256, 2 * 384)).astype(np.float32)
        want = np.asarray(j_sw.swiglu(jnp.asarray(a), jnp.asarray(w),
                                      use_pallas=interpret))
        got = t_sw.swiglu(_t(a), _t(w)).numpy()
        assert got.shape == (12, 384)
        assert _max_rel(got, want) <= 1e-5

    def test_leading_dims(self):
        a = torch.randn(2, 3, 32)
        w = torch.randn(32, 2 * 40)
        got = t_sw.swiglu(a, w)
        torch.testing.assert_close(got.reshape(6, 40),
                                   t_sw._ref(a.reshape(6, 32), w))


class TestRaggedPagedAttention:
    @pytest.mark.parametrize("nh,kvh", [(4, 4), (4, 2)], ids=["mha", "gqa"])
    @pytest.mark.parametrize("interpret", [False, True],
                             ids=["fallback", "pallas_interpret"])
    def test_matches_jax(self, nh, kvh, interpret):
        case = _ragged_case(nh=nh, kvh=kvh)
        scale = 1.0 / math.sqrt(case[0].shape[-1])
        want = np.asarray(j_rpa.ragged_paged_attention(
            *(jnp.asarray(c) for c in case), scale=scale,
            use_pallas=interpret))
        got = t_rpa.ragged_paged_attention(*(_t(c) for c in case),
                                           scale=scale).numpy()
        assert np.all(got[12:] == 0)             # padding rows
        assert _max_rel(got, want) <= 1e-5

    def test_bf16_prescale_in_q_dtype(self):
        """q is scaled in its own dtype before the f32 math (the
        reference fallback's order): within one bf16 ulp of the reference."""
        case = _ragged_case(seed=3)
        q16 = case[0].astype(jnp.bfloat16)
        want = np.asarray(j_rpa.ragged_paged_attention(
            jnp.asarray(q16), *(jnp.asarray(c.astype(jnp.bfloat16))
                                for c in case[1:3]),
            *(jnp.asarray(c) for c in case[3:]), use_pallas=False)
        ).astype(np.float32)
        got = t_rpa.ragged_paged_attention(
            _t(case[0]).to(torch.bfloat16),
            *(_t(c).to(torch.bfloat16) for c in case[1:3]),
            *(_t(c) for c in case[3:])).float().numpy()
        assert _max_rel(got, want) <= 1e-2     # one bf16 ulp of rounding


class TestRope:
    @pytest.mark.parametrize("packed", [True, False],
                             ids=["packed_rows", "batched"])
    def test_fused_qkv_rope_matches_jax(self, packed):
        rng = np.random.RandomState(2)
        nh, kvh, d = 8, 2, 32
        shape = (10, 256) if packed else (2, 5, 256)
        a = rng.randn(*shape).astype(np.float32)
        w = (0.05 * rng.randn(256, (nh + 2 * kvh) * d)).astype(np.float32)
        pos = (rng.randint(0, 60, size=shape[:-1]).astype(np.int32))
        want = j_rope.fused_qkv_rope(jnp.asarray(a), jnp.asarray(w), nh, kvh,
                                     d, position_ids=jnp.asarray(pos),
                                     seq_len=64)
        got = t_rope.fused_qkv_rope(_t(a), _t(w), nh, kvh, d,
                                    position_ids=_t(pos), seq_len=64)
        for g, wv in zip(got, want):
            assert tuple(g.shape) == tuple(wv.shape)
            assert _max_rel(g.numpy(), np.asarray(wv)) <= 1e-6


class TestExplicitKernelRequest:
    """use_kernel=True never silently runs the plain version."""

    @pytest.mark.parametrize("call", [
        lambda: t_rms.rms_norm(torch.randn(4, 12), torch.ones(12),
                               use_kernel=True),                 # H % 8
        lambda: t_sw.swiglu(torch.randn(4, 16), torch.randn(16, 33),
                            use_kernel=True),                    # odd 2M
        lambda: t_sw.swiglu(torch.randn(4, 16), torch.randn(8, 32),
                            use_kernel=True),                    # H mismatch
        lambda: t_rpa.ragged_paged_attention(
            *(_t(c) for c in _ragged_case(d=32)), use_kernel=True),  # d
        lambda: t_rpa.ragged_paged_attention(
            *(_t(c) for c in _ragged_case(nh=3, kvh=2)),
            use_kernel=True),                                    # nh % kvh
    ], ids=["rms_H", "swiglu_cols", "swiglu_H", "ragged_d", "ragged_gqa"])
    def test_unsupported_shape_raises(self, call):
        with pytest.raises(ValueError, match="use_kernel=True"):
            call()

    @pytest.mark.parametrize("call", [
        lambda: t_rms.rms_norm(torch.randn(4, 16), torch.ones(16),
                               use_kernel=True),
        lambda: t_sw.swiglu(torch.randn(4, 16), torch.randn(16, 32),
                            use_kernel=True),
        lambda: t_rpa.ragged_paged_attention(
            *(_t(c) for c in _ragged_case()), use_kernel=True),
    ], ids=["rms", "swiglu", "ragged"])
    def test_cpu_tensor_raises(self, call):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
