"""Port LLaMA serving half (paddle_tpu_torch.models) against the JAX
model: weight conversion round trips for fused and unfused layouts, and
`_ragged_step_paged` logits and updated KV pools on the same seeded
inputs, in fp32 on the CPU."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models.convert import state_from_jax

from _torch_threads import one_torch_thread  # noqa: F401,E402


def _jax_model(dtype="float32", fused=True, seed=0):
    paddle.seed(seed)
    cfg = JL.llama_tiny(dtype=dtype, use_recompute=False,
                        fuse_attention_qkv=fused, fuse_mlp=fused)
    return JL.LlamaForCausalLM(cfg)


def _np_state(model):
    return {k: np.asarray(v.numpy()).astype(np.float32)
            for k, v in model.state_dict().items()}


class TestStateFromJax:
    @pytest.mark.parametrize("src_fused,dst_fused",
                             [(True, True), (False, True), (True, False),
                              (False, False)],
                             ids=["fused", "unfused_to_fused",
                                  "fused_to_unfused", "unfused"])
    def test_round_trip(self, src_fused, dst_fused):
        jm = _jax_model(fused=src_fused)
        np_state = _np_state(jm)
        cfg = TL.llama_tiny(dtype="float32", fuse_attention_qkv=dst_fused,
                            fuse_mlp=dst_fused)
        tm = TL.LlamaForCausalLM(cfg, device="cpu")
        tm.load_state_dict(state_from_jax(np_state, cfg, "cpu"))
        got = {k: v.numpy() for k, v in tm.state_dict().items()}
        # the reference's own translation is the ground truth for layout
        want = JL._translate_fusion_keys(
            {k: jnp.asarray(v) for k, v in np_state.items()},
            JL.llama_tiny(dtype="float32", fuse_attention_qkv=dst_fused,
                          fuse_mlp=dst_fused))
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))

    def test_keys_and_shapes_match_reference(self):
        jm = _jax_model()
        tm = TL.LlamaForCausalLM(TL.llama_tiny(dtype="float32"),
                                 device="cpu")
        want = {k: tuple(v.shape) for k, v in jm.state_dict().items()}
        got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
        assert got == want

    def test_bf16_model_keeps_f32_norms(self):
        jm = _jax_model(dtype="bfloat16")
        cfg = TL.llama_tiny(dtype="bfloat16")
        st = state_from_jax(_np_state(jm), cfg, "cpu")
        for k, v in st.items():
            want = torch.float32 if k.endswith("norm.weight") \
                else torch.bfloat16
            assert v.dtype == want, k
        tm = TL.LlamaForCausalLM(cfg, device="cpu")
        tm.load_state_dict(st)
        assert tm.model.norm.weight.dtype == torch.float32
        assert tm.lm_head.dtype == torch.bfloat16


def _step_inputs(cfg, seed=5):
    """Packed ragged step: a 6-row prefill chunk on top of 10 cached
    tokens, a decode row at position 20, an idle slot, a 3-token fresh
    prefill, 4 padding rows (T = 16); pools hold random context KV."""
    rng = np.random.RandomState(seed)
    L, kvh, d = cfg.num_hidden_layers, cfg.kv_heads, cfg.head_dim
    page, n_pages, B, ppmax = 16, 9, 4, 4
    kp = (0.5 * rng.randn(L, kvh, n_pages, page, d)).astype(np.float32)
    vp = (0.5 * rng.randn(L, kvh, n_pages, page, d)).astype(np.float32)
    pt = np.zeros((B, ppmax), np.int32)
    pt[0, :1] = [3]
    pt[1, :2] = [1, 5]
    pt[3, :1] = [7]
    rows = [(0, 6, 16), (6, 1, 21), (0, 0, 0), (7, 3, 3)]
    q_start, q_len, kv_len = (np.array([r[i] for r in rows], np.int32)
                              for i in range(3))
    T = 16
    toks = np.zeros(T, np.int32)
    pos = np.zeros(T, np.int32)
    page_ids = np.zeros(T, np.int32)
    offs = np.zeros(T, np.int32)
    for s, (qs, ql, kl) in enumerate(rows):
        for t in range(ql):
            p = kl - ql + t
            toks[qs + t] = rng.randint(1, cfg.vocab_size)
            pos[qs + t] = p
            page_ids[qs + t] = pt[s, p // page]
            offs[qs + t] = p % page
    return toks, pos, kp, vp, page_ids, offs, pt, q_start, q_len, kv_len


@pytest.mark.parametrize("fused_flag", [True, False],
                         ids=["fused_transformer", "unfused"])
def test_ragged_step_matches_jax(fused_flag):
    jm = _jax_model()
    np_state = _np_state(jm)
    cfg = TL.llama_tiny(dtype="float32")
    state = state_from_jax(np_state, cfg, "cpu")
    inp = _step_inputs(cfg)
    toks, pos, kp, vp, page_ids, offs, pt, qs, ql, kl = inp
    paddle.set_flags({"FLAGS_fused_transformer": fused_flag})
    ptt.set_flags({"FLAGS_fused_transformer": fused_flag})
    try:
        jstate = {k: v.data for k, v in jm.state_dict().items()}
        lg_j, kp_j, vp_j = JL._ragged_step_paged(
            jstate, jm.cfg, *(jnp.asarray(x) for x in
                              (toks, pos, kp, vp, page_ids, offs, pt, qs,
                               ql, kl)))
        kp_t, vp_t = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
        lg_t, kp_t2, vp_t2 = TL._ragged_step_paged(
            state, cfg, *(torch.from_numpy(x) for x in (toks, pos)),
            kp_t, vp_t, *(torch.from_numpy(x) for x in
                          (page_ids, offs, pt, qs, ql, kl)))
    finally:
        paddle.set_flags({"FLAGS_fused_transformer": True})
        ptt.set_flags({"FLAGS_fused_transformer": True})
    assert kp_t2 is kp_t                # pools are written in place
    live = ql > 0
    np.testing.assert_allclose(lg_t.numpy()[live], np.asarray(lg_j)[live],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(kp_t.numpy(), np.asarray(kp_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(vp_t.numpy(), np.asarray(vp_j), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("ckpt_fused", [True, False],
                         ids=["fused_ckpt", "unfused_ckpt"])
def test_unfused_flag_keeps_swiglu_layout_off_cpu(ckpt_fused):
    """FLAGS_fused_transformer=0 unfuses the MLP only on the CPU; a state
    on another device keeps the wide gate_up layout the SwiGLU kernel
    takes, so the card never leaves its kernels."""
    cfg = TL.llama_tiny(dtype="float32", fuse_attention_qkv=ckpt_fused,
                        fuse_mlp=ckpt_fused)
    cpu_state = dict(TL.LlamaForCausalLM(cfg, device="cpu").state_dict())
    meta_state = {k: v.to("meta") for k, v in cpu_state.items()}
    m = cfg.intermediate_size
    ptt.set_flags({"FLAGS_fused_transformer": False})
    try:
        on_cpu = TL._gather_layer_weights(cpu_state, cfg)
        off_cpu = TL._gather_layer_weights(meta_state, cfg)
    finally:
        ptt.set_flags({"FLAGS_fused_transformer": True})
    for wl in on_cpu:
        assert "mlp.gate_up_proj" not in wl
        assert wl["mlp.gate_proj"].shape == (cfg.hidden_size, m)
        assert "self_attn.q_proj" in wl
    for wl in off_cpu:
        assert "mlp.gate_proj" not in wl
        assert wl["mlp.gate_up_proj"].shape == (cfg.hidden_size, 2 * m)
        assert "self_attn.q_proj" in wl and "self_attn.qkv_proj" not in wl


def test_verify_rows_not_ported():
    """The verify_rows branch (speculative verification, once refused
    here) is ported: [B, K, V] right-aligned logits against the
    reference's at the live window slots, its last slot bitwise the
    last-row branch's logits."""
    jm = _jax_model()
    cfg = TL.llama_tiny(dtype="float32")
    state = state_from_jax(_np_state(jm), cfg, "cpu")
    inp = _step_inputs(cfg)
    jstate = {k: v.data for k, v in jm.state_dict().items()}
    want, _, _ = JL._ragged_step_paged(
        jstate, jm.cfg, *(jnp.asarray(x) for x in inp), verify_rows=4)
    got, _, _ = TL._ragged_step_paged(
        state, cfg, *(torch.from_numpy(x.copy()) for x in inp),
        verify_rows=4)
    assert got.shape == (4, 4, cfg.vocab_size)
    ql = inp[8]
    live = (ql[:, None] > 0) & (np.arange(4)[None, :] >= 4 - np.minimum(
        ql, 4)[:, None])
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               rtol=0, atol=1e-4)
    last, _, _ = TL._ragged_step_paged(
        state, cfg, *(torch.from_numpy(x.copy()) for x in inp))
    assert torch.equal(got[:, -1], last)
