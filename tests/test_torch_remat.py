"""Per-layer remat in the port (framework/remat.py, models/llama.py with
use_recompute=True, jit.TrainStep's remat_policy) on the CPU, llama_tiny
in fp32.

Policies move memory and recompute, never values: under every policy,
with the fused flag on and off and with GQA, the loss and all 15 grads
are bitwise those of use_recompute=False. The reference's own policies
differ from each other by about 2e-7 relative on the CPU (XLA fuses each
differently), so the port's 5-step trajectory is held to the reference's
within a tolerance. What a policy keeps is counted: the bytes held for
the backward (saved by autograd outside the rematerialised layers, plus
the sites' kept outputs) order nothing < save_matmul_outputs < no remat,
and a kept SwiGLU output is not computed again."""
import gc

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
import paddle_tpu_torch as ptt
from paddle_tpu.models import llama as JL
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework import core, remat
from paddle_tpu_torch.jit import TrainStep, resolve_remat_policy
from paddle_tpu_torch.kernels import swiglu as t_sw
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models.convert import state_from_jax, to_numpy

from _torch_threads import one_torch_thread  # noqa: F401,E402

POLICIES = [None, "nothing", "save_matmul_outputs", "dots"]
TRAJ_RTOL = 1e-5        # 5-step losses and final weights vs the reference


def _tiny(use_recompute, gqa=False, seed=0):
    kw = dict(num_key_value_heads=2) if gqa else {}
    cfg = TL.llama_tiny(dtype="float32", use_recompute=use_recompute, **kw)
    gen = torch.Generator().manual_seed(seed)
    return TL.LlamaForCausalLM(cfg, device="cpu", generator=gen)


def _ids(seed=3, batch=2, seq=24):
    return torch.from_numpy(
        np.random.RandomState(seed).randint(0, 1024, (batch, seq)))


def _loss_and_grads(model, policy, ids):
    with core.remat_policy_guard(resolve_remat_policy(policy)):
        loss = model.loss(ids, ids)
        loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads


@pytest.mark.parametrize("variant", ["fused", "unfused", "gqa"])
@pytest.mark.parametrize("policy", POLICIES,
                         ids=["none", "nothing", "save_matmul_outputs",
                              "dots"])
def test_remat_is_bitwise_the_run_without(policy, variant):
    ptt.set_flags({"FLAGS_fused_transformer": variant != "unfused"})
    try:
        gqa = variant == "gqa"
        ids = _ids()
        loss0, grads0 = _loss_and_grads(_tiny(False, gqa), policy, ids)
        loss, grads = _loss_and_grads(_tiny(True, gqa), policy, ids)
    finally:
        ptt.set_flags({"FLAGS_fused_transformer": True})
    assert torch.equal(loss, loss0)
    assert sorted(grads) == sorted(grads0) and len(grads) == 15
    for name in grads0:
        assert torch.equal(grads[name], grads0[name]), name


def _swiglu_forwards(policy):
    """SwiGLU forward evaluations in one loss and backward of a remat
    model: the CPU backward (`_ref_bwd`) evaluates `_ref` once per layer
    too."""
    calls = [0]
    ref = t_sw._ref

    def counting(a, w):
        calls[0] += 1
        return ref(a, w)

    t_sw._ref = counting
    try:
        _loss_and_grads(_tiny(True), policy, _ids())
    finally:
        t_sw._ref = ref
    return calls[0]


def test_a_kept_output_is_not_computed_again():
    L = TL.llama_tiny().num_hidden_layers
    # forward + backward, plus the recompute where SwiGLU's output is not
    # kept (llama_swiglu is a MATMUL_CHECKPOINT_NAME, not a dot)
    assert _swiglu_forwards("save_matmul_outputs") == 2 * L
    assert _swiglu_forwards("nothing") == 3 * L
    assert _swiglu_forwards("dots") == 3 * L


def _held_bytes(model, policy, ids):
    """Bytes held for the backward once the forward is done: storages
    autograd saved outside the rematerialised layers (the parameters
    left out), plus the outputs the remat regions' sites kept."""
    params = {p.untyped_storage().data_ptr() for p in model.parameters()}
    saved = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in params:
            saved[st.data_ptr()] = st.nbytes()
        return t

    frames = []
    init = remat._Frame.__init__

    def recording_init(self, policy):
        init(self, policy)
        frames.append(self)

    gc.collect()
    with pytest.MonkeyPatch.context() as mp, \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), \
            core.remat_policy_guard(resolve_remat_policy(policy)):
        mp.setattr(remat._Frame, "__init__", recording_init)
        loss = model.loss(ids, ids)
        for t in (t for f in frames for t in f.kept):
            st = t.untyped_storage()
            saved[st.data_ptr()] = st.nbytes()
        held = sum(saved.values())
    loss.backward()
    return held


def test_policies_order_the_bytes_held_for_backward():
    ids = _ids(seq=64)
    held = {p: _held_bytes(_tiny(True), p, ids) for p in POLICIES}
    held["no remat"] = _held_bytes(_tiny(False), None, ids)
    assert held[None] == held["nothing"]
    assert (held["nothing"] < held["dots"] < held["save_matmul_outputs"]
            < held["no remat"]), held
    # save_matmul_outputs keeps, per layer, exactly the four named
    # outputs: qkv [T, 3h], attn_o [T, h], swiglu [T, m], down [T, h]
    cfg = TL.llama_tiny()
    T, h, m = ids.numel(), cfg.hidden_size, cfg.intermediate_size
    per_layer = 4 * T * (3 * h + h + m + h)
    assert (held["save_matmul_outputs"] - held["nothing"]
            == cfg.num_hidden_layers * per_layer)


def test_resolve_remat_policy():
    smo = resolve_remat_policy("save_matmul_outputs")
    assert all(smo(n) for n in TL.MATMUL_CHECKPOINT_NAMES)
    assert not smo("llama_o_proj")
    dots = resolve_remat_policy("dots")
    assert dots("llama_qkv") and dots("llama_mlp_down")
    assert dots("llama_q_proj") and not dots("llama_swiglu")
    for name in ("nothing", "recompute_all"):
        assert not any(resolve_remat_policy(name)(n)
                       for n in TL.DOT_CHECKPOINT_NAMES)
    assert resolve_remat_policy(None) is None
    pred = lambda n: n == "llama_attn_o"                       # noqa: E731
    assert resolve_remat_policy(pred) is pred
    with pytest.raises(ValueError, match="remat_policy"):
        resolve_remat_policy("everything")


def test_train_step_arms_the_policy_and_restores_it_after_a_failure():
    model = _tiny(True)
    opt = topt.AdamW(parameters=model.parameters())
    seen = []

    def failing_step(ids, labels):
        seen.append(core.current_remat_policy())
        raise RuntimeError("step_fn failed")

    step = TrainStep(model, opt, failing_step, remat_policy="dots")
    with pytest.raises(RuntimeError, match="step_fn failed"):
        step(_ids(), _ids())
    assert seen[0] is not None and seen[0]("llama_qkv")
    assert not seen[0]("llama_swiglu")
    assert core.current_remat_policy() is None
    assert all(p.grad is None for p in model.parameters())


def test_trainstep_trajectory_matches_reference_with_remat():
    """bench.py's optimizer (AdamW, lr 3e-4, weight decay 0.1), 5 steps
    with use_recompute=True under the default policy on both sides."""
    paddle.seed(2)
    jcfg = JL.llama_tiny(dtype="float32", use_recompute=True)
    jm = JL.LlamaForCausalLM(jcfg)
    np_state = {k: np.asarray(v.numpy()).astype(np.float32)
                for k, v in jm.state_dict().items()}
    tcfg = TL.llama_tiny(dtype="float32", use_recompute=True)
    tm = TL.LlamaForCausalLM(tcfg, device="cpu")
    tm.load_state_dict(state_from_jax(np_state, tcfg, "cpu"))
    ids = np.random.RandomState(9).randint(0, 1024, (2, 16))
    jo = jopt.AdamW(learning_rate=3e-4, parameters=jm.parameters(),
                    weight_decay=0.1)
    js = paddle.jit.TrainStep(jm, jo, lambda i, l: jm.loss(i, l))
    to = topt.AdamW(learning_rate=3e-4, parameters=tm.parameters(),
                    weight_decay=0.1)
    ts = TrainStep(tm, to, lambda i, l: tm.loss(i, l))
    jb = (paddle.to_tensor(ids), paddle.to_tensor(ids))
    tb = (torch.from_numpy(ids), torch.from_numpy(ids))
    j_losses = [float(js(*jb).numpy()) for _ in range(5)]
    t_losses = [ts(*tb).item() for _ in range(5)]
    assert t_losses[-1] < t_losses[0]
    np.testing.assert_allclose(t_losses, j_losses, rtol=TRAJ_RTOL)
    got = to_numpy(tm)
    for k, p in jm.state_dict().items():
        want = np.asarray(p.data, np.float64)
        err = np.linalg.norm(got[k] - want) / np.linalg.norm(want)
        assert err <= TRAJ_RTOL, (k, err)
    assert all(p.grad is None for p in tm.parameters())
