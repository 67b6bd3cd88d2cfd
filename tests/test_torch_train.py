"""Port training slice (paddle_tpu_torch: the LLaMA training forward and
loss, AdamW, TrainStep, and the kernels' plain versions with their
backwards) against the JAX package, in fp32 on the CPU. The same seeded
numpy inputs and weights (moved by `models.convert.state_from_jax`) go
through both; the JAX side runs as its own tests run it on the CPU: its
plain references, `_sdpa` for causal MHA attention, and the splash
kernel in interpret mode (`_splash_gqa(..., interpret=True)`) for GQA
and full attention. The CUDA kernels themselves are held against these
plain versions by tests/test_torch_cuda.py and chip_smoke.py on the
card."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
import paddle_tpu_torch as ptt
from paddle_tpu.kernels import flash_attention as j_fa
from paddle_tpu.kernels import fused_norm_residual as j_fnr
from paddle_tpu.kernels import rms_norm as j_rms
from paddle_tpu.kernels import swiglu as j_sw
from paddle_tpu.models import llama as JL
from paddle_tpu.models.llama import _sdpa as j_sdpa
from paddle_tpu_torch import amp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.kernels import flash_attention as t_fa
from paddle_tpu_torch.kernels import fused_norm_residual as t_fnr
from paddle_tpu_torch.kernels import rms_norm as t_rms
from paddle_tpu_torch.kernels import swiglu as t_sw
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models.convert import state_from_jax, to_numpy
from paddle_tpu_torch.nn.functional import (cross_entropy,
                                            scaled_dot_product_attention)

from _torch_threads import one_torch_thread  # noqa: F401,E402

# fp32 on both sides; the port's plain versions repeat the reference's
# float order, so differences are summation order (BLAS blocking,
# reduction trees): a few f32 ulps per value, amplified through a
# backward or a model by cancellation. Limits, as max|a - b| / max|b|:
KERNEL_RTOL = 1e-5      # one kernel, forward and backward
LOSS_RTOL = 1e-5        # model loss
GRAD_RTOL = 1e-4        # every parameter's grad through 2 layers
TRAJ_RTOL = 1e-5        # one optimizer step; 5-step losses and weights


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


def _max_rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _launch_counts():
    return (t_rms.rms_norm.launches, t_fnr.fused_add_rms_norm.launches,
            t_sw.swiglu.launches, t_sw.swiglu_bwd_da.launches,
            t_sw.swiglu_bwd_dw.launches, t_fa.flash_attention_fwd.launches,
            t_fa.flash_attention_bwd.launches)


# ------------------------------------------------------------- kernels


def test_rms_norm_forward_and_backward():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 256).astype(np.float32)
    w = (1 + 0.1 * rng.randn(256)).astype(np.float32)
    g = rng.randn(3, 5, 256).astype(np.float32)
    y_j, vjp = jax.vjp(lambda a, b: j_rms.rms_norm(a, b, 1e-5),
                       jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(g))
    xt, wt = _t(x, True), _t(w, True)
    y = t_rms.rms_norm(xt, wt, 1e-5)
    y.backward(_t(g))
    assert _max_rel(y.detach(), y_j) <= KERNEL_RTOL
    assert _max_rel(xt.grad, dx_j) <= KERNEL_RTOL
    assert _max_rel(wt.grad, dw_j) <= KERNEL_RTOL
    assert wt.grad.dtype == torch.float32


def test_fused_add_rms_norm_forward_and_backward():
    rng = np.random.RandomState(1)
    x, r, gy, gh = (rng.randn(2, 7, 256).astype(np.float32)
                    for _ in range(4))
    w = (1 + 0.1 * rng.randn(256)).astype(np.float32)
    (y_j, h_j), vjp = jax.vjp(
        lambda a, b, c: j_fnr.fused_add_rms_norm(a, b, c, 1e-5),
        jnp.asarray(x), jnp.asarray(r), jnp.asarray(w))
    dx_j, dr_j, dw_j = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    xt, rt, wt = _t(x, True), _t(r, True), _t(w, True)
    y, h = t_fnr.fused_add_rms_norm(xt, rt, wt, 1e-5)
    torch.autograd.backward((y, h), (_t(gy), _t(gh)))
    for got, want in ((y.detach(), y_j), (h.detach(), h_j),
                      (xt.grad, dx_j), (rt.grad, dr_j), (wt.grad, dw_j)):
        assert _max_rel(got, want) <= KERNEL_RTOL


@pytest.mark.parametrize("M,interpret", [(384, False), (384, True),
                                         (688, False)],
                         ids=["ref", "pallas_interpret", "ragged_m688"])
def test_swiglu_backward(M, interpret):
    rng = np.random.RandomState(2)
    H = 256
    a = rng.randn(12, H).astype(np.float32)
    w = (0.05 * rng.randn(H, 2 * M)).astype(np.float32)
    g = rng.randn(12, M).astype(np.float32)
    y_j, vjp = jax.vjp(lambda p, q: j_sw.swiglu(p, q, use_pallas=interpret),
                       jnp.asarray(a), jnp.asarray(w))
    da_j, dw_j = vjp(jnp.asarray(g))
    at, wt = _t(a, True), _t(w, True)
    y = t_sw.swiglu(at, wt)
    y.backward(_t(g))
    assert _max_rel(y.detach(), y_j) <= KERNEL_RTOL
    assert _max_rel(at.grad, da_j) <= KERNEL_RTOL
    assert _max_rel(wt.grad, dw_j) <= KERNEL_RTOL
    da_p, dw_p = t_sw._ref_bwd(_t(a), _t(w), _t(g))   # chip_smoke's plain
    assert _max_rel(da_p, da_j) <= KERNEL_RTOL
    assert _max_rel(dw_p, dw_j) <= KERNEL_RTOL


@pytest.mark.parametrize("hq,hk,d,causal", [
    (4, 4, 64, True), (2, 2, 128, True), (4, 4, 64, False),
    (4, 2, 64, True), (4, 1, 128, False)],
    ids=["mha_causal_d64", "mha_causal_d128", "mha_full_d64",
         "gqa_causal_d64", "mqa_full_d128"])
def test_flash_attention_forward_and_backward(hq, hk, d, causal):
    """Causal MHA against the reference's `_sdpa` (its CPU route); GQA
    and full attention against the splash kernel in interpret mode (the
    route the reference's GQA takes on the TPU; `_sdpa` has no full
    mask)."""
    rng = np.random.RandomState(3)
    B, S = 1, 128
    q = rng.randn(B, S, hq, d).astype(np.float32)
    k = rng.randn(B, S, hk, d).astype(np.float32)
    v = rng.randn(B, S, hk, d).astype(np.float32)
    do = rng.randn(B, S, hq, d).astype(np.float32)
    scale = 1.0 / np.sqrt(d)

    def ref(q_, k_, v_):
        if hq == hk and causal:
            return j_sdpa(q_, k_, v_)
        qt, kt, vt = (jnp.swapaxes(t, 1, 2) for t in (q_, k_, v_))
        o = j_fa._splash_gqa(qt, kt, vt, causal, scale, None,
                             interpret=True)
        return jnp.swapaxes(o, 1, 2)

    o_j, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_j = vjp(jnp.asarray(do))
    qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
    o = t_fa.flash_attention_bshd(qt, kt, vt, causal=causal)
    o.backward(_t(do))
    assert _max_rel(o.detach(), o_j) <= KERNEL_RTOL
    for got, want in zip((qt.grad, kt.grad, vt.grad), grads_j):
        assert _max_rel(got, want) <= KERNEL_RTOL


def test_cross_entropy_matches_reference():
    import paddle_tpu.nn.functional as JF
    rng = np.random.RandomState(4)
    logits = rng.randn(10, 50).astype(np.float32)
    labels = rng.randint(0, 50, 10).astype(np.int64)
    labels[[2, 7]] = -100
    want = float(JF.cross_entropy(paddle.to_tensor(logits),
                                  paddle.to_tensor(labels)).numpy())
    got = cross_entropy(_t(logits), torch.from_numpy(labels)).item()
    assert abs(got - want) <= KERNEL_RTOL * abs(want)


# --------------------------------------------------------------- model


def _models(fused=True, gqa=False, seed=0):
    kw = dict(use_recompute=False, fuse_attention_qkv=fused, fuse_mlp=fused)
    if gqa:
        kw["num_key_value_heads"] = 2
    paddle.seed(seed)
    jcfg = JL.llama_tiny(dtype="float32", **kw)
    jm = JL.LlamaForCausalLM(jcfg)
    np_state = {k: np.asarray(v.numpy()).astype(np.float32)
                for k, v in jm.state_dict().items()}
    tcfg = TL.llama_tiny(dtype="float32", **kw)
    tm = TL.LlamaForCausalLM(tcfg, device="cpu")
    tm.load_state_dict(state_from_jax(np_state, tcfg, "cpu"))
    return jm, tm


def _ids(seed=3, batch=2, seq=24):
    return np.random.RandomState(seed).randint(0, 1024, (batch, seq))


@pytest.mark.parametrize("flag", [True, False], ids=["fused", "unfused"])
def test_model_loss_and_every_grad(flag):
    ptt.set_flags({"FLAGS_fused_transformer": flag})
    paddle.set_flags({"FLAGS_fused_transformer": flag})
    try:
        jm, tm = _models()
        ids = _ids()
        jl = jm.loss(paddle.to_tensor(ids), paddle.to_tensor(ids))
        jl.backward()
        jgrads = {k: np.asarray(p.grad.data)
                  for k, p in jm.state_dict().items()
                  if getattr(p, "grad", None) is not None}
        before = _launch_counts()
        tl = tm.loss(torch.from_numpy(ids), torch.from_numpy(ids))
        tl.backward()
    finally:
        ptt.set_flags({"FLAGS_fused_transformer": True})
        paddle.set_flags({"FLAGS_fused_transformer": True})
    assert _launch_counts() == before       # the CPU never launches
    assert abs(tl.item() - float(jl.numpy())) <= LOSS_RTOL * abs(
        float(jl.numpy()))
    tgrads = to_numpy(tm, grads=True)
    assert sorted(tgrads) == sorted(jgrads) and len(tgrads) == 15
    for k in jgrads:
        assert _max_rel(tgrads[k], jgrads[k]) <= GRAD_RTOL, k
    assert tm.model.norm.weight.grad.dtype == torch.float32


def test_gqa_model_loss_and_grads():
    jm, tm = _models(gqa=True, seed=1)
    ids = _ids(seed=5, seq=16)
    jl = jm.loss(paddle.to_tensor(ids), paddle.to_tensor(ids))
    jl.backward()
    tl = tm.loss(torch.from_numpy(ids), torch.from_numpy(ids))
    tl.backward()
    assert abs(tl.item() - float(jl.numpy())) <= LOSS_RTOL * abs(
        float(jl.numpy()))
    tgrads = to_numpy(tm, grads=True)
    for k, p in jm.state_dict().items():
        assert _max_rel(tgrads[k], np.asarray(p.grad.data)) <= GRAD_RTOL, k


# ----------------------------------------------------- optimizer, step


def test_adamw_one_step_matches_reference():
    rng = np.random.RandomState(6)
    shapes = [(8, 16), (16,), (3, 4, 5), (32,)]
    ws = [rng.randn(*s).astype(np.float32) for s in shapes]
    gs = [rng.randn(*s).astype(np.float32) for s in shapes]
    jps = [paddle.create_parameter(list(s), "float32") for s in shapes]
    for p, w, g in zip(jps, ws, gs):
        p.data = jnp.asarray(w)
        p.grad = paddle.to_tensor(g)
    jo = jopt.AdamW(learning_rate=3e-3, parameters=jps, weight_decay=0.1)
    jo.step()
    tps = [torch.nn.Parameter(_t(w)) for w in ws]
    for p, g in zip(tps, gs):
        p.grad = _t(g)
    to = topt.AdamW(learning_rate=3e-3, parameters=tps, weight_decay=0.1)
    to.step()
    for tp, jp in zip(tps, jps):
        assert _max_rel(tp.detach(), jp.data) <= TRAJ_RTOL
    sd = to.state_dict()
    assert sd["@step"] == 1 and sd["0.moment1"].dtype == torch.float32
    to2 = topt.AdamW(learning_rate=3e-3, parameters=tps, weight_decay=0.1)
    to2.set_state_dict(sd)
    assert to2._step_count == 1
    assert torch.equal(to2._state[(2, "moment2")], to._state[(2, "moment2")])


def test_adam_l2_one_step_matches_reference():
    rng = np.random.RandomState(7)
    w = rng.randn(6, 5).astype(np.float32)
    g = rng.randn(6, 5).astype(np.float32)
    jp = paddle.create_parameter([6, 5], "float32")
    jp.data = jnp.asarray(w)
    jp.grad = paddle.to_tensor(g)
    jopt.Adam(learning_rate=1e-2, parameters=[jp], weight_decay=0.05).step()
    tp = torch.nn.Parameter(_t(w))
    tp.grad = _t(g)
    topt.Adam(learning_rate=1e-2, parameters=[tp], weight_decay=0.05).step()
    assert _max_rel(tp.detach(), jp.data) <= TRAJ_RTOL


def test_trainstep_five_step_trajectory():
    """bench.py's optimizer (AdamW, lr 3e-4, weight decay 0.1). The final
    weights are compared by relative L2 error per tensor: Adam's first
    steps move a weight by about lr * g / (|g| + eps), so for the few
    elements per tensor whose grad is ~1e-9 the f32 summation-order
    error of the grad (~1e-8 here) changes that one move by a good part
    of lr, while the tensor as a whole stays within the limit."""
    jm, tm = _models(seed=2)
    ids = _ids(seed=9, seq=16)
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


# ------------------------------------------------- what is not ported


def _tiny_cpu(**kw):
    return TL.LlamaForCausalLM(TL.llama_tiny(dtype="float32", **kw),
                               device="cpu")


def _meta(*shape):
    # a tensor that is not on the CPU, without a card: the device checks
    # run before any arithmetic
    return torch.empty(shape, device="meta")


@pytest.mark.parametrize("knob", ["shard", "amp_auto_cast",
                                  "flash_padding_mask", "flash_bias",
                                  "dense_attention_on_card"])
def test_unported_training_knobs_raise(knob):
    """Each knob still to port raises. The bias route's dropout in
    training is ported (the reference's dense route with an output
    dropout), so that case runs. Loss scaling, gradient accumulation, LR
    schedulers and master weights are ported (tests/test_torch_amp.py,
    test_torch_optimizers.py, test_torch_lr.py)."""
    m = _tiny_cpu(use_recompute=False)
    opt = topt.AdamW(parameters=m.parameters())
    if knob == "flash_bias":
        q = torch.ones(1, 8, 2, 64)
        out = scaled_dot_product_attention(
            q, q, q, attn_mask=torch.zeros(1, 2, 8, 8), dropout_p=0.1)
        assert out.shape == q.shape and torch.isfinite(out).all()
        return
    with pytest.raises(NotImplementedError, match="not ported|port does"):
        if knob == "shard":
            TrainStep(m, opt, m.loss, shard=object())
        elif knob == "amp_auto_cast":
            with amp.auto_cast():
                m.loss(torch.zeros(1, 4, dtype=torch.long),
                       torch.zeros(1, 4, dtype=torch.long))
        elif knob == "flash_padding_mask":
            # padding masks are ported; causal with q and kv lengths that
            # differ is not
            q, kv = torch.zeros(1, 8, 2, 64), torch.zeros(1, 12, 2, 64)
            t_fa.flash_attention_bshd(q, kv, kv, causal=True,
                                      padding_mask=torch.ones(1, 12))
        elif knob == "dense_attention_on_card":
            ptt.set_flags({"FLAGS_use_flash_attention": False})
            try:
                TL._attention_core(_meta(1, 8, 2, 64), _meta(1, 8, 2, 64),
                                   _meta(1, 8, 2, 64))
            finally:
                ptt.set_flags({"FLAGS_use_flash_attention": True})


def test_unknown_remat_policy_is_a_value_error():
    m = _tiny_cpu(use_recompute=False)
    with pytest.raises(ValueError, match="remat_policy"):
        TrainStep(m, topt.AdamW(parameters=m.parameters()), m.loss,
                  remat_policy="bogus")


def test_fused_ce_flag_keeps_the_plain_route_on_cpu():
    """As in the reference, the flag is a no-op off the accelerator."""
    rng = np.random.RandomState(8)
    logits = _t(rng.randn(6, 40))
    labels = torch.from_numpy(rng.randint(0, 40, 6))
    want = cross_entropy(logits, labels)
    ptt.set_flags({"FLAGS_use_fused_ce": True})
    try:
        got = cross_entropy(logits, labels)
    finally:
        ptt.set_flags({"FLAGS_use_fused_ce": False})
    assert torch.equal(got, want)


# ------------------------------------------------------------ the flags


def _reference_flag_table():
    """The reference's flag table as its source states it (names and
    defaults of paddle_tpu/framework/core.py's `_flags`), read without
    the values other tests may have set at run time."""
    import ast
    import inspect

    from paddle_tpu.framework import core as jcore
    src = inspect.getsource(jcore)
    at = src.index("_flags: dict = {")
    end = src.index("\n}\n", at) + 2
    return ast.literal_eval(src[at + len("_flags: dict = "):end].strip())


def test_port_keeps_a_copy_of_the_reference_flag_table():
    from paddle_tpu_torch.framework import core as tcore
    assert tcore._REFERENCE_FLAGS == _reference_flag_table()


def test_every_reference_flag_is_registered_or_refused():
    """Each name of the reference's flag table (and any the reference
    holds at run time) is either registered in the port, and set_flags
    takes it, or refused by set_flags with NotImplementedError naming
    it; a refused call sets nothing."""
    from paddle_tpu.framework import core as jcore
    from paddle_tpu_torch.framework import core as tcore
    names = set(_reference_flag_table()) | set(jcore._flags)
    registered = dict(tcore._flags)
    refused = []
    for name in sorted(names):
        value = _reference_flag_table().get(name, jcore._flags.get(name))
        if name in registered:
            ptt.set_flags({name: registered[name]})
            continue
        with pytest.raises(NotImplementedError, match=f"{name} is not "
                                                      "ported"):
            ptt.set_flags({"FLAGS_use_fused_ce": True, name: value})
        refused.append(name)
    assert tcore._flags == registered
    assert {"FLAGS_check_nan_inf", "FLAGS_benchmark",
            "FLAGS_log_memory_stats"} <= set(registered)
    assert "FLAGS_gemm_use_half_precision_compute_type" in refused
    assert {"FLAGS_fault_inject", "FLAGS_metrics",
            "FLAGS_serving_slo"} <= set(registered)
    assert {"FLAGS_metrics_port", "FLAGS_flight_recorder",
            "FLAGS_span_ring_size", "FLAGS_request_trace",
            "FLAGS_request_trace_sink"} <= set(registered)
    assert {"FLAGS_metrics_snapshot", "FLAGS_metrics_snapshot_interval",
            "FLAGS_lock_witness"} <= set(refused)
    with pytest.raises(NotImplementedError, match="FLAGS_no_such_flag"):
        ptt.set_flags({"FLAGS_no_such_flag": 1})


@pytest.mark.parametrize("env,raises", [
    (("FLAGS_gemm_use_half_precision_compute_type", "0"), True),
    (("FLAGS_metrics", "1"), False),
    (("FLAGS_metrics_port", "9100"), False),
    (("FLAGS_metrics_snapshot", "snap.json"), True),
    (("FLAGS_lock_witness", "1"), True),
    (("FLAGS_comm_timeout", "30"), True),
    (("FLAGS_gemm_use_half_precision_compute_type", "1"), False),
    (("FLAGS_comm_timeout", "1800"), False),
    (("FLAGS_check_nan_inf", "1"), False),
    (("FLAGS_no_such_flag", "1"), False)],
    ids=["tf32_off", "metrics_on", "metrics_port", "metrics_snapshot",
         "lock_witness", "comm_timeout_30", "tf32_default",
         "comm_timeout_default", "registered", "not_a_reference_flag"])
def test_env_flags_checked_at_construction(monkeypatch, env, raises):
    """An unported reference flag in the environment at a value other
    than the reference's default raises when TrainStep or the serving
    engine is built (not at import); its default, a registered flag and
    a name the reference does not know pass."""
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    monkeypatch.setenv(*env)
    m = _tiny_cpu(use_recompute=False)
    opt = topt.AdamW(parameters=m.parameters())
    for build in (lambda: TrainStep(m, opt, m.loss),
                  lambda: ContinuousBatchingEngine(m, max_batch=1,
                                                   max_seq=32,
                                                   device="cpu")):
        if raises:
            with pytest.raises(NotImplementedError, match=env[0]):
                build()
        else:
            build()


def _set_both(flags):
    ptt.set_flags(flags)
    paddle.set_flags(flags)


def test_check_nan_inf_raises_in_both_packages():
    """FLAGS_check_nan_inf=1: a llama_tiny TrainStep whose loss is not
    finite raises FloatingPointError with the reference's message in
    both packages; a finite step does not."""
    jm, tm = _models(seed=4)
    ids = _ids(seed=5, seq=16)
    jb = (paddle.to_tensor(ids), paddle.to_tensor(ids))
    tb = (torch.from_numpy(ids), torch.from_numpy(ids))
    _set_both({"FLAGS_check_nan_inf": True})
    try:
        for scale in (1.0, float("nan")):
            js = paddle.jit.TrainStep(
                jm, jopt.AdamW(parameters=jm.parameters()),
                lambda i, l: jm.loss(i, l) * scale)
            ts = TrainStep(tm, topt.AdamW(parameters=tm.parameters()),
                           lambda i, l: tm.loss(i, l) * scale)
            for step, batch in ((js, jb), (ts, tb)):
                if scale == 1.0:
                    step(*batch)
                else:
                    with pytest.raises(FloatingPointError,
                                       match=r"NaN or Inf in TrainStep loss "
                                             r"\(FLAGS_check_nan_inf\)"):
                        step(*batch)
    finally:
        _set_both({"FLAGS_check_nan_inf": False})


def test_check_nan_inf_names_non_finite_parameters():
    """A finite loss with a non-finite updated parameter: the parameter
    is named, as the reference names it."""
    model = torch.nn.Module()
    model.w = torch.nn.Parameter(torch.ones(3))
    model.unused = torch.nn.Parameter(torch.full((2,), float("inf")))
    ts = TrainStep(model, topt.AdamW(parameters=[model.w]),
                   lambda x: (model.w * x).sum())
    ptt.set_flags({"FLAGS_check_nan_inf": True})
    try:
        with pytest.raises(FloatingPointError,
                           match=r"NaN or Inf in updated parameters "
                                 r"\['unused'\] \(FLAGS_check_nan_inf\)"):
            ts(torch.ones(3))
    finally:
        ptt.set_flags({"FLAGS_check_nan_inf": False})


def test_benchmark_flag_prints_one_line_per_step(capsys):
    """FLAGS_benchmark=1: one stderr line a step, "TrainStep[n]: t ms",
    with the same step numbers in both packages; FLAGS_log_memory_stats=1
    prints nothing on the CPU in either."""
    jm, tm = _models(seed=6)
    ids = _ids(seed=7, seq=16)
    js = paddle.jit.TrainStep(jm, jopt.AdamW(parameters=jm.parameters()),
                              lambda i, l: jm.loss(i, l))
    ts = TrainStep(tm, topt.AdamW(parameters=tm.parameters()),
                   lambda i, l: tm.loss(i, l))
    _set_both({"FLAGS_benchmark": True, "FLAGS_log_memory_stats": True})
    try:
        lines = {}
        for who, step, batch in (
                ("jax", js, (paddle.to_tensor(ids), paddle.to_tensor(ids))),
                ("torch", ts, (torch.from_numpy(ids),
                               torch.from_numpy(ids)))):
            capsys.readouterr()
            for _ in range(3):
                step(*batch)
            lines[who] = capsys.readouterr().err.splitlines()
    finally:
        _set_both({"FLAGS_benchmark": False,
                   "FLAGS_log_memory_stats": False})
    import re
    pat = re.compile(r"^TrainStep\[(\d+)\]: \d+\.\d\d ms$")
    for who, got in lines.items():
        steps = [pat.match(ln) for ln in got if ln.startswith("TrainStep")]
        assert len(steps) == 3 and all(steps), (who, got)
        lines[who] = [int(m.group(1)) for m in steps]
    assert lines["torch"] == lines["jax"] == [1, 2, 3]
