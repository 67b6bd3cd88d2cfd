"""The port's amp (O2 `decorate`, `GradScaler`) and `TrainStep(scaler=,
accumulate_steps=)` against the JAX package on the CPU, with the two
differences by design of the port's `Optimizer.prime` shown on the
reference.

- O2: llama_tiny built f32 in both packages and decorated to bf16 (its
  RMSNorm weights too, with f32 masters): the port's scaled trajectory
  (GradScaler, a power-of-two scale, which unscales exactly) is bitwise
  its own unscaled trajectory, and within bf16 limits of the reference's
  unscaled O2 trajectory (the reference's scaler decays the moments each
  step: see `test_reference_scaler_decays_moments_the_port_does_not`).
- A skipped step (non-finite grad): parameters and scale equal to the
  reference's; the port's masters and moments bitwise their values
  before the step.
- accumulate_steps=2: the f32 trajectory within TRAJ_RTOL, the
  reference's float order (grads summed in the parameter's dtype, scaled
  by 1/k, loss the mean of the f32 micro-losses). As in
  test_torch_encoder_train, an element whose first grad is at summation
  noise (|g| <= NOISE_GRAD) moves by up to lr a step on that noise's
  sign: those are held to Adam's bound, 2 lr a step, the rest of each
  tensor to TRAJ_RTOL by relative L2."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
import paddle_tpu.optimizer as jopt
from paddle_tpu.models import llama as JL
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import observability as t_obs
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models.convert import state_from_jax, to_numpy
from paddle_tpu_torch.observability import metrics as t_metrics

from _torch_threads import one_torch_thread  # noqa: F401,E402

TRAJ_RTOL = 1e-5
NOISE_GRAD = 1e-6
# bf16 O2, port against reference: both run the model in bf16, whose
# roundings differ between the packages' op orders. The first loss read
# 6.8e-8 and the later ones up to 1.4e-4 relative; the f32 masters, moved
# by Adam about lr an element a step wherever bf16 noise flips a moment's
# sign, read up to 6.3e-3 relative L2 a tensor after 3 steps.
O2_LOSS_RTOL = 1e-3
O2_MASTER_RL2 = 1.5e-2



def _models(seed):
    kw = dict(use_recompute=False)
    paddle.seed(seed)
    jm = JL.LlamaForCausalLM(JL.llama_tiny(dtype="float32", **kw))
    np_state = {k: np.asarray(v.numpy()).astype(np.float32)
                for k, v in jm.state_dict().items()}
    tcfg = TL.llama_tiny(dtype="float32", **kw)
    tm = TL.LlamaForCausalLM(tcfg, device="cpu")
    tm.load_state_dict(state_from_jax(np_state, tcfg, "cpu"))
    return jm, tm


def _port_model(seed):
    """llama_tiny f32 in the port alone, for the port-only tests."""
    return TL.LlamaForCausalLM(TL.llama_tiny(dtype="float32",
                                             use_recompute=False),
                               device="cpu",
                               generator=torch.Generator().manual_seed(seed))


def _rel_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _by_name(jm, tm, jo, to, which):
    """{name: (port f32 numpy, reference f32 numpy)} of the masters."""
    jname = {id(t): k for k, t in jm.state_dict().items()}
    tidx = {id(p): i for i, p in enumerate(to._parameter_list)}
    out = {}
    for pid, v in getattr(jo, which).items():
        k = jname[pid]
        p = dict(tm.named_parameters())[k]
        out[k] = (getattr(to, which)[tidx[id(p)]].numpy(),
                  np.asarray(v.astype(jnp.float32)))
    return out


def test_decorate_o2_casts_like_the_reference():
    """Every floating parameter but LayerNorm's becomes bf16 (LLaMA's
    RMSNorm weights included), each with an f32 master equal to its
    value before the cast; O1 leaves the model as it is."""
    tm = _port_model(seed=1)
    before = {k: p.detach().clone() for k, p in tm.named_parameters()}
    to = topt.AdamW(parameters=tm.parameters())
    m, o = tamp.decorate(tm, to, level="O2", dtype="bfloat16")
    assert m is tm and o is to
    assert {p.dtype for p in tm.parameters()} == {torch.bfloat16}
    assert len(to._master_weights) == len(before)
    for i, (k, p) in enumerate(tm.named_parameters()):
        assert to._master_weights[i].dtype == torch.float32
        assert torch.equal(to._master_weights[i], before[k])
        assert torch.equal(p.float(), before[k].bfloat16().float())
    # LayerNorm keeps f32 and gets no master; an excluded layer likewise
    class THead(tnn.Linear):
        pass

    class JHead(paddle.nn.Linear):
        pass

    net = torch.nn.Sequential(tnn.Linear(4, 4, device="cpu"),
                              tnn.LayerNorm(4, device="cpu"),
                              THead(4, 2, device="cpu"))
    opt = topt.SGD(parameters=net.parameters())
    tamp.decorate(net, opt, level="O2", excluded_layers=[THead])
    assert [p.dtype for p in net.parameters()] == [
        torch.bfloat16, torch.bfloat16] + [torch.float32] * 4
    assert sorted(opt._master_weights) == [0, 1]
    jnet = paddle.nn.Sequential(paddle.nn.Linear(4, 4),
                                paddle.nn.LayerNorm(4), JHead(4, 2))
    jopt_ = jopt.SGD(parameters=jnet.parameters())
    jamp.decorate(jnet, jopt_, level="O2", excluded_layers=[JHead])
    assert [str(p.dtype) for p in jnet.parameters()] == [
        "bfloat16", "bfloat16"] + ["float32"] * 4
    assert len(jopt_._master_weights) == 2
    net1 = torch.nn.Sequential(tnn.Linear(4, 4, device="cpu"))
    assert tamp.decorate(net1, level="O1") is net1
    assert next(net1.parameters()).dtype == torch.float32


def test_o2_scaler_trajectory():
    """O2 bf16 AdamW, 3 steps: the port with a GradScaler (2**10) is
    bitwise the port without one, and within the O2 limits of the
    reference's unscaled trajectory; moments are f32 on the masters."""
    ids = np.random.RandomState(9).randint(0, 1024, (2, 16))
    tb = (torch.from_numpy(ids), torch.from_numpy(ids))
    runs = {}
    for scaled in (True, False):
        jm, tm = _models(seed=3)
        to = topt.AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                        weight_decay=0.1)
        tamp.decorate(tm, to, level="O2", dtype="bfloat16")
        scaler = (tamp.GradScaler(init_loss_scaling=2.0 ** 10)
                  if scaled else None)
        ts = TrainStep(tm, to, lambda i, l: tm.loss(i, l), scaler=scaler)
        losses = [ts(*tb).float().item() for _ in range(3)]
        runs[scaled] = (losses, tm, to, scaler)
    (l_s, tm, to, scaler), (l_u, tm_u, to_u, _) = runs[True], runs[False]
    assert l_s == l_u and l_s[-1] < l_s[0]
    assert scaler.state_dict()["scale"] == 2.0 ** 10
    assert all(torch.equal(a, b) for a, b in zip(tm.parameters(),
                                                 tm_u.parameters()))
    assert all(torch.equal(to._state[k], to_u._state[k]) for k in to._state)
    assert all(torch.equal(to._master_weights[k], to_u._master_weights[k])
               for k in to._master_weights)
    assert {v.dtype for v in to._state.values()} == {torch.float32}

    jo = jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters(),
                    weight_decay=0.1)
    jamp.decorate(jm, jo, level="O2", dtype="bfloat16")
    js = paddle.jit.TrainStep(jm, jo, lambda i, l: jm.loss(i, l))
    jb = (paddle.to_tensor(ids), paddle.to_tensor(ids))
    l_j = [float(js(*jb).astype("float32").numpy()) for _ in range(3)]
    np.testing.assert_allclose(l_s, l_j, rtol=O2_LOSS_RTOL)
    masters = _by_name(jm, tm, jo, to, "_master_weights")
    assert len(masters) == len(to._master_weights)
    for k, (got, want) in masters.items():
        assert _rel_l2(got, want) <= O2_MASTER_RL2, k
    for k, p in tm.named_parameters():
        assert p.dtype == torch.bfloat16


def _raw(seed, shapes=((6, 5), (7,))):
    rng = np.random.RandomState(seed)
    ws = [rng.randn(*s).astype(np.float32) for s in shapes]
    jps = []
    for s, w in zip(shapes, ws):
        jp = paddle.create_parameter(list(s), "float32")
        jp.data = jnp.asarray(w)
        jps.append(jp)
    tps = [torch.nn.Parameter(torch.from_numpy(w.copy())) for w in ws]
    return jps, tps


def _scale_of(s):
    return s.state_dict()["scale"]


def test_scaler_skip_matches_reference_on_params_and_scale():
    """Step 1 finite (the scale grows: incr_every_n_steps=1), step 2 with
    an inf in one grad: both packages keep every parameter, halve the
    scale and count @step; the port's moments stay bitwise as they were
    (the reference's are decayed by its prime)."""
    jps, tps = _raw(seed=4)
    kw = dict(init_loss_scaling=2.0 ** 8, incr_every_n_steps=1)
    js, ts = jamp.GradScaler(**kw), tamp.GradScaler(**kw)
    jo = jopt.AdamW(learning_rate=0.01, parameters=jps)
    to = topt.AdamW(learning_rate=0.01, parameters=tps)
    rng = np.random.RandomState(5)
    for step in (1, 2):
        scale = _scale_of(ts)
        assert scale == _scale_of(js)
        for jp, tp in zip(jps, tps):
            g = rng.randn(*tp.shape).astype(np.float32) * scale
            if step == 2 and tp.dim() == 1:
                g[3] = np.inf
            jp.grad = paddle.to_tensor(g)
            tp.grad = torch.from_numpy(g)
        before = [p.detach().clone() for p in tps]
        state_before = dict(to._state)
        js.step(jo)
        js.update()
        ts.step(to)
        ts.update()
        for jp, tp in zip(jps, tps):
            assert np.abs(tp.detach().numpy() - np.asarray(jp.data)).max() \
                <= TRAJ_RTOL * np.abs(np.asarray(jp.data)).max()
        assert ts.state_dict() == js.state_dict()
        assert to._step_count == jo._step_count == step
    assert _scale_of(ts) == 2.0 ** 8            # grew to 2**9, halved
    assert all(torch.equal(a, b) for a, b in zip(before, tps))
    assert all(torch.equal(to._state[k], state_before[k])
               for k in state_before)


def test_scaler_skip_keeps_masters_bitwise():
    """Under O2 a skipped step leaves bf16 parameters, f32 masters and
    f32 moments bitwise, with no host read (the flag stays on the
    tensors' device)."""
    tm = _port_model(seed=6)
    to = topt.Adam(learning_rate=1e-3, parameters=tm.parameters(),
                   amsgrad=True, grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    tamp.decorate(tm, to, level="O2")
    scaler = tamp.GradScaler(init_loss_scaling=2.0 ** 12)
    ts = TrainStep(tm, to, lambda i, l: tm.loss(i, l), scaler=scaler)
    ids = torch.from_numpy(np.random.RandomState(7).randint(0, 1024, (2, 8)))
    ts(ids, ids)
    snap = ([p.detach().clone() for p in tm.parameters()],
            {k: v.clone() for k, v in to._master_weights.items()},
            {k: v.clone() for k, v in to._state.items()})
    w = tm.model.layers[0].self_attn.o_proj
    hook = w.register_hook(lambda g: g * float("inf"))
    ts(ids, ids)
    hook.remove()
    assert all(torch.equal(a, b) for a, b in zip(snap[0], tm.parameters()))
    assert all(torch.equal(snap[1][k], v)
               for k, v in to._master_weights.items())
    assert all(torch.equal(snap[2][k], v) for k, v in to._state.items())
    assert to._step_count == 2 and _scale_of(scaler) == 2.0 ** 11
    ts(ids, ids)
    assert not torch.equal(snap[0][0], next(tm.parameters()))


def test_reference_scaler_decays_moments_the_port_does_not():
    """Difference by design: the reference's GradScaler.step primes the
    optimizer every step, and its prime runs the update with a zero grad,
    so each scaled Adam step first decays the moments (lr 0.1, grad 0.5,
    scale 1, 3 steps: moment1 0.12330 against 0.13550 unscaled). The
    port's prime changes no existing accumulator: its scaled run equals
    the reference's unscaled one."""
    def ref(scaled):
        p = paddle.create_parameter([1], "float32")
        p.data = jnp.ones((1,), jnp.float32)
        o = jopt.Adam(learning_rate=0.1, parameters=[p])
        s = jamp.GradScaler(init_loss_scaling=1.0)
        for _ in range(3):
            p.grad = paddle.to_tensor(np.full((1,), 0.5, np.float32))
            if scaled:
                s.step(o)
                s.update()
            else:
                o.step()
        return (float(np.asarray(o._state[(id(p), "moment1")])[0]),
                float(np.asarray(p.data)[0]))

    def port(scaled):
        p = torch.nn.Parameter(torch.ones(1))
        o = topt.Adam(learning_rate=0.1, parameters=[p])
        s = tamp.GradScaler(init_loss_scaling=1.0)
        for _ in range(3):
            p.grad = torch.full((1,), 0.5)
            if scaled:
                s.step(o)
                s.update()
            else:
                o.step()
        return o._state[(0, "moment1")].item(), p.item()

    (jm_s, jw_s), (jm_u, jw_u) = ref(True), ref(False)
    assert jm_s == pytest.approx(0.12330, abs=5e-6)
    assert jm_u == pytest.approx(0.13550, abs=5e-6)
    assert jw_s == pytest.approx(0.71367, abs=5e-6)
    assert jw_u == pytest.approx(0.70000, abs=5e-6)
    for scaled in (True, False):
        m, w = port(scaled)
        assert m == pytest.approx(jm_u, rel=TRAJ_RTOL)
        assert w == pytest.approx(jw_u, rel=TRAJ_RTOL)


def test_reference_prime_starts_rprop_at_the_range_bottom():
    """Difference by design: the reference's prime (run once before a
    TrainStep's first step) runs Rprop with lr 0, which clips its step
    sizes to learning_rate_range[0]; the port's prime starts them at the
    learning rate, as a first step without prime does."""
    jps, tps = _raw(seed=8)
    jo = jopt.Rprop(learning_rate=0.01, parameters=jps)
    to = topt.Rprop(learning_rate=0.01, parameters=tps)
    jo.prime()
    to.prime()
    for i, jp in enumerate(jps):
        np.testing.assert_array_equal(
            np.asarray(jo._state[(id(jp), "lrs")]), np.float32(1e-5))
        assert torch.equal(to._state[(i, "lrs")],
                           torch.full_like(tps[i], 0.01))


def test_accumulate_trajectory_and_gauge():
    """accumulate_steps=2 on a batch of 4, 3 steps, against the
    reference's; the optimizer primed before the first step; the
    train.opt_state_bytes gauge, set once while observability is armed,
    equal to the reference's count of the same state."""
    jm, tm = _models(seed=10)
    ids = np.random.RandomState(11).randint(0, 1024, (4, 16))
    lr, steps = 1e-3, 3
    jo = jopt.AdamW(learning_rate=lr, parameters=jm.parameters(),
                    weight_decay=0.1)
    to = topt.AdamW(learning_rate=lr, parameters=tm.parameters(),
                    weight_decay=0.1)
    js = paddle.jit.TrainStep(jm, jo, lambda i, l: jm.loss(i, l),
                              accumulate_steps=2)
    ts = TrainStep(tm, to, lambda i, l: tm.loss(i, l), accumulate_steps=2)
    jb = (paddle.to_tensor(ids), paddle.to_tensor(ids))
    tb = (torch.from_numpy(ids), torch.from_numpy(ids))
    tm.loss(*tb).backward()              # the full batch: the mean grad
    first = to_numpy(tm, grads=True)
    tm.zero_grad(set_to_none=True)
    t_obs.enable(True)
    try:
        t_losses = [ts(*tb).item() for _ in range(steps)]
        gauge = t_metrics.snapshot()["gauges"]["train.opt_state_bytes"]
    finally:
        t_obs.enable(False)
        t_metrics.reset()
    j_losses = [float(js(*jb).numpy()) for _ in range(steps)]
    np.testing.assert_allclose(t_losses, j_losses, rtol=TRAJ_RTOL)
    got = to_numpy(tm)
    for k, p in jm.state_dict().items():
        want = np.asarray(p.data, np.float64)
        noise = np.abs(first[k]) <= NOISE_GRAD
        diff = got[k] - want
        assert np.abs(diff[noise]).max(initial=0.0) <= 2 * lr * steps, k
        err, norm = (np.linalg.norm(t[~noise]) for t in (diff, want))
        assert err <= TRAJ_RTOL * norm, (k, err, norm)
    want = js.opt_state_bytes_per_rank()
    assert list(gauge.values()) == [want] == [ts.opt_state_bytes_per_rank()]
    assert len(to._state) == 2 * len(list(tm.parameters()))
    assert all(p.grad is None for p in tm.parameters())
    with pytest.raises(ValueError, match="must divide"):
        ts(tb[0][:3], tb[1][:3])
    with pytest.raises(ValueError, match="incompatible with a GradScaler"):
        TrainStep(tm, to, tm.loss, scaler=tamp.GradScaler(),
                  accumulate_steps=2)


def test_accumulate_leaves_unreached_parameters_without_grad():
    """A parameter the loss never reaches keeps grad None through the
    micro-steps, and the step skips it (no weight decay either)."""
    net = torch.nn.Linear(3, 1)
    spare = torch.nn.Parameter(torch.ones(2))
    opt = topt.AdamW(learning_rate=0.1, parameters=[*net.parameters(), spare])
    seen = []

    def step_fn(x, y):
        seen.append(x.shape[0])
        return ((net(x) - y) ** 2).mean()

    ts = TrainStep(net, opt, step_fn, accumulate_steps=3)
    x, y = torch.randn(6, 3), torch.randn(6, 1)
    w0 = net.weight.detach().clone()
    ts(x, y)
    assert seen == [2, 2, 2]
    assert torch.equal(spare, torch.ones(2))
    assert not torch.equal(w0, net.weight)


@pytest.mark.parametrize("name", ["auto_cast", "amp_guard", "compute_dtype",
                                  "debugging"])
def test_o1_refused(name):
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        if name == "compute_dtype":
            tamp.compute_dtype("matmul")
        elif name == "debugging":
            tamp.debugging.enable_operator_stats_collection()
        else:
            with getattr(tamp, name)():
                pass
    assert tamp.is_bfloat16_supported() and tamp.is_float16_supported()


def test_scaler_state_dict_and_disabled():
    s = tamp.GradScaler(init_loss_scaling=512.0, incr_ratio=3.0)
    assert s.state_dict() == jamp.GradScaler(
        init_loss_scaling=512.0, incr_ratio=3.0).state_dict()
    s.load_state_dict({"scale": 64.0, "good": 3, "bad": 1})
    assert s.state_dict()["scale"] == 64.0 and s.get_init_loss_scaling() == 64.0
    loss = torch.tensor(2.0)
    assert s.scale(loss).item() == 128.0
    off = tamp.GradScaler(enable=False)
    assert off.scale(loss) is loss and not off.is_enable()
    p = torch.nn.Parameter(torch.ones(2))
    p.grad = torch.ones(2)
    o = topt.SGD(learning_rate=0.5, parameters=[p])
    off.step(o)
    assert torch.equal(p.detach(), torch.full((2,), 0.5))
