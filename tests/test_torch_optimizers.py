"""The port's optimizer surface against the JAX package in f32 on the
CPU: every optimizer and its options, the regularizers, the gradient
clips, per-parameter learning rates and regularizers, state dicts, and
`models.convert.optimizer_state_from_jax` (a llama_tiny `TrainStep`
resumed at step 3 from the reference's state).

The zoo runs eager `step()`s on raw parameters (no reference
`TrainStep` compile a case): the same seeded numpy weights, and a new
seeded gradient each step, go through both packages, and every weight
and every accumulator is held to TRAJ_RTOL (max|a - b| / max|b|) after
each step. Both sides compute the same f32 expressions; they differ by
the order of a reduction (a clip's norm, Lamb's trust ratio, LBFGS's
dot products) alone."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
import paddle_tpu.regularizer as jreg
from paddle_tpu.models import llama as JL
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models.convert import (optimizer_state_from_jax,
                                             state_from_jax, to_numpy)

from _torch_threads import one_torch_thread  # noqa: F401,E402

TRAJ_RTOL = 1e-5
STEPS = 5
SHAPES = [(8, 16), (16,), (8, 16)]     # two shapes: few reference compiles



def _max_rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


class _Named(torch.nn.Parameter):
    """A parameter whose `name` can be set (a torch tensor's own `name`
    is a read-only None), as a reference parameter's can."""
    name = None


def _params(seed=0, shapes=SHAPES):
    """The same weights as reference and port parameters, named w0..."""
    rng = np.random.RandomState(seed)
    ws = [rng.randn(*s).astype(np.float32) for s in shapes]
    jps, tps = [], []
    for i, (s, w) in enumerate(zip(shapes, ws)):
        jp = paddle.create_parameter(list(s), "float32", name=f"w{i}")
        jp.data = jnp.asarray(w)
        jps.append(jp)
        tp = _Named(_t(w))
        tp.name = f"w{i}"
        tps.append(tp)
    return jps, tps


def _set_grads(jps, tps, rng, scale=1.0):
    for jp, tp in zip(jps, tps):
        g = (scale * rng.randn(*tp.shape)).astype(np.float32)
        jp.grad = paddle.to_tensor(g)
        tp.grad = _t(g)


def _check_state(jo, jps, to, tag):
    assert to._step_count == jo._step_count
    got = {k: v for k, v in to._state.items()}
    want = {(i, name): v for i, jp in enumerate(jps)
            for (pid, name), v in jo._state.items() if pid == id(jp)}
    assert sorted(got) == sorted(want), tag
    for k in want:
        assert got[k].shape == tuple(want[k].shape), (tag, k)
        assert _max_rel(got[k], want[k]) <= TRAJ_RTOL, (tag, k)


def _check(jo, jps, to, tps, tag):
    for i, (jp, tp) in enumerate(zip(jps, tps)):
        assert _max_rel(tp.detach(), jp.data) <= TRAJ_RTOL, (tag, i)
    _check_state(jo, jps, to, tag)


# name -> (optimizer class name, kwargs built fresh for each side: a
# callable of the side's modules (opt, reg, nn))
ZOO = {
    "sgd": ("SGD", lambda o, r, n: dict(learning_rate=0.1)),
    "sgd_wd": ("SGD", lambda o, r, n: dict(learning_rate=0.1,
                                           weight_decay=0.01)),
    "sgd_l2decay": ("SGD", lambda o, r, n: dict(
        learning_rate=0.1, weight_decay=r.L2Decay(0.01))),
    "sgd_l1decay": ("SGD", lambda o, r, n: dict(
        learning_rate=0.1, weight_decay=r.L1Decay(0.01))),
    "momentum": ("Momentum", lambda o, r, n: dict(learning_rate=0.05,
                                                  momentum=0.9)),
    "momentum_nesterov": ("Momentum", lambda o, r, n: dict(
        learning_rate=0.05, momentum=0.8, use_nesterov=True,
        weight_decay=0.01)),
    "adam": ("Adam", lambda o, r, n: dict(learning_rate=0.01)),
    "adam_amsgrad": ("Adam", lambda o, r, n: dict(learning_rate=0.01,
                                                  amsgrad=True)),
    "adam_l2decay": ("Adam", lambda o, r, n: dict(
        learning_rate=0.01, weight_decay=r.L2Decay(0.05),
        multi_precision=True, lazy_mode=True, use_multi_tensor=True)),
    "adamw": ("AdamW", lambda o, r, n: dict(learning_rate=0.01,
                                            weight_decay=0.1, beta2=0.95,
                                            epsilon=1e-5)),
    "adamw_ratio_decay_fun": ("AdamW", lambda o, r, n: dict(
        learning_rate=0.01, weight_decay=0.1,
        lr_ratio=lambda p: 0.5 if p.name == "w1" else 1.0,
        apply_decay_param_fun=lambda name: name != "w0")),
    "adamw_amsgrad_ignored": ("AdamW", lambda o, r, n: dict(
        learning_rate=0.01, amsgrad=True)),
    "adamax": ("Adamax", lambda o, r, n: dict(learning_rate=0.02,
                                              weight_decay=0.01)),
    "adagrad": ("Adagrad", lambda o, r, n: dict(
        learning_rate=0.1, initial_accumulator_value=0.1)),
    "adadelta": ("Adadelta", lambda o, r, n: dict(learning_rate=1.0,
                                                  weight_decay=0.01)),
    "rmsprop": ("RMSProp", lambda o, r, n: dict(learning_rate=0.01)),
    "rmsprop_centered_momentum": ("RMSProp", lambda o, r, n: dict(
        learning_rate=0.01, momentum=0.9, centered=True,
        weight_decay=0.01)),
    "lamb": ("Lamb", lambda o, r, n: dict(learning_rate=0.01)),
    "lamb_exclude": ("Lamb", lambda o, r, n: dict(
        learning_rate=0.01, lamb_weight_decay=0.1,
        exclude_from_weight_decay_fn=lambda p: p.name == "w2")),
    "asgd": ("ASGD", lambda o, r, n: dict(learning_rate=0.05,
                                          batch_num=3, weight_decay=0.01)),
    "rprop": ("Rprop", lambda o, r, n: dict(learning_rate=0.01)),
    "adam_clip_value": ("Adam", lambda o, r, n: dict(
        learning_rate=0.01, grad_clip=n.ClipGradByValue(0.5))),
    "adam_clip_norm": ("Adam", lambda o, r, n: dict(
        learning_rate=0.01, grad_clip=n.ClipGradByNorm(2.0))),
    "adamw_clip_global_norm": ("AdamW", lambda o, r, n: dict(
        learning_rate=0.01, grad_clip=n.ClipGradByGlobalNorm(1.0))),
    "sgd_clip_global_norm_within": ("SGD", lambda o, r, n: dict(
        learning_rate=0.1, grad_clip=n.ClipGradByGlobalNorm(1e3))),
    "momentum_step_decay": ("Momentum", lambda o, r, n: dict(
        learning_rate=o.lr.StepDecay(0.1, step_size=2, gamma=0.5))),
}


@pytest.mark.parametrize("case", list(ZOO))
def test_optimizer_zoo_matches_reference(case):
    cls, kw = ZOO[case]
    jps, tps = _params()
    jo = getattr(jopt, cls)(parameters=jps, **kw(jopt, jreg, jnn))
    to = getattr(topt, cls)(parameters=tps, **kw(topt, treg, tnn))
    rng = np.random.RandomState(1)
    for s in range(STEPS):
        _set_grads(jps, tps, rng, scale=3.0 if "clip" in case else 1.0)
        jo.step()
        to.step()
        _check(jo, jps, to, tps, f"{case} step {s + 1}")
        if isinstance(jo._lr, jopt.lr.LRScheduler):
            jo._lr.step()
            to._lr.step()
            assert to.get_lr() == jo.get_lr()


def test_per_parameter_lr_and_regularizer():
    """A parameter's optimize_attr learning rate and its own regularizer
    (read by getattr in the port), with an L2 weight_decay on the rest."""
    jps, tps = _params(seed=2)
    for side, (ps, reg) in {"ref": (jps, jreg), "port": (tps, treg)}.items():
        ps[0].optimize_attr = {"learning_rate": 0.25}
        ps[1].regularizer = reg.L1Decay(0.02)
        ps[2].regularizer = reg.L2Decay(0.03)
    jo = jopt.Adam(learning_rate=0.01, parameters=jps, weight_decay=0.01)
    to = topt.Adam(learning_rate=0.01, parameters=tps, weight_decay=0.01)
    rng = np.random.RandomState(3)
    for s in range(STEPS):
        _set_grads(jps, tps, rng)
        jo.step()
        to.step()
        _check(jo, jps, to, tps, f"step {s + 1}")


def test_lbfgs_matches_reference():
    """A least-squares fit through LBFGS's closure in both packages."""
    rng = np.random.RandomState(4)
    X = rng.randn(24, 6).astype(np.float32)
    y = rng.randn(24, 1).astype(np.float32)
    jps, tps = _params(seed=5, shapes=[(6, 1)])
    jo = jopt.LBFGS(learning_rate=0.5, max_iter=4, history_size=3,
                    parameters=jps)
    to = topt.LBFGS(learning_rate=0.5, max_iter=4, history_size=3,
                    parameters=tps)
    jX, jy = paddle.to_tensor(X), paddle.to_tensor(y)
    tX, ty = _t(X), _t(y)

    def j_closure():
        jo.clear_grad(set_to_zero=False)
        loss = ((paddle.matmul(jX, jps[0]) - jy) ** 2).mean()
        loss.backward()
        return loss

    def t_closure():
        to.clear_grad(set_to_zero=False)
        loss = ((tX @ tps[0] - ty) ** 2).mean()
        loss.backward()
        return loss

    for s in range(3):
        jl = float(jo.step(j_closure).numpy())
        tl = to.step(t_closure).item()
        assert abs(tl - jl) <= TRAJ_RTOL * abs(jl), s
        assert _max_rel(tps[0].detach(), jps[0].data) <= TRAJ_RTOL, s
    assert len(to._s) == len(jo._s) == 3
    with pytest.raises(NotImplementedError):
        to._apply_one(0, tps[0], tps[0], tps[0], 0.1)


@pytest.mark.parametrize("clip", ["value", "norm", "global_norm"])
def test_clips_on_mixed_dtypes_match_reference(clip):
    """Each clip alone over f32 and bf16 grads: the factor in f32, each
    grad rounded back to its dtype."""
    rng = np.random.RandomState(6)
    shapes = [(5, 7), (11,), (4, 4)]
    gs = [(4.0 * rng.randn(*s)).astype(np.float32) for s in shapes]
    dts = [jnp.float32, jnp.bfloat16, jnp.float32]
    tdts = [torch.float32, torch.bfloat16, torch.float32]
    make = {"value": lambda n: n.ClipGradByValue(1.5, min=-0.5),
            "norm": lambda n: n.ClipGradByNorm(3.0),
            "global_norm": lambda n: n.ClipGradByGlobalNorm(5.0)}[clip]
    jps, tps = [], []
    for s, g, jd, td in zip(shapes, gs, dts, tdts):
        jp = paddle.create_parameter(list(s), "float32")
        jp.grad = paddle.to_tensor(jnp.asarray(g).astype(jd))
        jps.append(jp)
        tp = torch.nn.Parameter(torch.zeros(s, dtype=td))
        tp.grad = _t(g).to(td)
        tps.append(tp)
    make(jnn)(jps)
    make(tnn)(tps)
    for jp, tp, td in zip(jps, tps, tdts):
        assert tp.grad.dtype == td
        want = np.asarray(jp.grad.data.astype(jnp.float32))
        assert _max_rel(tp.grad.float(), want) <= TRAJ_RTOL


def test_regularizer_terms():
    w = np.array([-2.0, 0.0, 0.5], np.float32)
    for reg_j, reg_t in ((jreg.L1Decay(0.1), treg.L1Decay(0.1)),
                         (jreg.L2Decay(0.1), treg.L2Decay(0.1))):
        np.testing.assert_array_equal(reg_t(_t(w)).numpy(),
                                      np.asarray(reg_j(jnp.asarray(w))))


def test_state_dict_round_trip_with_scheduler():
    """Keys "{p.name or i}.{slot}", "@step" and "LR_Scheduler" as the
    reference writes them; set_state_dict restores state and scheduler,
    and a reference state dict loads into the port."""
    jps, tps = _params(seed=7)
    jo = jopt.Adam(learning_rate=jopt.lr.ExponentialDecay(0.01, 0.9),
                   parameters=jps, amsgrad=True)
    to = topt.Adam(learning_rate=topt.lr.ExponentialDecay(0.01, 0.9),
                   parameters=tps, amsgrad=True)
    rng = np.random.RandomState(8)
    for _ in range(2):
        _set_grads(jps, tps, rng)
        jo.step()
        to.step()
        jo._lr.step()
        to._lr.step()
    jsd, tsd = jo.state_dict(), to.state_dict()
    assert sorted(tsd) == sorted(jsd)
    assert "w0.moment2_max" in tsd and tsd["@step"] == 2
    assert tsd["LR_Scheduler"] == jsd["LR_Scheduler"]
    tps2 = [_Named(p.detach().clone()) for p in tps]
    for p, q in zip(tps2, tps):
        p.name = q.name
    to2 = topt.Adam(learning_rate=topt.lr.ExponentialDecay(0.01, 0.9),
                    parameters=tps2, amsgrad=True)
    to2.set_state_dict({k: (np.array(v) if k.startswith("w") else v)
                        for k, v in jsd.items()})
    assert to2._step_count == 2 and to2.get_lr() == to.get_lr()
    _check_state(jo, jps, to2, "loaded")
    _set_grads(jps, tps2, rng)
    jo.step()
    to2.step()
    _check(jo, jps, to2, tps2, "after load")


def test_prime_creates_missing_state_and_changes_none():
    """The port's prime: accumulators at their first-step values,
    existing ones untouched (the reference's decays them: see
    test_torch_amp's differences by design)."""
    jps, tps = _params(seed=9)
    to = topt.Adagrad(learning_rate=0.1, parameters=tps,
                      initial_accumulator_value=0.25)
    to.prime()
    assert all(torch.equal(to._state[(i, "moment")],
                           torch.full_like(p, 0.25))
               for i, p in enumerate(tps))
    tps[0].grad = torch.ones_like(tps[0])
    to.step()
    before = {k: v.clone() for k, v in to._state.items()}
    to.prime()
    assert all(torch.equal(to._state[k], before[k]) for k in before)
    w = [p.detach().clone() for p in tps]
    topt.LBFGS(parameters=tps).prime()      # no slot: nothing to make
    assert all(torch.equal(a, b) for a, b in zip(w, tps))


# ------------------------------------------- resume through convert


def _tiny_models(seed):
    kw = dict(use_recompute=False, fuse_attention_qkv=True, fuse_mlp=True)
    paddle.seed(seed)
    jm = JL.LlamaForCausalLM(JL.llama_tiny(dtype="float32", **kw))
    np_state = {k: np.asarray(v.numpy()).astype(np.float32)
                for k, v in jm.state_dict().items()}
    tcfg = TL.llama_tiny(dtype="float32", **kw)
    tm = TL.LlamaForCausalLM(tcfg, device="cpu")
    tm.load_state_dict(state_from_jax(np_state, tcfg, "cpu"))
    return jm, tm, tcfg


def _recipe(o, params):
    sched = o.lr.LinearWarmup(
        o.lr.CosineAnnealingDecay(3e-3, T_max=10, eta_min=3e-4),
        warmup_steps=2, start_lr=0.0, end_lr=3e-3)
    return o.AdamW(learning_rate=sched, beta2=0.95, epsilon=1e-5,
                   weight_decay=0.1, parameters=params,
                   grad_clip=(jnn if o is jopt else tnn)
                   .ClipGradByGlobalNorm(1.0))


def test_resume_at_step_3_through_optimizer_state_from_jax():
    """The reference trains 3 steps of the LLaMA 2 recipe's shape
    (AdamW, warmup then cosine, global-norm clip); the port takes its
    weights (state_from_jax) and its optimizer state
    (optimizer_state_from_jax: moments, @step, both schedulers), and
    both run 2 more steps. Losses and weights within TRAJ_RTOL (weights
    by relative L2 a tensor, test_torch_train's measure)."""
    jm, _, tcfg = _tiny_models(seed=11)
    ids = np.random.RandomState(12).randint(0, 1024, (2, 16))
    jo = _recipe(jopt, jm.parameters())
    js = paddle.jit.TrainStep(jm, jo, lambda i, l: jm.loss(i, l))
    jb = (paddle.to_tensor(ids), paddle.to_tensor(ids))
    for _ in range(3):
        js(*jb)
        jo._lr.step()
    tm = TL.LlamaForCausalLM(tcfg, device="cpu")
    tm.load_state_dict(state_from_jax(
        {k: np.asarray(v.numpy()).astype(np.float32)
         for k, v in jm.state_dict().items()}, tcfg, "cpu"))
    to = _recipe(topt, tm.parameters())
    optimizer_state_from_jax(jo, jm, to, tm)
    assert to._step_count == 3 and to.get_lr() == jo.get_lr()
    assert to._lr.lr_sched.last_epoch == jo._lr.lr_sched.last_epoch
    assert len(to._state) == 2 * len(list(tm.parameters()))
    ts = TrainStep(tm, to, lambda i, l: tm.loss(i, l))
    tb = (torch.from_numpy(ids), torch.from_numpy(ids))
    j_losses, t_losses = [], []
    for _ in range(2):
        j_losses.append(float(js(*jb).numpy()))
        t_losses.append(ts(*tb).item())
        assert ts.last_lr == jo.get_lr()
        jo._lr.step()
        to._lr.step()
    np.testing.assert_allclose(t_losses, j_losses, rtol=TRAJ_RTOL)
    got = to_numpy(tm)
    for k, p in jm.state_dict().items():
        want = np.asarray(p.data, np.float64)
        err = np.linalg.norm(got[k] - want) / np.linalg.norm(want)
        assert err <= TRAJ_RTOL, (k, err)
