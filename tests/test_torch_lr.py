"""The port's LR schedulers (paddle_tpu_torch/optimizer/lr.py) against
the JAX package's: every one of the 18 classes, 40 steps, the learning
rate equal float for float at each, then a state dict round trip. Both
are plain Python, so equality is exact."""
import numpy as np
import pytest
import torch

import paddle_tpu.optimizer.lr as jlr
from paddle_tpu_torch.optimizer import lr as tlr

from _torch_threads import one_torch_thread  # noqa: F401,E402

STEPS = 40



def _cases(m):
    """name -> scheduler built from the module `m`."""
    return {
        "noam": lambda: m.NoamDecay(d_model=64, warmup_steps=10,
                                    learning_rate=2.0),
        "piecewise": lambda: m.PiecewiseDecay([5, 12, 30],
                                              [0.1, 0.05, 0.01, 0.001]),
        "natural_exp": lambda: m.NaturalExpDecay(0.1, gamma=0.05),
        "inverse_time": lambda: m.InverseTimeDecay(0.1, gamma=0.2),
        "polynomial": lambda: m.PolynomialDecay(0.1, decay_steps=25,
                                                end_lr=1e-3, power=2.0),
        "polynomial_cycle": lambda: m.PolynomialDecay(
            0.1, decay_steps=12, end_lr=1e-3, cycle=True),
        "linear_warmup_float": lambda: m.LinearWarmup(
            0.1, warmup_steps=7, start_lr=0.0, end_lr=0.1),
        "linear_warmup_cosine": lambda: m.LinearWarmup(
            m.CosineAnnealingDecay(3e-4, T_max=30, eta_min=3e-5),
            warmup_steps=8, start_lr=0.0, end_lr=3e-4),
        "exponential": lambda: m.ExponentialDecay(0.1, gamma=0.93),
        "multistep": lambda: m.MultiStepDecay(0.1, milestones=[6, 15, 33],
                                              gamma=0.3),
        "step": lambda: m.StepDecay(0.1, step_size=7, gamma=0.5),
        "lambda": lambda: m.LambdaDecay(0.1, lambda e: 0.95 ** e),
        "cosine": lambda: m.CosineAnnealingDecay(0.1, T_max=17,
                                                 eta_min=0.001),
        "multiplicative": lambda: m.MultiplicativeDecay(0.1,
                                                        lambda e: 0.97),
        "one_cycle_cos": lambda: m.OneCycleLR(0.1, total_steps=35),
        "one_cycle_linear_three": lambda: m.OneCycleLR(
            0.1, total_steps=35, anneal_strategy="linear",
            three_phase=True),
        "cyclic_triangular2": lambda: m.CyclicLR(
            1e-3, 0.1, step_size_up=5, step_size_down=7,
            mode="triangular2"),
        "cyclic_exp_range": lambda: m.CyclicLR(
            1e-3, 0.1, step_size_up=6, mode="exp_range", exp_gamma=0.97),
        "cyclic_scale_fn": lambda: m.CyclicLR(
            1e-3, 0.1, step_size_up=4, scale_fn=lambda x: 1.0 / (1 + x),
            scale_mode="iterations"),
        "warm_restarts": lambda: m.CosineAnnealingWarmRestarts(
            0.1, T_0=6, T_mult=2, eta_min=1e-3),
        "linear_lr": lambda: m.LinearLR(0.1, total_steps=20,
                                        start_factor=0.25, end_factor=1.0),
    }


def test_every_scheduler_class_is_covered():
    names = {type(f()).__name__ for f in _cases(tlr).values()}
    assert names | {"LRScheduler", "ReduceOnPlateau"} == set(tlr.__all__)
    assert tlr.__all__ == jlr.__all__ and len(tlr.__all__) == 18


@pytest.mark.parametrize("case", list(_cases(tlr)))
def test_scheduler_sequence_and_state_dict(case):
    j = _cases(jlr)[case]()
    t = _cases(tlr)[case]()
    got, want = [], []
    for _ in range(STEPS):
        got.append(t())
        want.append(j())
        t.step()
        j.step()
    assert got == want
    sd = t.state_dict()
    assert sd == j.state_dict()
    # a fresh scheduler takes the state and goes on as the original does
    t2 = _cases(tlr)[case]()
    t2.set_state_dict(sd)
    for _ in range(5):
        if case != "linear_warmup_cosine":   # its inner one is not saved
            assert t2() == t()
        t2.step()
        t.step()
        j.step()
    # explicit epochs
    t.step(epoch=3)
    j.step(epoch=3)
    assert t() == j()


def test_linear_warmup_state_dict_drops_its_inner_scheduler():
    """Kept for parity: LRScheduler.state_dict keeps plain-typed
    attributes only, so LinearWarmup's inner scheduler is not saved, and
    get_lr steps it on each call after warmup."""
    for m in (tlr, jlr):
        s = _cases(m)["linear_warmup_cosine"]()
        for _ in range(12):
            s.step()
        assert "lr_sched" not in s.state_dict()
        inner = s.lr_sched.last_epoch
        s.get_lr()
        assert s.lr_sched.last_epoch == inner + 1


@pytest.mark.parametrize("mode,threshold_mode", [("min", "rel"),
                                                 ("max", "abs")])
def test_reduce_on_plateau_takes_tensors(mode, threshold_mode):
    rng = np.random.RandomState(0)
    metrics = np.round(rng.rand(STEPS), 1).astype(np.float32)
    kw = dict(mode=mode, factor=0.5, patience=2, threshold=1e-2,
              threshold_mode=threshold_mode, cooldown=1, min_lr=1e-3)
    j = jlr.ReduceOnPlateau(0.1, **kw)
    t = tlr.ReduceOnPlateau(0.1, **kw)
    for x in metrics:
        j.step(float(x))
        t.step(torch.tensor(x))         # read through .item()
        assert t() == j()
    assert t() < 0.1
    assert t.state_dict() == j.state_dict()
