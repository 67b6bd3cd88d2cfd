"""`TrainStep` (counterpart of paddle_tpu/jit/__init__.py::TrainStep).

The reference compiles forward, backward and the optimizer update into
one XLA executable (`_pure_body`, l.604-706). PyTorch runs eagerly, so
the port's step is the same sequence run in order on one device:
`step_fn(*batch)`, `backward()`, `optimizer.step()`, and the grads
dropped (`clear_grad(set_to_zero=False)`, as the compiled body does).
Gradient scaling, sharding, gradient accumulation and remat are not
ported: asking for any of them raises.
"""
from __future__ import annotations

__all__ = ["TrainStep"]

_REMAT_POLICIES = ("save_matmul_outputs", "nothing", "recompute_all",
                   "dots")


class TrainStep:
    """One training step per call: returns the (detached) loss.

    step_fn: callable(*batch) -> scalar loss tensor, calling `model`.
    remat_policy: the reference's names ("save_matmul_outputs" default,
    "nothing"/"recompute_all", "dots", None or a callable). A policy
    acts only where the model rematerialises its layers
    (`cfg.use_recompute`), which the port does not do yet, so such a
    model raises here."""

    def __init__(self, model, optimizer, step_fn, scaler=None, shard=None,
                 accumulate_steps=1, remat_policy="save_matmul_outputs"):
        if scaler is not None:
            raise NotImplementedError(
                "TrainStep(scaler=...): loss scaling is not ported yet")
        if shard is not None:
            raise NotImplementedError(
                "TrainStep(shard=...): sharded training is not ported yet")
        if int(accumulate_steps) != 1:
            raise NotImplementedError(
                "TrainStep(accumulate_steps>1): gradient accumulation is "
                "not ported yet")
        if not (remat_policy is None or callable(remat_policy)
                or remat_policy in _REMAT_POLICIES):
            raise ValueError(
                f"TrainStep: unknown remat_policy {remat_policy!r} — "
                f"expected None, {', '.join(map(repr, _REMAT_POLICIES))} "
                f"or a callable")
        cfg = getattr(model, "cfg", None)
        if remat_policy is not None and getattr(cfg, "use_recompute", False):
            raise NotImplementedError(
                "TrainStep: remat (use_recompute=True with a remat_policy) "
                "is not ported yet")
        self.model = model
        self.optimizer = optimizer
        self.step_fn = step_fn

    def __call__(self, *batch):
        loss = self.step_fn(*batch)
        loss.backward()
        self.optimizer.step()
        self.optimizer.clear_grad(set_to_zero=False)
        return loss.detach()
