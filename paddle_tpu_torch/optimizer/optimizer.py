"""Optimizers (counterpart of paddle_tpu/optimizer/optimizer.py): the
`Optimizer` base, `Adam` and `AdamW`, with the reference's float order
(optimizer.py:127-172, 216-288). Their own code, not `torch.optim`,
whose AdamW orders its float operations differently.

The update is plain PyTorch (the reference's is plain jnp; it has no
fused multi-tensor kernel, and neither does the port). Each parameter is
updated in place (`p.copy_`), where the reference rebinds `p.data`.
Moments are shaped and typed like the parameter (`zeros_like`: bf16 in a
bf16 model, f32 for its f32 norm weights). The weight, the bias-corrected
moments and the step run in f32 and the result is cast back to the
parameter's dtype, as the reference's compiled step computes them (its
learning rate and step count are traced f32 scalars there); for f32
parameters this is the eager reference float for float. A learning-rate
scheduler, grad clipping, `multi_precision` and AMP master weights are
not ported and raise.
"""
from __future__ import annotations

import torch

__all__ = ["Optimizer", "Adam", "AdamW"]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if parameters is None:
            raise ValueError("parameters must be provided (dygraph-style)")
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "a learning-rate scheduler (LRScheduler) is not ported "
                "yet; pass a float learning_rate")
        if grad_clip is not None:
            raise NotImplementedError("grad_clip is not ported yet")
        if not (weight_decay is None or isinstance(weight_decay,
                                                    (int, float))):
            raise NotImplementedError(
                "weight_decay regularizer objects are not ported yet; pass "
                "a float")
        self._parameter_list = list(parameters)
        self._lr = float(learning_rate)
        self._weight_decay = weight_decay
        self._state: dict = {}            # (param index, name) -> tensor
        self._step_count = 0

    def get_lr(self) -> float:
        return self._lr

    def set_lr(self, value) -> None:
        self._lr = float(value)

    def _decay_coeff(self) -> float:
        return 0.0 if self._weight_decay is None else float(self._weight_decay)

    def _get_state(self, i, name, like):
        key = (i, name)
        if key not in self._state:
            self._state[key] = torch.zeros_like(like)
        return self._state[key]

    def state_dict(self) -> dict:
        out = {f"{i}.{name}": v for (i, name), v in self._state.items()}
        out["@step"] = self._step_count
        return out

    def set_state_dict(self, state) -> None:
        self._step_count = int(state.get("@step", 0))
        for key, v in state.items():
            if key == "@step":
                continue
            i, _, name = key.partition(".")
            p = self._parameter_list[int(i)]
            self._state[(int(i), name)] = torch.as_tensor(v).to(
                device=p.device, dtype=p.dtype).clone()

    def clear_grad(self, set_to_zero=True) -> None:
        """set_to_zero keeps a zero grad in place; False drops it (frees
        its memory)."""
        for p in self._parameter_list:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    @torch.no_grad()
    def step(self) -> None:
        self._step_count += 1
        lr = self.get_lr()
        for i, p in enumerate(self._parameter_list):
            if p.grad is None or not p.requires_grad:
                continue
            g = p.grad
            if g.dtype != p.dtype:
                g = g.to(p.dtype)
            p.copy_(self._apply_one(i, p, g, lr).to(p.dtype))

    def _apply_one(self, i, w, g, lr):
        raise NotImplementedError


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, name=None, amsgrad=False):
        if multi_precision or amsgrad or lazy_mode:
            raise NotImplementedError(
                "multi_precision (f32 master weights), amsgrad and "
                "lazy_mode are not ported yet")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._eps = float(epsilon)

    def _moments(self, i, w, g):
        b1, b2 = self._beta1, self._beta2
        m = self._get_state(i, "moment1", w)
        v = self._get_state(i, "moment2", w)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        self._state[(i, "moment1")] = m
        self._state[(i, "moment2")] = v
        t = self._step_count
        return m.float() / (1 - b1 ** t), v.float() / (1 - b2 ** t)

    def _apply_one(self, i, w, g, lr):
        wd = self._decay_coeff()
        if wd:                           # Adam: L2 into the gradient
            g = g + wd * w
        mhat, vhat = self._moments(i, w, g)
        return w.float() - lr * mhat / (torch.sqrt(vhat) + self._eps)


class AdamW(Adam):
    """Decoupled weight decay, applied to the weight before the moment
    update (the reference's adamw order)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None,
                 amsgrad=False):
        if lr_ratio is not None or apply_decay_param_fun is not None:
            raise NotImplementedError(
                "lr_ratio and apply_decay_param_fun are not ported yet")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode=lazy_mode,
                         multi_precision=multi_precision, amsgrad=amsgrad)

    def _apply_one(self, i, w, g, lr):
        wd = self._decay_coeff()
        w32 = w.float() * (1.0 - lr * wd)
        mhat, vhat = self._moments(i, w, g)
        return w32 - lr * mhat / (torch.sqrt(vhat) + self._eps)
