"""Optimizers (counterpart of paddle_tpu/optimizer/optimizer.py): the
`Optimizer` base and the reference's twelve optimizers, with its float
order (optimizer.py:127-531). Their own code, not `torch.optim`, whose
updates order their float operations differently.

The update is plain PyTorch (the reference's is plain jnp; it has no
fused multi-tensor kernel, and neither does the port). A step runs the
reference's order (l.145-172): the grad clip over the parameter list,
the learning rate (a float, or an `lr.LRScheduler` read on the host),
then per parameter its `optimize_attr["learning_rate"]` and its
`regularizer` (both read with `getattr`: torch parameters carry neither
unless a caller sets them), the f32 master weight `amp.decorate(level=
"O2")` gave it if any, `_apply_one`, and the result cast back. Each
parameter is updated in place (`p.copy_`), where the reference rebinds
`p.data`; accumulators are rebound, never written in place.

Accumulators take the dtype of the tensor they update: the parameter's
(bf16 moments in a bf16 model, f32 for its f32 norm weights), or under
O2 the f32 master's, with the grad cast to the master's dtype. Adam and
AdamW run the weight, the bias-corrected moments and the step in f32 and
cast the result back, as the reference's compiled step computes them
(its learning rate and step count are traced f32 scalars there); the
other optimizers compute in the updated tensor's dtype. For f32
parameters every optimizer is the eager reference float for float.

Kept for parity: `multi_precision`, `lazy_mode` and `use_multi_tensor`
are accepted and ignored (f32 masters come from `amp.decorate` alone),
AdamW ignores `amsgrad`, and a regularizer object passed as
`weight_decay` is read for its coefficient only. Keys of `state_dict`
are `"{p.name or i}.{slot}"`; a parameter's name (`_name`) is its
`name` attribute where that is a string, else "" (a torch tensor's own
`name` is None and cannot be set: `nn.ParamAttr(name=)` gives a layer's
parameter one, through `nn.layer.layers.Parameter`).

`prime()` creates every accumulator that does not exist yet, at the
value a real first step starts it from, and changes none that exists;
the reference's runs each update rule once with a zero grad and lr 0
(l.65-89), which also decays existing moments and starts Rprop's step
sizes at the bottom of their range (ROADMAP Queue 3, differences by
design). `_step(found_inf=...)` is the step `amp.GradScaler` takes: with
`found_inf` (a device bool) true, every parameter, master weight and
accumulator keeps its value bitwise, through `torch.where` as each
parameter is written, without a host read; `@step` still advances.
LBFGS keeps its closure and its host reads, as the reference has them.
"""
from __future__ import annotations

from typing import List

import torch

from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "ASGD", "Rprop", "LBFGS"]


def _name(p) -> str:
    name = getattr(p, "name", None)
    return name if isinstance(name, str) else ""


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if parameters is None:
            raise ValueError("parameters must be provided (dygraph-style)")
        self._parameter_list = list(parameters)
        self._lr = learning_rate
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._state: dict = {}            # (param index, slot) -> tensor
        self._step_count = 0
        # param index -> f32 master weight, set by amp.decorate(level="O2")
        self._master_weights: dict = {}

    # -- lr -----------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return float(self._lr)

    def set_lr(self, value) -> None:
        self._lr = value

    def set_lr_scheduler(self, scheduler) -> None:
        self._lr = scheduler

    @property
    def _learning_rate(self):
        return self._lr

    # -- state --------------------------------------------------------------
    def _slots(self):
        """The accumulator names `_apply_one` keeps per parameter."""
        return ()

    def _slot_init(self, name, w, lr):
        return torch.zeros_like(w)

    def _get_state(self, i, name, w, lr):
        key = (i, name)
        if key not in self._state:
            self._state[key] = self._slot_init(name, w, lr)
        return self._state[key]

    def _target(self, i, p):
        master = self._master_weights.get(i)
        return p if master is None else master

    @torch.no_grad()
    def prime(self) -> None:
        """Create every trainable parameter's missing accumulators now, at
        the values a first step would start them from."""
        lr = self.get_lr()
        for i, p in enumerate(self._parameter_list):
            if not p.requires_grad:
                continue
            target = self._target(i, p)
            for name in self._slots():
                self._get_state(i, name, target, lr)

    def _key_prefix(self, i, p):
        return f"{_name(p) or i}."

    def state_dict(self) -> dict:
        out = {}
        for (i, name), v in self._state.items():
            out[self._key_prefix(i, self._parameter_list[i]) + name] = v
        out["@step"] = self._step_count
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        return out

    def set_state_dict(self, state) -> None:
        self._step_count = int(state.get("@step", 0))
        # param names may hold dots themselves: try every '.'-split
        prefix_map: dict = {}
        for i, p in enumerate(self._parameter_list):
            prefix_map.setdefault(self._key_prefix(i, p), []).append(i)
        for k, v in state.items():
            if not isinstance(k, str):
                continue
            pos = k.find(".")
            while pos != -1:
                for i in prefix_map.get(k[:pos + 1], ()):
                    like = self._target(i, self._parameter_list[i])
                    self._state[(i, k[pos + 1:])] = torch.as_tensor(v).to(
                        device=like.device, dtype=like.dtype).clone()
                pos = k.find(".", pos + 1)
        if isinstance(self._lr, LRScheduler) and "LR_Scheduler" in state:
            self._lr.set_state_dict(state["LR_Scheduler"])

    # -- step ---------------------------------------------------------------
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

    def _decay_coeff(self) -> float:
        wd = self._weight_decay
        if wd is None:
            return 0.0
        if hasattr(wd, "_coeff"):
            return float(wd._coeff)
        return float(wd)

    def step(self) -> None:
        self._step()

    @torch.no_grad()
    def _step(self, found_inf=None) -> None:
        self._step_count += 1
        if self._grad_clip is not None:
            self._grad_clip(self._parameter_list)
        lr = self.get_lr()
        for i, p in enumerate(self._parameter_list):
            if p.grad is None or not p.requires_grad:
                continue
            master = self._master_weights.get(i)
            target = p if master is None else master
            g = p.grad
            if g.dtype != target.dtype:
                g = g.to(target.dtype)
            attr = getattr(p, "optimize_attr", None)
            plr = lr * attr.get("learning_rate", 1.0) if attr else lr
            reg = getattr(p, "regularizer", None)
            if reg is not None:
                g = g + reg(target)
            if found_inf is not None:
                old = {n: self._state.get((i, n)) for n in self._slots()}
            new = self._apply_one(i, p, target, g, plr).to(target.dtype)
            if found_inf is not None:
                # GradScaler.step primed every slot: each has a value to keep
                new = torch.where(found_inf, target, new)
                for n, was in old.items():
                    self._state[(i, n)] = torch.where(
                        found_inf, was, self._state[(i, n)])
            if master is not None:
                self._master_weights[i] = new
            p.copy_(new)

    def _apply_one(self, i, p, w, g, lr):
        raise NotImplementedError

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, None


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _apply_one(self, i, p, w, g, lr):
        wd = self._decay_coeff()
        if wd:
            g = g + wd * w
        return w - lr * g


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _slots(self):
        return ("velocity",)

    def _apply_one(self, i, p, w, g, lr):
        wd = self._decay_coeff()
        if wd:
            g = g + wd * w
        v = self._get_state(i, "velocity", w, lr)
        v = self._momentum * v + g
        self._state[(i, "velocity")] = v
        if self._nesterov:
            return w - lr * (g + self._momentum * v)
        return w - lr * v


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, name=None, amsgrad=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._eps = float(epsilon)
        self._amsgrad = amsgrad

    def _slots(self):
        if self._amsgrad:
            return ("moment1", "moment2", "moment2_max")
        return ("moment1", "moment2")

    def _moments(self, i, w, g, lr, amsgrad):
        b1, b2 = self._beta1, self._beta2
        m = self._get_state(i, "moment1", w, lr)
        v = self._get_state(i, "moment2", w, lr)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        self._state[(i, "moment1")] = m
        self._state[(i, "moment2")] = v
        t = self._step_count
        if amsgrad:
            v = torch.maximum(self._get_state(i, "moment2_max", w, lr), v)
            self._state[(i, "moment2_max")] = v
        return m.float() / (1 - b1 ** t), v.float() / (1 - b2 ** t)

    def _apply_one(self, i, p, w, g, lr):
        wd = self._decay_coeff()
        if wd:                           # Adam: L2 into the gradient
            g = g + wd * w
        mhat, vhat = self._moments(i, w, g, lr, self._amsgrad)
        return w.float() - lr * mhat / (torch.sqrt(vhat) + self._eps)


class AdamW(Adam):
    """Decoupled weight decay, applied to the weight before the moment
    update (the reference's adamw order). `lr_ratio(p)` scales a
    parameter's learning rate; `apply_decay_param_fun(p.name)` false
    exempts it from the decay."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None,
                 amsgrad=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, amsgrad=amsgrad)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _slots(self):
        return ("moment1", "moment2")

    def _apply_one(self, i, p, w, g, lr):
        if self._lr_ratio is not None:
            lr = lr * self._lr_ratio(p)
        skip_decay = (self._apply_decay_param_fun is not None
                      and not self._apply_decay_param_fun(_name(p)))
        wd = 0.0 if skip_decay else self._decay_coeff()
        w32 = w.float() * (1.0 - lr * wd)
        mhat, vhat = self._moments(i, w, g, lr, amsgrad=False)
        return w32 - lr * mhat / (torch.sqrt(vhat) + self._eps)


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _slots(self):
        return ("moment", "inf_norm")

    def _apply_one(self, i, p, w, g, lr):
        wd = self._decay_coeff()
        if wd:
            g = g + wd * w
        m = self._get_state(i, "moment", w, lr)
        u = self._get_state(i, "inf_norm", w, lr)
        t = self._step_count
        m = self._beta1 * m + (1 - self._beta1) * g
        u = torch.maximum(self._beta2 * u, torch.abs(g))
        self._state[(i, "moment")] = m
        self._state[(i, "inf_norm")] = u
        return w - lr / (1 - self._beta1 ** t) * m / (u + self._eps)


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def _slots(self):
        return ("moment",)

    def _slot_init(self, name, w, lr):
        return torch.full_like(w, self._init_acc)

    def _apply_one(self, i, p, w, g, lr):
        wd = self._decay_coeff()
        if wd:
            g = g + wd * w
        acc = self._get_state(i, "moment", w, lr) + g * g
        self._state[(i, "moment")] = acc
        return w - lr * g / (torch.sqrt(acc) + self._eps)


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._eps = epsilon
        self._rho = rho

    def _slots(self):
        return ("avg_squared_grad", "avg_squared_update")

    def _apply_one(self, i, p, w, g, lr):
        wd = self._decay_coeff()
        if wd:
            g = g + wd * w
        avg_sq = self._get_state(i, "avg_squared_grad", w, lr)
        avg_up = self._get_state(i, "avg_squared_update", w, lr)
        avg_sq = self._rho * avg_sq + (1 - self._rho) * g * g
        update = (torch.sqrt(avg_up + self._eps)
                  / torch.sqrt(avg_sq + self._eps)) * g
        avg_up = self._rho * avg_up + (1 - self._rho) * update * update
        self._state[(i, "avg_squared_grad")] = avg_sq
        self._state[(i, "avg_squared_update")] = avg_up
        return w - lr * update


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _slots(self):
        if self._centered:
            return ("mean_square", "mean_grad", "momentum")
        return ("mean_square", "momentum")

    def _apply_one(self, i, p, w, g, lr):
        wd = self._decay_coeff()
        if wd:
            g = g + wd * w
        ms = self._get_state(i, "mean_square", w, lr)
        ms = self._rho * ms + (1 - self._rho) * g * g
        self._state[(i, "mean_square")] = ms
        if self._centered:
            mg = self._get_state(i, "mean_grad", w, lr)
            mg = self._rho * mg + (1 - self._rho) * g
            self._state[(i, "mean_grad")] = mg
            denom = torch.sqrt(ms - mg * mg + self._eps)
        else:
            denom = torch.sqrt(ms + self._eps)
        mom = self._get_state(i, "momentum", w, lr)
        mom = self._momentum * mom + lr * g / denom
        self._state[(i, "momentum")] = mom
        return w - mom


class Lamb(Optimizer):
    """The trust ratio is a `torch.where` on the device norms: no host
    read. The norms are square roots of f32 sums of squares, as
    `jnp.linalg.norm` computes them (`torch.linalg.vector_norm`'s CPU
    reduction drifts by 0.6% over 65 M f32 elements)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _slots(self):
        return ("moment1", "moment2")

    def _apply_one(self, i, p, w, g, lr):
        wd = self._decay_coeff()
        if self._exclude_fn is not None and self._exclude_fn(p):
            wd = 0.0
        m = self._get_state(i, "moment1", w, lr)
        v = self._get_state(i, "moment2", w, lr)
        t = self._step_count
        m = self._beta1 * m + (1 - self._beta1) * g
        v = self._beta2 * v + (1 - self._beta2) * g * g
        self._state[(i, "moment1")] = m
        self._state[(i, "moment2")] = v
        mhat = m / (1 - self._beta1 ** t)
        vhat = v / (1 - self._beta2 ** t)
        r = mhat / (torch.sqrt(vhat) + self._eps) + wd * w
        w32, r32 = w.float(), r.float()
        w_norm = torch.sqrt(torch.sum(w32 * w32))
        r_norm = torch.sqrt(torch.sum(r32 * r32))
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        return w - lr * trust.to(w.dtype) * r


class ASGD(Optimizer):
    """Keeps the last `batch_num` grads as a [batch_num, *shape] history
    (slot "ys") and their sum (slot "d")."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._batch_num = batch_num

    def _slots(self):
        return ("d", "ys")

    def _slot_init(self, name, w, lr):
        if name == "ys":
            return torch.zeros((self._batch_num,) + tuple(w.shape),
                               dtype=w.dtype, device=w.device)
        return torch.zeros_like(w)

    def _apply_one(self, i, p, w, g, lr):
        wd = self._decay_coeff()
        if wd:
            g = g + wd * w
        n = self._batch_num
        d = self._get_state(i, "d", w, lr)
        ys = self._get_state(i, "ys", w, lr)
        idx = (self._step_count - 1) % n
        d = d - ys[idx] + g
        ys = ys.clone()                  # rebound, never written in place
        ys[idx] = g
        self._state[(i, "d")] = d
        self._state[(i, "ys")] = ys
        return w - lr / min(self._step_count, n) * d


class Rprop(Optimizer):
    """Per-element step sizes (slot "lrs"), started at the learning rate
    and kept in `learning_rate_range`."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._lr_range = learning_rate_range
        self._etas = etas

    def _slots(self):
        return ("prev_grad", "lrs")

    def _slot_init(self, name, w, lr):
        if name == "lrs":
            return torch.full_like(w, lr)
        return torch.zeros_like(w)

    def _apply_one(self, i, p, w, g, lr):
        prev_g = self._get_state(i, "prev_grad", w, lr)
        lrs = self._get_state(i, "lrs", w, lr)
        sign = torch.sign(g * prev_g)
        lrs = torch.clamp(
            torch.where(sign > 0, lrs * self._etas[1],
                        torch.where(sign < 0, lrs * self._etas[0], lrs)),
            self._lr_range[0], self._lr_range[1])
        g_eff = torch.where(sign < 0, 0.0, g)
        self._state[(i, "prev_grad")] = g_eff
        self._state[(i, "lrs")] = lrs
        return w - lrs * torch.sign(g_eff)


class LBFGS(Optimizer):
    """Limited-memory BFGS (the reference's two-loop recursion, no line
    search). `step(closure)` calls the closure, which must clear the
    grads, compute the loss and its backward, and return the loss. Its
    stopping tests read the device on the host (`float(...)`), as the
    reference's do: the one optimizer that synchronizes."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._max_iter = max_iter
        self._tol_grad = tolerance_grad
        self._tol_change = tolerance_change
        self._history = history_size
        self._line_search = line_search_fn
        self._s: List = []
        self._y: List = []
        self._prev_flat_grad = None

    def _gather(self):
        ps = [p for p in self._parameter_list if p.requires_grad]
        flat_w = torch.cat([p.detach().reshape(-1) for p in ps])
        flat_g = torch.cat([
            (p.grad if p.grad is not None
             else torch.zeros_like(p)).reshape(-1) for p in ps])
        return ps, flat_w, flat_g

    @staticmethod
    def _scatter(ps, flat_w):
        off = 0
        for p in ps:
            n = p.numel()
            p.copy_(flat_w[off:off + n].view_as(p))
            off += n

    def step(self, closure):
        loss = closure()
        for _ in range(self._max_iter):
            ps, w, g = self._gather()
            if float(torch.max(torch.abs(g))) <= self._tol_grad:
                break
            # two-loop recursion
            q = g
            alphas = []
            for s, y in zip(reversed(self._s), reversed(self._y)):
                rho = 1.0 / (torch.dot(y, s) + 1e-10)
                a = rho * torch.dot(s, q)
                q = q - a * y
                alphas.append((a, rho))
            if self._y:
                gamma = (torch.dot(self._s[-1], self._y[-1])
                         / (torch.dot(self._y[-1], self._y[-1]) + 1e-10))
                q = q * gamma
            for (a, rho), s, y in zip(reversed(alphas), self._s, self._y):
                b = rho * torch.dot(y, q)
                q = q + (a - b) * s
            d = -q
            lr = self.get_lr()
            new_w = w + lr * d
            with torch.no_grad():
                self._scatter(ps, new_w)
            self.clear_grad(set_to_zero=False)
            loss = closure()
            _, w2, g2 = self._gather()
            s_vec = w2 - w
            y_vec = g2 - g
            if float(torch.dot(s_vec, y_vec)) > 1e-10:
                self._s.append(s_vec)
                self._y.append(y_vec)
                if len(self._s) > self._history:
                    self._s.pop(0)
                    self._y.pop(0)
            if float(torch.max(torch.abs(s_vec))) < self._tol_change:
                break
        return loss
