"""AMP (counterpart of paddle_tpu/amp/__init__.py): O2 `decorate` and
`GradScaler`.

`decorate(level="O2")` casts every floating parameter of the models to
the low dtype in place, except those of the port's `LayerNorm` and of
BatchNorm layers (the port's `nn.BatchNorm*` and torch's; the reference
skips its `LayerNorm` and `_BatchNormBase`), and gives each optimizer an f32
master copy of every parameter it updates (keyed by the parameter's
index in its list). So a LLaMA RMSNorm weight, f32 in a bf16 config,
becomes bf16 with an f32 master, as in the reference. O1 returns the
models untouched, as the reference's `decorate` does.

`GradScaler` keeps the reference's API, state and `state_dict`. Its
scale and its good / bad counters are device tensors, created on the
loss's device at the first `scale`; `unscale_` computes found-inf with
no host read, and `update` moves the scale with `torch.where`. `step`
primes the optimizer (the port's `prime` only creates missing
accumulators) and runs its step with the found-inf flag: a step with a
non-finite grad leaves every parameter, master weight and accumulator
bitwise as it was, written per parameter (`Optimizer._step`), where the
reference blends a snapshot of all of them; `@step` still advances, as
the reference's does.

O1 (`auto_cast` / `amp_guard`, the per-op cast policy `compute_dtype`
that the reference's tape consults) and `amp.debugging` are not ported
yet (ROADMAP Queue 1 item 13): they raise NotImplementedError.
"""
from __future__ import annotations

import torch

__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler",
           "is_bfloat16_supported", "is_float16_supported",
           "compute_dtype"]

_O1 = ("amp O1 (auto_cast, amp_guard and the per-op cast policy "
       "compute_dtype) is not ported yet (ROADMAP Queue 1 item 13); use "
       "decorate(level='O2') or a low-precision model config")

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def _dtype(d):
    return _DTYPES[d] if isinstance(d, str) else d


def is_bfloat16_supported(device=None):
    return True


def is_float16_supported(device=None):
    return True


def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    raise NotImplementedError(_O1)


amp_guard = auto_cast


def compute_dtype(op_name):
    raise NotImplementedError(_O1)


def _keeps_dtype(module, excluded):
    from ..nn.layer.norm import LayerNorm, _BatchNormBase
    return isinstance(module, (LayerNorm, _BatchNormBase,
                               torch.nn.modules.batchnorm._BatchNorm)) or (
        bool(excluded) and isinstance(module, excluded))


@torch.no_grad()
def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None, master_grad=False,
             excluded_layers=None):
    """O2: parameters cast to `dtype` in place, f32 masters kept in the
    optimizers. Returns the models (and optimizers) as passed."""
    d = _dtype(dtype)
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    opt_single = (optimizers is not None
                  and not isinstance(optimizers, (list, tuple)))
    opt_list = [optimizers] if opt_single else list(optimizers or [])

    if level == "O2":
        excluded = tuple(excluded_layers or ())
        keep_master = master_weight is None or master_weight
        index = [{id(p): i for i, p in enumerate(opt._parameter_list)}
                 for opt in opt_list]
        for m in model_list:
            for layer in m.modules():
                if _keeps_dtype(layer, excluded):
                    continue
                for p in layer._parameters.values():
                    if p is None or not p.is_floating_point():
                        continue
                    for opt, idx in zip(opt_list, index):
                        if keep_master and id(p) in idx:
                            opt._master_weights[idx[id(p)]] = p.data.float()
                    p.data = p.data.to(d)
    if optimizers is None:
        return models if single else model_list
    return (models if single else model_list,
            optimizers if opt_single else opt_list)


class GradScaler:
    """Dynamic loss scaling (the reference's grad_scaler semantics) with
    device state and no host read a step."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._incr_ratio = float(incr_ratio)
        self._decr_ratio = float(decr_ratio)
        self._incr_every = int(incr_every_n_steps)
        self._decr_every = int(decr_every_n_nan_or_inf)
        self._dynamic = use_dynamic_loss_scaling
        self._init = float(init_loss_scaling) if enable else 1.0
        self._state = None              # device tensors, made by _on
        self._unscaled = False

    def _on(self, device=None):
        """The state, created on first use (on `device`, else the CPU)
        and moved to `device` when one is named."""
        if self._state is None:
            device = "cpu" if device is None else device
            self._state = {
                "scale": torch.full((), self._init, dtype=torch.float32,
                                    device=device),
                "good": torch.zeros((), dtype=torch.int32, device=device),
                "bad": torch.zeros((), dtype=torch.int32, device=device),
                "found_inf": torch.zeros((), dtype=torch.bool,
                                         device=device)}
        elif (device is not None and
              self._state["scale"].device != torch.device(device)):
            self._state = {k: v.to(device) for k, v in self._state.items()}
        return self._state

    @property
    def _scale(self):
        return self._on()["scale"]

    @property
    def _found_inf(self):
        return self._on()["found_inf"]

    def scale(self, var):
        if not self._enable:
            return var
        s = self._on(var.device)["scale"]
        return var * s.to(var.dtype if var.is_floating_point()
                          else torch.float32)

    @torch.no_grad()
    def unscale_(self, optimizer):
        if not self._enable:
            return
        self._unscaled = True
        params = [p for p in optimizer._parameter_list if p.grad is not None]
        if not params:
            if self._state is not None:
                self._state["found_inf"] = torch.zeros_like(
                    self._state["found_inf"])
            return
        st = self._on(params[0].grad.device)
        inv = 1.0 / st["scale"]
        found = torch.zeros((), dtype=torch.bool, device=inv.device)
        for p in params:
            g = p.grad.float() * inv
            found = found | ~torch.all(torch.isfinite(g))
            p.grad = g.to(p.grad.dtype)
        st["found_inf"] = found

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if not self._unscaled:
            self.unscale_(optimizer)
        optimizer.prime()
        found = None if self._state is None else self._state["found_inf"]
        optimizer._step(found_inf=found)
        self._unscaled = False

    @torch.no_grad()
    def update(self):
        if not self._enable or self._state is None:
            return
        st = self._state
        if not self._dynamic:
            st["found_inf"] = torch.zeros_like(st["found_inf"])
            return
        found = st["found_inf"]
        zero = torch.zeros_like(st["bad"])
        bad = torch.where(found, st["bad"] + 1, zero)
        good = torch.where(found, zero, st["good"] + 1)
        shrink = bad >= self._decr_every
        grow = good >= self._incr_every
        scale = st["scale"]
        scale = torch.where(
            shrink, torch.clamp_min(scale * self._decr_ratio, 1.0), scale)
        scale = torch.where(grow, scale * self._incr_ratio, scale)
        st["scale"] = scale
        st["bad"] = torch.where(shrink, zero, bad)
        st["good"] = torch.where(grow, zero, good)
        st["found_inf"] = torch.zeros_like(found)

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return float(self._scale)

    def state_dict(self):
        st = self._on()
        return {"scale": float(st["scale"]),
                "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "good": int(st["good"]), "bad": int(st["bad"])}

    def load_state_dict(self, state):
        st = self._on()
        dev = st["scale"].device
        st["scale"] = torch.tensor(
            float(state.get("scale", self.get_init_loss_scaling())),
            dtype=torch.float32, device=dev)
        st["good"] = torch.tensor(int(state.get("good", 0)),
                                  dtype=torch.int32, device=dev)
        st["bad"] = torch.tensor(int(state.get("bad", 0)),
                                 dtype=torch.int32, device=dev)


from . import debugging  # noqa: E402,F401
