"""Weight conversion from the JAX package's state dict.

`state_from_jax` takes the reference model's `state_dict()` as numpy
arrays (the caller converts bf16 to float32 first: `torch.from_numpy`
cannot take `ml_dtypes` arrays) and returns tensors in this port's
layout — keys and `[in, out]` shapes are the reference's. For a LLaMA
config, fused or unfused checkpoints are translated to `cfg`'s layout,
norm weights stay f32 and every other tensor takes `dtype`; a BERT or
ERNIE config (`models.bert.BertConfig`, `models.ernie.ErnieConfig`)
keeps every tensor f32 under its own key, as the reference creates
them. `to_numpy` is the reverse view: a
model's parameters or their grads as float32 numpy arrays under the
reference's names.

`incubate_state_from_jax` takes the parameters of the reference's
`incubate.nn` fused layers (`FusedMultiHeadAttention`,
`FusedTransformerEncoderLayer`, ...), whose names and shapes the port's
layers keep, into a state dict for the port's layer.

`layer_state_from_jax(np_state, module)` carries any reference `Layer`'s
`state_dict()` (numpy) onto the port module of the same structure, key
by key (a `Linear` weight is [in, out] on both sides; BatchNorm's
running statistics are the buffers `_mean` and `_variance` on both): it
copies each array into the port's tensor in place, in that tensor's
dtype and on its device, and raises ValueError on a key either side
lacks or a shape that differs. It carries the ResNet family's and the
UNet's state too, BatchNorm's running statistics among it; their
state-dict keys come in the reference's order.

`optimizer_state_from_jax` carries a reference optimizer's state into
the port's: its accumulators, amp master weights, `@step` and its LR
scheduler's state (an inner scheduler of `LinearWarmup` too, which the
scheduler's own `state_dict` leaves out). Each reference parameter is
found by its name in the reference model's state dict and mapped to the
port parameter of that name, through the same layout translation as
`state_from_jax` (fused and unfused q/k/v and gate/up slots
concatenated or split on their last axis). It reads the reference's
objects by their attributes and imports nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from .bert import BertConfig
from .ernie import ErnieConfig
from .llama import LlamaConfig, _translate_fusion_keys, torch_dtype

__all__ = ["incubate_state_from_jax", "layer_state_from_jax",
           "optimizer_state_from_jax", "state_from_jax", "to_numpy"]


def to_numpy(model, grads=False):
    """{name: np.float32 array} of the model's parameters, or with
    grads=True of their grads (parameters without one are left out)."""
    out = {}
    for name, p in model.named_parameters():
        t = p.grad if grads else p
        if t is not None:
            out[name] = t.detach().float().cpu().numpy()
    return out


def state_from_jax(np_state, cfg, device, dtype=None):
    """np_state: {name: np.ndarray}; returns {name: torch.Tensor} on
    `device`, ready for the model's `load_state_dict`
    (`LlamaForCausalLM`, or a BERT or ERNIE model when cfg is a
    BertConfig or an ErnieConfig)."""
    raw = {k: torch.from_numpy(np.array(v, order="C"))    # owned copy
           for k, v in np_state.items()}
    if isinstance(cfg, (BertConfig, ErnieConfig)):
        want = torch.float32 if dtype is None else dtype
        return {k: v.to(device=device, dtype=want).contiguous()
                for k, v in raw.items()}
    dtype = torch_dtype(cfg.dtype) if dtype is None else dtype
    out = {}
    for k, v in _translate_fusion_keys(raw, cfg).items():
        want = torch.float32 if k.endswith("norm.weight") else dtype
        out[k] = v.to(device=device, dtype=want).contiguous()
    return out


def incubate_state_from_jax(np_state, module, dtype=None):
    """np_state: {name: np.ndarray} of a reference incubate layer;
    returns {name: torch.Tensor} on `module`'s device in its parameters'
    dtype (or `dtype`), ready for `module.load_state_dict`. A name or
    shape the port's layer does not have raises ValueError."""
    params = dict(module.named_parameters())
    if set(np_state) != set(params):
        raise ValueError(f"parameters differ: reference only "
                         f"{sorted(set(np_state) - set(params))}, port only "
                         f"{sorted(set(params) - set(np_state))}")
    out = {}
    for k, v in np_state.items():
        p = params[k]
        if tuple(np.shape(v)) != tuple(p.shape):
            raise ValueError(f"{k}: reference shape {np.shape(v)}, port "
                             f"{tuple(p.shape)}")
        t = torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
        out[k] = t.to(device=p.device, dtype=dtype or p.dtype)
    return out


def layer_state_from_jax(np_state, module):
    """Copy a reference layer's state dict {name: np.ndarray} into
    `module` (module docstring); returns the module."""
    own = module.state_dict(keep_vars=True)
    if set(np_state) != set(own):
        raise ValueError(f"state keys differ: reference only "
                         f"{sorted(set(np_state) - set(own))}, port only "
                         f"{sorted(set(own) - set(np_state))}")
    with torch.no_grad():
        for k, v in np_state.items():
            t = own[k]
            if tuple(np.shape(v)) != tuple(t.shape):
                raise ValueError(f"{k}: reference shape {np.shape(v)}, "
                                 f"port {tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.array(v, dtype=np.float32,
                                              order="C")).to(t.dtype))
    return module


def _scheduler_chain(sched):
    while sched is not None and hasattr(sched, "state_dict"):
        yield sched
        sched = getattr(sched, "lr_sched", None)


def optimizer_state_from_jax(jax_opt, jax_model, port_opt, port_model):
    """Replace `port_opt`'s state with `jax_opt`'s (see the module
    docstring). Both optimizers update the same model, `jax_model` in
    the reference and `port_model` in the port."""
    names = {id(t): k for k, t in jax_model.state_dict().items()}
    index = {id(p): i for i, p in enumerate(port_opt._parameter_list)}
    port_index = {k: index[id(p)] for k, p in port_model.named_parameters()
                  if id(p) in index}
    cfg = getattr(port_model, "cfg", None)

    def by_port_index(arrays):
        raw = {}
        for k, v in arrays.items():
            a = np.asarray(v)
            raw[k] = torch.from_numpy(np.array(a.astype(np.float32)))
        if isinstance(cfg, LlamaConfig):
            raw = _translate_fusion_keys(raw, cfg)
        return {port_index[k]: t for k, t in raw.items()}

    port_opt._master_weights = {
        i: t.to(port_opt._parameter_list[i].device)
        for i, t in by_port_index(
            {names[pid]: v for pid, v in jax_opt._master_weights.items()}
        ).items()}
    slots: dict = {}
    for (pid, slot), v in jax_opt._state.items():
        slots.setdefault(slot, {})[names[pid]] = v
    state = {}
    for slot, arrays in slots.items():
        for i, t in by_port_index(arrays).items():
            like = port_opt._target(i, port_opt._parameter_list[i])
            state[(i, slot)] = t.to(device=like.device, dtype=like.dtype)
    port_opt._state = state
    port_opt._step_count = int(jax_opt._step_count)
    for src, dst in zip(_scheduler_chain(getattr(jax_opt, "_lr", None)),
                        _scheduler_chain(getattr(port_opt, "_lr", None))):
        dst.set_state_dict(src.state_dict())
