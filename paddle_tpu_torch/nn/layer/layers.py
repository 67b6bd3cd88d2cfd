"""`Layer`, `ParamAttr` and `Parameter` (counterpart of
paddle_tpu/nn/layer/layers.py:38-381).

`Layer` is a `torch.nn.Module` with the reference's names on top:
`create_parameter(shape, attr, dtype, is_bias, default_initializer)`,
`add_parameter`, `add_sublayer`, `sublayers` / `named_sublayers`,
`state_dict` / `set_state_dict` (the reference's keys and order: every
parameter, then every persistable buffer), `register_forward_pre_hook`
/ `register_forward_post_hook` (torch's hooks, whose contract is the
reference's), `full_name` and `astype`. Parameters live where torch
keeps them, so `load_state_dict`, `to`, hooks and autograd are torch's.

A layer's parameters are made on its `device` (`cuda` unless the caller
names another: `framework.core.resolve_device`, resolved when the first
parameter is made, so a layer without parameters needs no card) and
drawn from its `generator` (None: torch's default generator of that
device, which `framework.core.seed` seeds). A subclass passes both to
`Layer.__init__`; the port's own layers take them as keywords.

`ParamAttr(name=, initializer=, learning_rate=, regularizer=,
trainable=, need_clip=)` becomes a `Parameter`: a `torch.nn.Parameter`
subclass carrying `name`, `trainable`, `optimize_attr`, `regularizer`
and `need_clip`, which the optimizers (`apply_decay_param_fun`,
per-parameter learning rate and regularizer, state keys) and the
gradient clips read. A plain torch parameter has none of these, and
reads as unnamed, clipped and trainable.
"""
from __future__ import annotations

import copy
from collections import OrderedDict

import numpy as np
import torch
from torch import nn

from ...framework.core import _DTYPES, convert_dtype, resolve_device
from .. import initializer as I

__all__ = ["Layer", "ParamAttr", "Parameter"]


class ParamAttr:
    """ref: python/paddle/base/param_attr.py."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        if attr is False:
            return False
        return ParamAttr()


_PARAM_ATTRS = ("name", "trainable", "optimize_attr", "regularizer",
                "need_clip")


class Parameter(nn.Parameter):
    """A parameter with the reference's attributes. `name` shadows the
    read-only `name` of a torch tensor; a deep copy keeps them all."""

    name = ""

    def __new__(cls, data=None, requires_grad=True, name="",
                trainable=True, optimize_attr=None, regularizer=None,
                need_clip=True):
        p = super().__new__(cls, data, requires_grad)
        p.name = name or ""
        p.trainable = trainable
        p.optimize_attr = (dict(optimize_attr) if optimize_attr
                           else {"learning_rate": 1.0})
        p.regularizer = regularizer
        p.need_clip = need_clip
        return p

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        out = type(self)(self.data.clone(memory_format=torch.preserve_format),
                         self.requires_grad)
        for a in _PARAM_ATTRS:
            setattr(out, a, copy.deepcopy(getattr(self, a), memo))
        memo[id(self)] = out
        return out

    def __repr__(self):
        return f"Parameter(name={self.name!r}): {super().__repr__()}"


class Layer(nn.Module):
    """The reference's `Layer` over `torch.nn.Module` (module
    docstring)."""

    def __init__(self, name_scope=None, dtype="float32", *, device=None,
                 generator=None):
        super().__init__()
        self._dtype = convert_dtype(dtype)
        self._name_scope = name_scope or type(self).__name__.lower()
        self._device_arg = device
        self._generator = generator

    # -- parameters ------------------------------------------------------
    def _param_device(self):
        return resolve_device(self._device_arg)

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """A new `Parameter` of `shape` on the layer's device, drawn by
        `default_initializer`, else the attr's initializer, else
        Constant(0) for a bias and XavierUniform otherwise. attr False
        makes none (returns None)."""
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        init = default_initializer or attr.initializer
        if init is None:
            init = I.Constant(0.0) if is_bias else I.XavierUniform()
        data = init(tuple(int(s) for s in shape),
                    convert_dtype(dtype, self._dtype),
                    device=self._param_device(), generator=self._generator)
        return Parameter(data, requires_grad=bool(attr.trainable),
                         name=attr.name or "", trainable=attr.trainable,
                         optimize_attr={"learning_rate": attr.learning_rate},
                         regularizer=attr.regularizer,
                         need_clip=attr.need_clip)

    def add_parameter(self, name, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True, *,
                        persistent=None):
        super().register_buffer(
            name, tensor, persistable if persistent is None else persistent)
        return tensor

    def named_parameters(self, prefix="", include_sublayers=True,
                         remove_duplicate=True, recurse=None):
        return super().named_parameters(
            prefix, include_sublayers if recurse is None else recurse,
            remove_duplicate)

    def named_sublayers(self, prefix="", include_self=False,
                        layers_set=None):
        for name, layer in self.named_modules(memo=layers_set,
                                              prefix=prefix):
            if layer is self and not include_self:
                continue
            yield name, layer

    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def full_name(self):
        return self._name_scope

    # -- dtype ----------------------------------------------------------
    def to(self, *args, **kwargs):
        kwargs.pop("blocking", None)
        if "dtype" in kwargs and not isinstance(kwargs["dtype"], torch.dtype):
            kwargs["dtype"] = convert_dtype(kwargs["dtype"])
        args = tuple(convert_dtype(a) if isinstance(a, str) and a in _DTYPES
                     else a for a in args)
        return super().to(*args, **kwargs)

    def astype(self, dtype):
        return self.to(dtype=dtype)

    # -- state dict -----------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, *args,
                   prefix=None, keep_vars=False):
        """The reference's state dict: every parameter, then every
        persistable buffer, under dotted names (`structured_name_prefix`
        before each). torch's own recursion (a `prefix=` call from an
        enclosing module) gets torch's state dict."""
        if prefix is not None or args:
            return super().state_dict(*args, destination=destination,
                                      prefix=prefix or "",
                                      keep_vars=keep_vars)
        dest = OrderedDict() if destination is None else destination
        pre = structured_name_prefix
        if pre and not pre.endswith("."):
            pre += "."

        def put(name, t):
            dest[pre + name] = t if keep_vars else t.detach()

        if not include_sublayers:
            for name, p in self._parameters.items():
                if p is not None:
                    put(name, p)
            for name, b in self._buffers.items():
                if b is not None and name not in \
                        self._non_persistent_buffers_set:
                    put(name, b)
            return dest
        for name, p in self.named_parameters():
            put(name, p)
        seen = set()
        for mname, m in self.named_modules():
            for bname, b in m._buffers.items():
                if (b is None or id(b) in seen
                        or bname in m._non_persistent_buffers_set):
                    continue
                seen.add(id(b))
                put(f"{mname}.{bname}" if mname else bname, b)
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy each entry of `state_dict` (tensors or numpy arrays) into
        the tensor of the same name, reshaped and cast to it. Returns
        (missing, unexpected) names, as the reference does."""
        own = self.state_dict(keep_vars=True)
        missing = [k for k in own if k not in state_dict]
        unexpected = [k for k in state_dict if k not in own]
        with torch.no_grad():
            for name, t in own.items():
                if name not in state_dict:
                    continue
                v = state_dict[name]
                if not torch.is_tensor(v):
                    v = torch.from_numpy(np.array(v, order="C"))
                t.copy_(v.detach().reshape(t.shape).to(t.dtype))
        return missing, unexpected

    load_dict = set_state_dict
    set_dict = set_state_dict

    # -- hooks ----------------------------------------------------------
    def register_forward_post_hook(self, hook):
        """hook(layer, inputs, outputs) -> new outputs or None."""
        return self.register_forward_hook(hook)
