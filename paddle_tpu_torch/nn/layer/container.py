"""Containers (counterpart of paddle_tpu/nn/layer/container.py:12-160):
`Sequential`, `LayerList`, `ParameterList` and `LayerDict` over `Layer`,
with the reference's keys ("0", "1", ... or the given names)."""
from __future__ import annotations

from collections import OrderedDict

from .layers import Layer

__all__ = ["Sequential", "LayerList", "ParameterList", "LayerDict"]


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], OrderedDict):
            for name, layer in layers[0].items():
                self.add_sublayer(name, layer)
        elif (len(layers) and isinstance(layers[0], (list, tuple))
              and not isinstance(layers[0], Layer)):
            for name, layer in layers:
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        if isinstance(idx, str):
            return self._modules[idx]
        return list(self._modules.values())[idx]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            for i, layer in enumerate(sublayers):
                self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._modules.values())[idx])
        return list(self._modules.values())[idx]

    def __setitem__(self, idx, layer):
        key = list(self._modules.keys())[idx]
        self._modules[key] = layer

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, layer):
        self.add_sublayer(str(len(self)), layer)
        return self

    def insert(self, index, layer):
        layers = list(self._modules.values())
        layers.insert(index, layer)
        self._modules.clear()
        for i, m in enumerate(layers):
            self._modules[str(i)] = m

    def extend(self, layers):
        for layer in layers:
            self.append(layer)
        return self


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            for i, p in enumerate(parameters):
                self.add_parameter(str(i), p)

    def __getitem__(self, idx):
        return list(self._parameters.values())[idx]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        self.add_parameter(str(len(self._parameters)), parameter)
        return self


class LayerDict(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._modules[key]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)

    def __contains__(self, key):
        return key in self._modules

    def clear(self):
        self._modules.clear()

    def pop(self, key):
        return self._modules.pop(key)

    def keys(self):
        return self._modules.keys()

    def items(self):
        return self._modules.items()

    def values(self):
        return self._modules.values()

    def update(self, sublayers):
        pairs = sublayers.items() if hasattr(sublayers, "items") else sublayers
        for k, v in pairs:
            self.add_sublayer(k, v)
        return self
