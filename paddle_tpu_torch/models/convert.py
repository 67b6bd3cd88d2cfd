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
"""
from __future__ import annotations

import numpy as np
import torch

from .bert import BertConfig
from .ernie import ErnieConfig
from .llama import _translate_fusion_keys, torch_dtype

__all__ = ["state_from_jax", "to_numpy"]


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
