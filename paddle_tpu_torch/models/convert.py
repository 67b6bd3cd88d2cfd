"""Weight conversion from the JAX package's state dict.

`state_from_jax` takes the reference model's `state_dict()` as numpy
arrays (the caller converts bf16 to float32 first: `torch.from_numpy`
cannot take `ml_dtypes` arrays) and returns tensors in this port's
layout — keys and `[in, out]` shapes are the reference's, fused or
unfused checkpoints are translated to `cfg`'s layout, norm weights stay
f32 and every other tensor takes `dtype`.
"""
from __future__ import annotations

import numpy as np
import torch

from .llama import _translate_fusion_keys, torch_dtype

__all__ = ["state_from_jax"]


def state_from_jax(np_state, cfg, device, dtype=None):
    """np_state: {name: np.ndarray}; returns {name: torch.Tensor} on
    `device`, ready for `LlamaForCausalLM.load_state_dict`."""
    dtype = torch_dtype(cfg.dtype) if dtype is None else dtype
    raw = {k: torch.from_numpy(np.array(v, order="C"))    # owned copy
           for k, v in np_state.items()}
    out = {}
    for k, v in _translate_fusion_keys(raw, cfg).items():
        want = torch.float32 if k.endswith("norm.weight") else dtype
        out[k] = v.to(device=device, dtype=want).contiguous()
    return out
