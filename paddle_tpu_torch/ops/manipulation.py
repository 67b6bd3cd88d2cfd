"""`pad` (counterpart of paddle_tpu/ops/manipulation.py:649-677), which
`nn.functional` exports as the reference does.

`pad` takes 2·ndim values (a (lo, hi) pair for every axis, first axis
first) or pairs that start from the last spatial axis (torch's order:
the first pair pads the last spatial axis, the next the one before it),
the spatial axes following `data_format` (channels last: NLC, NHWC,
NDHWC). Modes: "constant" (`value`; a negative pad crops, as
`F.pad` does), and "reflect", "replicate" / "edge" and "circular" /
"wrap", which are numpy's (and jnp.pad's) "reflect", "edge" and "wrap"
on any axis and any pad width: each padded axis is gathered through the
index map `np.pad(arange(n), (lo, hi), mode)`.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["pad"]

_NP_MODES = {"reflect": "reflect", "replicate": "edge", "edge": "edge",
             "circular": "wrap", "wrap": "wrap"}


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    if torch.is_tensor(pad):
        pad = pad.reshape(-1).tolist()
    pad = [int(p) for p in pad]
    nd = x.dim()
    if len(pad) == 2 * nd:
        cfg = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        pairs = [(pad[i], pad[i + 1]) for i in range(0, len(pad), 2)]
        cfg = [(0, 0)] * nd
        if data_format.endswith("C") and nd >= 3:
            spatial = list(range(1, nd - 1))
        else:
            spatial = list(range(2, nd))
        for d, pr in zip(reversed(spatial), pairs):
            cfg[d] = pr
    if mode == "constant":
        arg = []
        for lo, hi in reversed(cfg):
            arg += [lo, hi]
        return F.pad(x, arg, value=value)
    np_mode = _NP_MODES[mode]
    out = x
    for d, (lo, hi) in enumerate(cfg):
        if lo or hi:
            idx = np.pad(np.arange(x.shape[d]), (lo, hi), mode=np_mode)
            out = torch.index_select(out, d,
                                     torch.from_numpy(idx).to(x.device))
    return out
